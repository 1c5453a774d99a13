// zb_hash.cuh — the bucket hash and sentinels of the int64 → int32
// open-addressing map, shared by hash_lookup.cu and hash_update.cu.
//
// h0 is bit-identical to hashmap._hash (both packages): a multiplicative
// hash over the key's two 32-bit halves in uint32 arithmetic, because
// tables cross engines in snapshots. _build.py keys every library on the
// bytes of this header too, so an edit here rebuilds both users.

#pragma once

#include <stdint.h>

#define ZB_MAX_PROBES 32
#define ZB_EMPTY (-1LL)
#define ZB_TOMBSTONE (-2LL)

__device__ __forceinline__ uint32_t zb_hash(int64_t key, uint32_t mask) {
  const uint32_t lo = (uint32_t)(uint64_t)key;
  const uint32_t hi = (uint32_t)((uint64_t)key >> 32);
  uint32_t h = (lo * 0x9E3779B1u) ^ (hi * 0x85EBCA77u);
  h ^= h >> 15;
  return h & mask;
}
