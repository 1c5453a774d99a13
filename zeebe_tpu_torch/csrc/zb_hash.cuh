// zb_hash.cuh — the bucket hash and sentinels of the int64 → int32
// open-addressing map, shared by hash_lookup.cu and hash_update.cu, and the
// warp-cooperative window walk that hash_update.cu's delete and probe.cu's
// probe run.
//
// h0 is bit-identical to hashmap._hash (both packages): a multiplicative
// hash over the key's two 32-bit halves in uint32 arithmetic, because
// tables cross engines in snapshots. _build.py keys every library on the
// bytes of this header too, so an edit here rebuilds every user.

#pragma once

#include <stdint.h>

#define ZB_MAX_PROBES 32
#define ZB_EMPTY (-1LL)
#define ZB_TOMBSTONE (-2LL)
#define ZB_FULL_WARP 0xFFFFFFFFu

__device__ __forceinline__ uint32_t zb_hash(int64_t key, uint32_t mask) {
  const uint32_t lo = (uint32_t)(uint64_t)key;
  const uint32_t hi = (uint32_t)((uint64_t)key >> 32);
  uint32_t h = (lo * 0x9E3779B1u) ^ (hi * 0x85EBCA77u);
  h ^= h >> 15;
  return h & mask;
}

// The linear-probe walk of up to 32 keys by one warp, G lanes a key.
//
// What it computes, per key: the first j in [0, P) at which bucket
// (home(key) + j) & mask holds the key or is EMPTY (-1), the key compared
// first; the answer is that bucket where it holds the key, else -1 (an
// EMPTY bucket first, or P buckets without either).
//
// Lane q holds key `my_key`, to be walked where bit q of `todo` is set
// (`todo` is the same in every lane; every lane of the warp calls this
// together). Group g = lane / G of the 32 / G groups takes the keys of
// lanes g, g + 32/G, g + 2·32/G, ... (G keys) and walks them side by
// side, a window of G consecutive buckets at a time: lane l of the group
// reads bucket (home(key) + v·G + l) & mask of window v, so a window that
// wraps past T - 1 is read through the mask. Two dependent steps: window
// 0 of every key, then every remaining window of the keys still walking
// (at G = 8 and P = 32: 8 buckets, then 24), each lane's reads of a step
// in flight together. One ballot over the group per key and window, on
// `k == key || k == EMPTY`, gives the answer as its lowest set bit; the
// lane that read it calls done(q, bucket or -1) once for the key, and the
// group's lowest lane calls done(q, -1) for a key whose P buckets hold
// neither. Keys no group holds cost no shuffle, read or ballot.
//
// Buckets are read past L1 (__ldcg): done may write the table (the
// delete's tombstones) while other warps walk it.
template <int G, int P, typename K, typename Home, typename Done>
__device__ __forceinline__ void zb_window_walk(const K* table, uint32_t mask, uint32_t todo,
                                               K my_key, Home home, Done done) {
  static_assert(G == 2 || G == 4 || G == 8 || G == 16 || G == 32, "G: a power of two <= 32");
  constexpr int W = 32 / G;               // groups in the warp
  constexpr int NW = (P + G - 1) / G;     // windows of a key's P buckets
  constexpr uint32_t GROUP = G == 32 ? ZB_FULL_WARP : (1u << G) - 1u;
  const int lane = (int)(threadIdx.x & 31u);
  const int g = lane / G;
  const int l = lane % G;
  // bit u: some group holds a key u (the same in every lane)
  uint32_t slots = 0;
#pragma unroll
  for (int u = 0; u < G; ++u) {
    slots |= (uint32_t)(((todo >> (u * W)) & ((1u << W) - 1u)) != 0u) << u;
  }
  K key[G];
  uint32_t h[G];
  uint32_t walking = 0;  // bit u: this group's key u still walks (equal in its lanes)
#pragma unroll
  for (int u = 0; u < G; ++u) {
    key[u] = 0;
    h[u] = 0;
    if ((slots >> u) & 1u) {
      const int q = u * W + g;
      key[u] = __shfl_sync(ZB_FULL_WARP, my_key, q);
      h[u] = home(key[u]);
      walking |= ((todo >> q) & 1u) << u;
    }
  }
  // key u's window v, lane l's bucket read into k: settle the key where the
  // window holds its answer, or where it was the last. No branch but the
  // writer's: the per-key tail after the ballot is the walk's main cost
  // on short chains
  auto window = [&](int u, int v, K k) {
    const int j = v * G + l;
    const bool walks = (walking >> u) & 1u;
    const bool on = walks && j < P;
    const bool hit = on && k == key[u];
    const uint32_t stop =
        (__ballot_sync(ZB_FULL_WARP, hit || (on && k == (K)-1)) >> (g * G)) & GROUP;
    const bool settle = walks && (stop != 0u || v == NW - 1);
    if (settle && l == (stop != 0u ? __ffs(stop) - 1 : 0)) {
      done(u * W + g, stop != 0u && hit ? (int64_t)((h[u] + (uint32_t)j) & mask) : (int64_t)-1);
    }
    walking &= ~((uint32_t)settle << u);
  };
  {
    K got[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      got[u] = ((walking >> u) & 1u) && l < P ? __ldcg(table + ((h[u] + (uint32_t)l) & mask))
                                              : (K)0;
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if ((slots >> u) & 1u) window(u, 0, got[u]);
    }
  }
  if constexpr (NW > 1) {
    const uint32_t live = __reduce_or_sync(ZB_FULL_WARP, walking);
    if (live == 0u) return;
    K got[G][NW - 1];
#pragma unroll
    for (int u = 0; u < G; ++u) {
#pragma unroll
      for (int v = 1; v < NW; ++v) {
        const int j = v * G + l;
        got[u][v - 1] = ((walking >> u) & 1u) && j < P
                            ? __ldcg(table + ((h[u] + (uint32_t)j) & mask)) : (K)0;
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if (!((live >> u) & 1u)) continue;
#pragma unroll
      for (int v = 1; v < NW; ++v) window(u, v, got[u][v - 1]);
    }
  }
}
