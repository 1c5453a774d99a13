// hash_lookup.cu — batched probe of the int64 → int32 open-addressing map.
//
// Replaces: zeebe_tpu/tpu/pallas_ops.py `lookup` (its pl.pallas_call at
// :1028), whose XLA form is zeebe_tpu/tpu/hashmap.py `lookup`. The step
// kernel uses it as the fallback for direct-mapped index misses.
//
// What it computes: for each valid key, linear probing from h0 over at
// most MAX_PROBES = 32 buckets, (h0 + j) & (T - 1); a bucket holding the
// key is a hit (found, its value); an EMPTY bucket (-1) ends the chain; a
// TOMBSTONE (-2) is stepped over. An invalid key, a miss or an exhausted
// chain returns (false, -1). h0 is bit-identical to hashmap._hash — a
// multiplicative hash over the key's two 32-bit halves in uint32
// arithmetic — because tables cross engines in snapshots.
//
// What bounds it on this card: the latency of dependent random 8-byte
// reads, one chain per key; the bytes are tiny (keys in, two words out,
// 1-3 buckets per valid key at the load the engine keeps). On the step
// kernel's path almost every key is invalid (no index miss), so most
// threads only read their flag and write the (false, -1) answer.
//
// Design: one thread per key, comparing the int64 key directly (no lo/hi
// planes: Hopper loads 8 bytes natively). Keys may come strided (a column
// of a wider table) and are read through their stride.

#include <cuda_runtime.h>
#include <stdint.h>

#include "zb_hash.cuh"

__global__ void hash_lookup_kernel(const int64_t* __restrict__ tkeys,
                                   const int32_t* __restrict__ tvals,
                                   int64_t tsize, const int64_t* keys,
                                   int64_t key_stride,
                                   const uint8_t* __restrict__ valid,
                                   int64_t n, uint8_t* __restrict__ found,
                                   int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint8_t f = 0;
  int32_t v = -1;
  if (valid[i]) {
    const int64_t key = keys[i * key_stride];
    const uint32_t mask = (uint32_t)(tsize - 1);
    const uint32_t h0 = zb_hash(key, mask);
    for (int j = 0; j < ZB_MAX_PROBES; ++j) {
      const uint32_t idx = (h0 + (uint32_t)j) & mask;
      const int64_t k = tkeys[idx];
      if (k == key) {  // checked before EMPTY, as the XLA loop does
        f = 1;
        v = tvals[idx];
        break;
      }
      if (k == ZB_EMPTY) break;
    }
  }
  found[i] = f;
  out[i] = v;
}

// Launches the probe for ``n`` keys on ``stream``; ``tsize`` must be a
// power of two. Returns cudaGetLastError() after the launch.
extern "C" int zb_hash_lookup(const int64_t* tkeys, const int32_t* tvals,
                              int64_t tsize, const int64_t* keys,
                              int64_t key_stride, const uint8_t* valid,
                              int64_t n, uint8_t* found, int32_t* out,
                              void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (tsize <= 0 || (tsize & (tsize - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  hash_lookup_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      tkeys, tvals, tsize, keys, key_stride, valid, n, found, out);
  return (int)cudaGetLastError();
}
