// probe.cu — the two primitives of the primitive-cost probe.
//
// Replaces, in benchmarks/pallas_probe.py: `pallas_row_loop` (:62, its
// pl.pallas_call at :63, over `_row_loop_kernel` :48) and `pallas_probe`
// (:116, its pl.pallas_call at :117, over `_probe_kernel` :84). The step
// kernel's design rests on these two: a serial dynamic row write, and a
// scalar hash probe. zeebe_tpu_torch/probe.py times them.
//
// row_loop(tbl[CAP, K] i32, idx[B] i32, rows[B, K] i32, n_writes):
//   what the serial loop computes — record i = 0..B-1 writes rows[i] + w
//   into tbl[idx[i]] for w = 0..n_writes-1 — so per row the LAST record in
//   batch order wins with rows[last] + n_writes - 1, and rows no record
//   names keep the table's values (the table is updated in place, as the
//   Pallas call aliases it). An index outside [0, CAP) writes nothing.
//   Bound on this card: bytes (the index and the winners' rows in, the
//   written rows out); n_writes repeats the stores, not the bytes.
//   Design: the TPU ran one serial loop; here the records run in
//   parallel, so two records naming one row would race and leave a row
//   mixed from both. As in table_commit.cu, the winner is decided first:
//   pass 1 takes an atomicMax of a 64-bit tag (epoch << 32 | rank + 1)
//   per destination row in a scratch word, pass 2 lets only the record
//   whose tag survived write its row, n_writes times (volatile stores, so
//   the repeats are issued as the serial loop issues them). The epoch
//   grows with every call, so the scratch is never cleared.
//
// probe(keys[B] i32, tkeys[CAP] i32) -> slot[B] i32:
//   h = (k * 0x9E3779B1) & (CAP - 1) in 32-bit arithmetic; at most 8
//   linear probes (h + j) & (CAP - 1); the slot is the index of the first
//   bucket holding k, or -1; an EMPTY bucket (-1) ends the chain.
//   Bound on this card: the latency of up to 8 dependent 4-byte reads per
//   key; the bytes are tiny. The TPU kernel read a [CAP/128, 128] table
//   row by row and picked the lane with a masked reduce (a TPU layout
//   constraint). Design: the window walk of zb_hash.cuh (zb_window_walk,
//   as the map's delete runs it), ZB_PROBE_GROUP = 8 lanes a key: the 8
//   lanes read the key's whole 8-bucket window, 32 B, in one step, a
//   ballot finds its first bucket holding the key or EMPTY, and the lane
//   that read it writes the slot (the group's lowest lane writes -1 for a
//   window that holds neither). A warp takes 32 keys, 4 groups of 8 keys
//   each, and each lane has its 8 reads in flight at once, so a key costs
//   one dependent read instead of up to 8.

#include <cuda_runtime.h>
#include <stdint.h>

#include "zb_hash.cuh"

// the probe's linear probes, and the lanes that read one key's window
#define ZB_PROBE_LEN 8
#define ZB_PROBE_GROUP 8

__global__ void row_claim_kernel(const int32_t* __restrict__ idx, int64_t b,
                                 int64_t cap, unsigned long long epoch,
                                 unsigned long long* claims) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const int32_t t = idx[i];
  if (t < 0 || t >= cap) return;
  atomicMax(claims + t, (epoch << 32) | (unsigned long long)(i + 1));
}

// one thread per (record, lane); the lanes of a record are neighbours, so
// a winner's row is read and written in whole coalesced lines
__global__ void row_write_kernel(int32_t* tbl, const int32_t* __restrict__ idx,
                                 const int32_t* __restrict__ rows, int64_t b,
                                 int64_t cap, int64_t k, int n_writes,
                                 unsigned long long epoch,
                                 const unsigned long long* __restrict__ claims) {
  const int64_t u = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= b * k) return;
  const int64_t i = u / k;
  const int64_t lane = u - i * k;
  const int32_t t = idx[i];
  if (t < 0 || t >= cap) return;
  if (claims[t] != ((epoch << 32) | (unsigned long long)(i + 1))) return;
  const int32_t v = rows[u];
  volatile int32_t* dst = tbl + (int64_t)t * k + lane;
  for (int w = 0; w < n_writes; ++w) *dst = v + w;
}

__global__ void probe_kernel(const int32_t* __restrict__ keys,
                             const int32_t* __restrict__ tkeys, int64_t b,
                             uint32_t mask, int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool v = i < b;
  const uint32_t todo = __ballot_sync(ZB_FULL_WARP, v);
  if (todo == 0u) return;  // the whole warp lies past the keys
  const int32_t key = v ? keys[i] : 0;
  int32_t* const warp_out = out + (i - (int64_t)(threadIdx.x & 31u));
  zb_window_walk<ZB_PROBE_GROUP, ZB_PROBE_LEN>(
      tkeys, mask, todo, key, [mask](int32_t k) { return ((uint32_t)k * 0x9E3779B1u) & mask; },
      [warp_out](int q, int64_t slot) { warp_out[q] = (int32_t)slot; });
}

static inline unsigned blocks_for(int64_t units, int threads) {
  return (unsigned)((units + threads - 1) / threads);
}

// Enqueues both passes of the row loop on ``stream``. ``claims`` is a
// zero-initialised scratch of at least ``cap`` words kept across calls;
// ``epoch`` is unique per call and below 2^32. Returns cudaGetLastError().
extern "C" int zb_row_loop(int32_t* tbl, const int32_t* idx, const int32_t* rows,
                           int64_t b, int64_t cap, int64_t k, int n_writes,
                           unsigned long long* claims, unsigned long long epoch,
                           void* stream) {
  if (b <= 0 || k <= 0 || n_writes <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  cudaStream_t st = (cudaStream_t)stream;
  row_claim_kernel<<<blocks_for(b, threads), threads, 0, st>>>(idx, b, cap, epoch, claims);
  int err = (int)cudaGetLastError();
  if (err) return err;
  row_write_kernel<<<blocks_for(b * k, threads), threads, 0, st>>>(
      tbl, idx, rows, b, cap, k, n_writes, epoch, claims);
  return (int)cudaGetLastError();
}

// Launches the probe of ``b`` keys into a table of ``cap`` buckets (a power
// of two) on ``stream``. Returns cudaGetLastError().
extern "C" int zb_probe(const int32_t* keys, const int32_t* tkeys, int64_t b,
                        int64_t cap, int32_t* out, void* stream) {
  if (b <= 0) return (int)cudaGetLastError();
  if (cap <= 0 || (cap & (cap - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;  // whole warps: the walk takes 32 keys at once
  probe_kernel<<<blocks_for(b, threads), threads, 0, (cudaStream_t)stream>>>(
      keys, tkeys, b, (uint32_t)(cap - 1), out);
  return (int)cudaGetLastError();
}
