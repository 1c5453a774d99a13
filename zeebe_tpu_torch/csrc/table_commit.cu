// table_commit.cu — one table group's ordered write tail, in place.
//
// Replaces, in zeebe_tpu/tpu/pallas_ops.py: `fused_table_commit` (its
// pl.pallas_call at :679), and, as a commit of one op, the single-table
// scatters `masked_row_update` (:244), `masked_row_max` (:317),
// `masked_row_add` (:378), `_lane_op` (:441, behind `masked_lane_update`
// and `masked_lane_accum`) and `masked_vec64_update` (:497, through lo/hi
// planes). The semantics are those of the XLA op chain `_apply_op_unfused`
// (pallas_ops.py:553-564), applied in list order:
//   set  — masked row write; per row (or per (row, lane) when a lane mask
//          is given) the LAST active writer in batch order wins;
//   add  — accumulate (int32, commutes);
//   max  — row-wise maximum merge (commutes).
// A slot wraps once when negative and is dropped when it is still out of
// [0, T) — the `mode="drop"` scatter the step kernel relies on to park
// inactive records on the sentinel slot T.
//
// The tables are updated IN PLACE: the caller's tensors are the result.
// int64 tables enter as zero-copy int32 planes (`t.view(torch.int32)` of
// a contiguous [N, C] int64 is [N, 2C], little-endian lo/hi), so this
// kernel handles int32 only and a plane-wise lane mask keeps its meaning.
//
// What bounds it on this card: bytes — each active record reads its
// slot, flag, values and mask and writes its lanes; the winners of a
// `set` are decided with one atomic per (record, lane), which at these
// batch sizes costs less than the bytes. No arithmetic to speak of.
//
// Design: the TPU kernel ran one serial loop over the batch; on Hopper the
// records run in parallel and "last writer wins" is made explicit. A
// `set` takes two passes over its records. Pass 1 does an atomicMax of a
// 64-bit tag (op epoch << 32 | batch rank + 1) into a scratch word per
// destination cell; pass 2 lets only the record whose tag survived write.
// The epoch grows with every `set`, so a stale tag left in the scratch by
// an earlier op always loses and the scratch never needs clearing. `add`
// and `max` are single passes of atomicAdd / atomicMax. All passes of all
// ops are enqueued in list order on one stream, so op-major order holds
// by construction.

#include <cuda_runtime.h>
#include <stdint.h>

enum { ZB_SET = 0, ZB_ADD = 1, ZB_MAX = 2 };

struct CommitDesc {
  int32_t* table;         // [rows, width] int32, row-major, updated in place
  const int32_t* slots;   // [n]
  const uint8_t* active;  // [n] bool
  const int32_t* vals;    // [n, width]
  const uint8_t* mask;    // [n, width] bool, or null: every lane
  int64_t rows;
  int64_t width;          // 1 for 1D tables
  int64_t n;
  int64_t kind;           // ZB_SET / ZB_ADD / ZB_MAX
  uint64_t epoch;         // set only: unique and increasing per op, < 2^32
};

__device__ __forceinline__ int64_t drop_slot(int32_t s, int64_t rows) {
  int64_t v = s;
  if (v < 0) v += rows;  // one wrap, as XLA normalizes a negative index
  return (v >= 0 && v < rows) ? v : -1;
}

// Each thread owns one (record, lane) pair. For an unmasked set the claim
// is per row, so lane 0 claims and every lane of the winner writes.
__global__ void set_claim_kernel(CommitDesc d, unsigned long long* claims) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool masked = d.mask != nullptr;
  const int64_t units = masked ? d.n * d.width : d.n;
  if (i >= units) return;
  const int64_t r = masked ? i / d.width : i;
  const int64_t l = masked ? i - r * d.width : 0;
  if (!d.active[r]) return;
  if (masked && !d.mask[i]) return;
  const int64_t s = drop_slot(d.slots[r], d.rows);
  if (s < 0) return;
  const int64_t cell = masked ? s * d.width + l : s;
  const unsigned long long tag = (d.epoch << 32) | (unsigned long long)(r + 1);
  atomicMax(claims + cell, tag);
}

__global__ void set_write_kernel(CommitDesc d, const unsigned long long* claims) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= d.n * d.width) return;
  const int64_t r = i / d.width;
  const int64_t l = i - r * d.width;
  if (!d.active[r]) return;
  const bool masked = d.mask != nullptr;
  if (masked && !d.mask[i]) return;
  const int64_t s = drop_slot(d.slots[r], d.rows);
  if (s < 0) return;
  const int64_t cell = masked ? s * d.width + l : s;
  const unsigned long long tag = (d.epoch << 32) | (unsigned long long)(r + 1);
  if (claims[cell] == tag) d.table[s * d.width + l] = d.vals[i];
}

__global__ void accumulate_kernel(CommitDesc d) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= d.n * d.width) return;
  const int64_t r = i / d.width;
  const int64_t l = i - r * d.width;
  if (!d.active[r]) return;
  if (d.mask != nullptr && !d.mask[i]) return;
  const int64_t s = drop_slot(d.slots[r], d.rows);
  if (s < 0) return;
  int32_t* dst = d.table + s * d.width + l;
  if (d.kind == ZB_ADD) {
    atomicAdd(dst, d.vals[i]);
  } else {
    atomicMax(dst, d.vals[i]);
  }
}

static inline unsigned blocks_for(int64_t units, int threads) {
  return (unsigned)((units + threads - 1) / threads);
}

// Enqueues every op of the list on ``stream``, in order. ``claims`` is a
// zero-initialised scratch of at least max(rows * width) words that the
// caller keeps across calls (see the epoch note above). Returns the first
// nonzero cudaGetLastError() (0 = every launch was accepted).
extern "C" int zb_table_commit(const CommitDesc* ops, int n_ops,
                               unsigned long long* claims, void* stream) {
  const int threads = 256;
  cudaStream_t st = (cudaStream_t)stream;
  for (int k = 0; k < n_ops; ++k) {
    const CommitDesc d = ops[k];
    if (d.n <= 0) continue;
    const int64_t lanes = d.n * d.width;
    if (d.kind == ZB_SET) {
      const int64_t claim_units = d.mask != nullptr ? lanes : d.n;
      set_claim_kernel<<<blocks_for(claim_units, threads), threads, 0, st>>>(d, claims);
      int err = (int)cudaGetLastError();
      if (err) return err;
      set_write_kernel<<<blocks_for(lanes, threads), threads, 0, st>>>(d, claims);
    } else if (d.kind == ZB_ADD || d.kind == ZB_MAX) {
      accumulate_kernel<<<blocks_for(lanes, threads), threads, 0, st>>>(d);
    } else {
      return (int)cudaErrorInvalidValue;
    }
    int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return (int)cudaGetLastError();
}
