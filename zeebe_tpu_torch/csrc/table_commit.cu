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
// slot, flag, values and mask and writes its lanes — and one 64-bit
// atomic per claimed cell of a `set`. At the step's sizes (a few ops of
// 2^14 records into 2^16-row tables, all inside the 50 MB L2) both are a
// few microseconds; the cost to beat was launches: the old design took two
// launches per `set` (claim, then write), 23 for the element-instance
// commit alone.
//
// Design: a launch plan per commit, not per op. The wrapper (tpu/ops.py
// `commit_plan`) splits the op list into stages: a stage ends where an op
// would apply a kind other than the one its table already took in the
// stage (a 1D table's `max` counts as a `set`). Inside a stage, per table,
// every op is of one kind, so the ops of different tables are independent
// and those of one table either commute (add, max) or are all `set`s. A
// stage is at most two launches, each covering every op of the pass in
// one flat grid (each op its own block range, found by a scan of the
// starts in the parameter block; the descriptors travel by value, so no
// host-to-device copy):
//   pass 0 — each `set` claims: an atomicMax of the tag (op epoch << 32 |
//            batch rank + 1) into its table's claim region; `add` and
//            `max` apply here (atomicAdd / atomicMax), their tables
//            untouched by any `set` of the stage;
//   pass 1 — only for stages with a `set`: a record writes a cell only
//            where its tag is the cell's largest claim.
// The epoch grows with every `set` in list order, so the later op, then
// the later record, wins across the whole stage, and a tag left in the
// scratch by an earlier stage or call always loses: the scratch is never
// cleared (the wrapper zeroes it when the 32-bit epoch space wraps).
// Claim granularity: an unmasked `set` claims its row, a lane-masked one
// each (row, lane) it writes. Each table has its own row region and its
// own lane region in the scratch, so claims of two tables, or a row
// claim and a lane claim, never share a word; a writer compares its tag
// with the larger of its row's claim and its cell's claim. The main
// path's commits are 3 launches (element instances: the token `add`, then
// 11 `set`s), 2 (jobs) and 2 (timers).

#include <cuda_runtime.h>
#include <stdint.h>

enum { ZB_SET = 0, ZB_ADD = 1, ZB_MAX = 2 };

#define ZB_MAX_COMMIT_OPS 32
#define ZB_COMMIT_THREADS 256

struct CommitDesc {
  int32_t* table;                   // [rows, width] int32, row-major, updated in place
  const int32_t* slots;             // [n]
  const uint8_t* active;            // [n] bool
  const int32_t* vals;              // [n, width]
  const uint8_t* mask;              // [n, width] bool, or null: every lane
  unsigned long long* row_claims;   // set: the table's [rows] row region, or null
  unsigned long long* lane_claims;  // set: the table's [rows * width] lane region, or null
  int32_t rows;
  int32_t width;                    // 1 for 1D tables
  int32_t n;
  int32_t kind;                     // ZB_SET / ZB_ADD / ZB_MAX
  uint32_t epoch;                   // set only: unique and increasing per op
  int32_t stage;                    // nondecreasing in list order
};

// A pass's parameter block: up to N descriptors by value. A pass takes
// the smallest of N = 1, 16 and 32 that holds its ops, so a one-op pass
// (the masked scatters) copies a 96-byte block at launch, not 2.7 KB.
template <int N>
struct PassArgs {
  CommitDesc d[N];
  int32_t start[N + 1];  // first block of each op; [n_ops] = grid
  int32_t n_ops;
  int32_t write;         // 0: claims, add, max; 1: the sets' writes
};

__device__ __forceinline__ int drop_slot(int32_t s, int32_t rows) {
  if (s < 0) s += rows;  // one wrap, as XLA normalizes a negative index
  return (s >= 0 && s < rows) ? s : -1;
}

// A row claim (an unmasked set in pass 0) is one thread a record; every
// other unit is one thread a (record, lane), the lanes of a record
// neighbours, so values and rows move in whole lines.
__host__ __device__ __forceinline__ bool row_claim(const CommitDesc& d, int write) {
  return d.kind == ZB_SET && !write && d.mask == nullptr;
}

template <int N>
__global__ void __launch_bounds__(ZB_COMMIT_THREADS)
commit_pass_kernel(const __grid_constant__ PassArgs<N> a) {
  const int b = (int)blockIdx.x;
  int k = 0;
  while (k + 1 < a.n_ops && b >= a.start[k + 1]) ++k;
  const CommitDesc& d = a.d[k];
  const int i = (b - a.start[k]) * ZB_COMMIT_THREADS + (int)threadIdx.x;
  const bool per_row = row_claim(d, a.write);
  if (i >= (per_row ? d.n : d.n * d.width)) return;
  const int r = per_row ? i : i / d.width;
  if (!d.active[r]) return;
  if (!per_row && d.mask != nullptr && !d.mask[i]) return;
  const int s = drop_slot(__ldg(d.slots + r), d.rows);
  if (s < 0) return;
  const int cell = per_row ? s * d.width : s * d.width + (i - r * d.width);
  if (d.kind == ZB_ADD) {
    atomicAdd(d.table + cell, __ldg(d.vals + i));
    return;
  }
  if (d.kind == ZB_MAX) {
    atomicMax(d.table + cell, __ldg(d.vals + i));
    return;
  }
  const unsigned long long tag = ((unsigned long long)d.epoch << 32) | (unsigned)(r + 1);
  if (!a.write) {
    atomicMax(per_row ? d.row_claims + s : d.lane_claims + cell, tag);
    return;
  }
  unsigned long long best = 0;
  if (d.row_claims != nullptr) best = d.row_claims[s];
  if (d.lane_claims != nullptr) {
    const unsigned long long c = d.lane_claims[cell];
    best = c > best ? c : best;
  }
  if (best == tag) d.table[cell] = __ldg(d.vals + i);
}

// Launches one pass over ``count`` descriptors. Returns the launches
// enqueued (0 or 1), or minus a CUDA error.
template <int N>
static int launch(const CommitDesc* const* ops, int count, int write, cudaStream_t st) {
  PassArgs<N> a;
  a.n_ops = count;
  a.write = write;
  long long blocks = 0;
  for (int k = 0; k < count; ++k) {
    const CommitDesc& d = *ops[k];
    a.d[k] = d;
    a.start[k] = (int32_t)blocks;
    const long long units = row_claim(d, write) ? d.n : (long long)d.n * d.width;
    blocks += (units + ZB_COMMIT_THREADS - 1) / ZB_COMMIT_THREADS;
  }
  if (blocks > 0x7FFFFFFF) return -(int)cudaErrorInvalidValue;
  a.start[count] = (int32_t)blocks;
  commit_pass_kernel<N><<<(unsigned)blocks, ZB_COMMIT_THREADS, 0, st>>>(a);
  const int err = (int)cudaGetLastError();
  return err ? -err : 1;
}

// One pass over ops [lo, hi) of one stage: pass 0 takes every op with
// work, pass 1 the sets. Returns the launches enqueued, or minus a CUDA
// error.
static int launch_pass(const CommitDesc* ops, int lo, int hi, int write,
                       cudaStream_t st) {
  const CommitDesc* take[ZB_MAX_COMMIT_OPS];
  int count = 0;
  for (int k = lo; k < hi; ++k) {
    const CommitDesc& d = ops[k];
    if (d.kind != ZB_SET && d.kind != ZB_ADD && d.kind != ZB_MAX) {
      return -(int)cudaErrorInvalidValue;
    }
    if (write && d.kind != ZB_SET) continue;
    if (d.n <= 0 || d.width <= 0) continue;
    if (count == ZB_MAX_COMMIT_OPS) return -(int)cudaErrorInvalidValue;
    take[count++] = &d;
  }
  if (count == 0) return 0;
  if (count == 1) return launch<1>(take, count, write, st);
  if (count <= 16) return launch<16>(take, count, write, st);
  return launch<ZB_MAX_COMMIT_OPS>(take, count, write, st);
}

// Enqueues the whole op list on ``stream``: per stage (consecutive ops of
// one ``stage`` value) pass 0, then pass 1 when the stage has a set. The
// claim regions lie in a scratch the caller keeps across calls (see the
// epoch note above). Returns the number of kernel launches enqueued, or
// minus the first CUDA error.
extern "C" int zb_table_commit(const CommitDesc* ops, int n_ops, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int launches = 0;
  for (int lo = 0; lo < n_ops;) {
    int hi = lo + 1;
    while (hi < n_ops && ops[hi].stage == ops[lo].stage) ++hi;
    for (int write = 0; write < 2; ++write) {
      const int r = launch_pass(ops, lo, hi, write, st);
      if (r < 0) return r;
      launches += r;
    }
    lo = hi;
  }
  return launches;
}
