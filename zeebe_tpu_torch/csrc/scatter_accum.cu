// scatter_accum.cu — a step's commutative scatters (add, max), one launch.
//
// Replaces, in zeebe_tpu/tpu/pallas_ops.py: `masked_row_max` (its
// pl.pallas_call at :317), `masked_row_add` (:378) and the accumulate of
// `_lane_op` (:441, behind `masked_lane_accum`). The semantics are those
// of the XLA op chain `_apply_op_unfused` (pallas_ops.py:553-564):
//   add — table[slot, lane] += vals[i, lane] for each active record and
//         each lane of its mask (every lane without one); duplicates sum;
//   max — table[slot] = max(table[slot], vals[i]), whole rows: the JAX
//         `masked_row_max` takes no lane mask;
// a 1D table is a table of width 1 (and takes only `add`: the JAX chain
// routes a 1D `max` to a lane SET, which the table commit runs). A slot
// wraps once when negative and is dropped when it is still outside
// [0, rows) — the `mode="drop"` scatter that parks inactive records on
// the sentinel slot. The tables are updated IN PLACE.
//
// What bounds it on this card: not bytes. Config 3's pair (2^14 records
// into a [2^16, 4] and a [2^16, 8] int32 table) moves under 1.2 MB, about
// 0.3 µs at 3.35 TB/s, and the boot self-check's accumulate (2^8 records)
// a few KB. What is left is the launch, a few µs of atomics that resolve
// in L2 (one transaction per row segment a warp instruction touches), and
// the host work of the wrapper, which around one call cost more than the
// device did when these ops were one-op table commits.
//
// Design. No stage, no claim scratch, no epoch: add and max commute, so
// every op of a call runs side by side in ONE launch. The ops (at most
// ZB_MAX_ACCUM_OPS; config 3's two row maxima are one call) travel by
// value in a __grid_constant__ parameter block, each with its own range of
// blocks. One thread takes one (record, lane), the lanes of a record
// neighbours: a warp instruction's values are one coalesced load, its
// slot and flag loads hit one address per record, and its atomics — an
// atomicAdd / atomicMax whose result is unused, so a fire-and-forget
// reduction (RED) — land as one L2 transaction per row segment. (A thread
// per 4-lane chunk, with 16-byte value loads and four REDs a thread, cost
// up to 2x the device time on the card: each RED of a warp instruction hits
// 32 rows; PERF.md §6.) The host side is one packed block — the
// stream, the op count, the ops — that the wrapper builds with one
// struct.pack and hands over in one ctypes call; the C entry derives the
// block plan itself.

#include <cuda_runtime.h>
#include <stdint.h>

enum { ZB_ADD = 1, ZB_MAX = 2 };  // tpu/ops.py _KINDS (table_commit.cu's codes)

#define ZB_MAX_ACCUM_OPS 8
#define ZB_ACCUM_THREADS 256

// One op as the wrapper packs it (tpu/ops.py _ACCUM_LAYOUT).
struct AccumOp {
  int32_t* table;         // [rows, width] int32, row-major, updated in place
  const int32_t* slots;   // [n]
  const uint8_t* active;  // [n] bool
  const int32_t* vals;    // [n, width]
  const uint8_t* mask;    // [n, width] bool, or null: every lane
  int32_t rows;
  int32_t width;          // 1 for a 1D table
  int32_t n;
  int32_t kind;           // ZB_ADD / ZB_MAX
};

// The wrapper's call (tpu/ops.py _ACCUM_HEAD): its stream and op count,
// then n_ops packed ops.
struct AccumCall {
  void* stream;
  int32_t n_ops;
  int32_t pad;
  AccumOp op[ZB_MAX_ACCUM_OPS];
};

// A launch's parameter block: N ops by value, N the smallest of 1, 2 and
// ZB_MAX_ACCUM_OPS that holds the call.
template <int N>
struct AccumArgs {
  AccumOp d[N];
  int32_t start[N + 1];  // first block of each op; [n_ops] = grid
  int32_t n_ops;
};

template <int N>
__global__ void __launch_bounds__(ZB_ACCUM_THREADS)
scatter_accum_kernel(const __grid_constant__ AccumArgs<N> a) {
  const int b = (int)blockIdx.x;
  int k = 0;
  while (k + 1 < a.n_ops && b >= a.start[k + 1]) ++k;
  const AccumOp& o = a.d[k];
  const int i = (b - a.start[k]) * ZB_ACCUM_THREADS + (int)threadIdx.x;
  if (i >= o.n * o.width) return;  // n * width < 2^31: the wrapper checks
  const int r = i / o.width;
  if (!o.active[r]) return;
  if (o.mask != nullptr && !o.mask[i]) return;
  int s = __ldg(o.slots + r);
  if (s < 0) s += o.rows;  // one wrap, as XLA normalizes a negative index
  if (s < 0 || s >= o.rows) return;
  int32_t* const cell = o.table + (int64_t)s * o.width + (i - r * o.width);
  if (o.kind == ZB_ADD) {
    atomicAdd(cell, __ldg(o.vals + i));
  } else {
    atomicMax(cell, __ldg(o.vals + i));
  }
}

template <int N>
static int launch(const AccumCall* c, cudaStream_t st) {
  AccumArgs<N> a;
  a.n_ops = c->n_ops;
  long long blocks = 0;
  for (int k = 0; k < c->n_ops; ++k) {
    const AccumOp& o = c->op[k];
    if ((o.kind != ZB_ADD && o.kind != ZB_MAX) || o.n < 0 || o.width < 0) {
      return -(int)cudaErrorInvalidValue;
    }
    a.d[k] = o;
    a.start[k] = (int32_t)blocks;
    blocks += ((long long)o.n * o.width + ZB_ACCUM_THREADS - 1) / ZB_ACCUM_THREADS;
  }
  if (blocks == 0) return 0;
  if (blocks > 0x7FFFFFFF) return -(int)cudaErrorInvalidValue;
  a.start[c->n_ops] = (int32_t)blocks;
  scatter_accum_kernel<N><<<(unsigned)blocks, ZB_ACCUM_THREADS, 0, st>>>(a);
  const int err = (int)cudaGetLastError();
  return err ? -err : 1;
}

// Applies every op of ``c`` in place, one launch on its stream. Returns
// the launches enqueued (1, or 0 when no op has a record), or minus a
// CUDA error.
extern "C" int zb_scatter_accum(const AccumCall* c) {
  const int n = c->n_ops;
  if (n <= 0 || n > ZB_MAX_ACCUM_OPS) return -(int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)c->stream;
  if (n == 1) return launch<1>(c, st);
  if (n == 2) return launch<2>(c, st);
  return launch<ZB_MAX_ACCUM_OPS>(c, st);
}
