// gather_rows.cu — every row read of one wave step, in one launch.
//
// Replaces: zeebe_tpu/tpu/pallas_ops.py `fused_gather_rows` (its
// pl.pallas_call at :902), which the step kernel uses for the per-element
// graph row, the direct-mapped index probes and key-column verifies, the
// phase-B/C state rows, the 1D state reads and the emission compaction.
//
// What it computes: for each op j, out_j[r] = table_j[slot_j[r]], where a
// "row" is a 2D table's row or one element of a 1D table. Slots follow
// XLA's gather: a negative slot wraps once (s + T), then the slot is
// clamped into [0, T-1]. The copy is of raw bytes, so f32 NaN payloads,
// int64 keys and bool/int8 flags all come out bit-exact with no casts.
// Slots arrive as int32; the wrapper clamps int64 slots into int32 range
// first, which keeps the wrap-then-clamp answer.
//
// What bounds it on this card: bytes and latency. Every output byte is
// written once and every requested row is read once; there is no
// arithmetic. At the main path's sizes the tables (2^16 rows of at most
// 96 B, about 6 MB each) sit in the 50 MB L2, so the reads are random
// L2 hits and the design's job is to keep many of them in flight.
//
// Design: one flat 1-D grid for the whole op list, planned by the wrapper
// (tpu/ops.py `gather_plan`): each op gets ceil(rows / rows-per-block)
// blocks of its own, so no block is launched without work; a block finds
// its op by scanning the 32 or fewer starts in the parameter block. The
// descriptors travel by value (__grid_constant__: read in place, not
// copied per thread), so there is no host-to-device copy.
// A group of `lanes` threads (a power of two, 32 at most) copies one row:
// lane 0 loads the slot and normalises it once, __shfl_sync hands it to
// the group, and each lane copies whole units of the row. The unit is the
// widest of 16, 8, 4, 2 or 1 bytes that the table's base, its row stride,
// the row width and the output all allow: the 96-byte payload rows and
// the 32-byte job rows move as uint4, the 24-byte rows and int64 columns
// as uint2, int32 columns as words, byte-wide flags as bytes. Each group
// copies ZB_GATHER_UNROLL rows at once, so every thread has that many
// independent loads in flight before its first store. Index math is
// 32-bit; a row's address is one widening multiply of slot and stride.
// Hopper's TMA copies tiles, not rows picked by an index list (a row
// gather mode arrives with the next generation), so plain vector loads
// through the read-only path (__ldg) are the tool here.

#include <cuda_runtime.h>
#include <stdint.h>

#define ZB_MAX_GATHER_OPS 32
// keep equal to tpu/ops.py _GATHER_THREADS and _GATHER_UNROLL
#define ZB_GATHER_THREADS 256
#define ZB_GATHER_UNROLL 4

struct GatherDesc {
  const char* table;     // the first row of the table (the view's own base)
  const int32_t* slots;  // [n] row indices (any value; see xla_slot)
  char* out;             // [n, vecs * vec_bytes], contiguous
  int32_t row_stride;    // bytes between consecutive rows
  int32_t rows;          // table row count T, >= 1
  int32_t n;             // slot count
  int32_t vecs;          // copy units per row
  int32_t vec_bytes;     // bytes per unit: 16, 8, 4, 2 or 1
  int32_t lanes;         // threads per row: a power of two, at most 32
};

struct GatherArgs {
  GatherDesc d[ZB_MAX_GATHER_OPS];
  int32_t start[ZB_MAX_GATHER_OPS + 1];  // first block of each op; [n_ops] = grid
  int32_t n_ops;
};

__device__ __forceinline__ int xla_slot(int32_t s, int32_t rows) {
  if (s < 0) s += rows;  // one wrap, as XLA normalizes a negative index
  s = s < 0 ? 0 : s;     // then clamp, as XLA's gather does
  return s > rows - 1 ? rows - 1 : s;
}

template <typename V>
__device__ __forceinline__ void copy_rows(const GatherDesc& d, int block) {
  const int shift = __ffs(d.lanes) - 1;
  const int groups = ZB_GATHER_THREADS >> shift;
  const int lane = (int)threadIdx.x & (d.lanes - 1);
  const int row0 = block * groups * ZB_GATHER_UNROLL + ((int)threadIdx.x >> shift);
  const char* src[ZB_GATHER_UNROLL];
#pragma unroll
  for (int u = 0; u < ZB_GATHER_UNROLL; ++u) {
    const int r = row0 + u * groups;
    int s = 0;
    if (lane == 0 && r < d.n) s = xla_slot(__ldg(d.slots + r), d.rows);
    s = __shfl_sync(0xffffffffu, s, 0, d.lanes);
    src[u] = d.table + (unsigned long long)(unsigned)s * (unsigned)d.row_stride;
  }
  for (int c = lane; c < d.vecs; c += d.lanes) {
    V v[ZB_GATHER_UNROLL];
#pragma unroll
    for (int u = 0; u < ZB_GATHER_UNROLL; ++u) {
      if (row0 + u * groups < d.n) v[u] = __ldg(reinterpret_cast<const V*>(src[u]) + c);
    }
#pragma unroll
    for (int u = 0; u < ZB_GATHER_UNROLL; ++u) {
      const int r = row0 + u * groups;
      if (r < d.n) {
        reinterpret_cast<V*>(d.out)[(unsigned long long)(unsigned)r * (unsigned)d.vecs + c] = v[u];
      }
    }
  }
}

__global__ void __launch_bounds__(ZB_GATHER_THREADS)
gather_rows_kernel(const __grid_constant__ GatherArgs a) {
  const int b = (int)blockIdx.x;
  int k = 0;
  while (k + 1 < a.n_ops && b >= a.start[k + 1]) ++k;
  const GatherDesc& d = a.d[k];
  const int block = b - a.start[k];
  switch (d.vec_bytes) {
    case 16: copy_rows<uint4>(d, block); break;
    case 8: copy_rows<uint2>(d, block); break;
    case 4: copy_rows<unsigned int>(d, block); break;
    case 2: copy_rows<unsigned short>(d, block); break;
    default: copy_rows<unsigned char>(d, block); break;
  }
}

// Launches the planned gather on ``stream``. Returns the launches enqueued
// (1, or 0 when the plan has no block), or minus a CUDA error.
extern "C" int zb_gather_rows(const GatherArgs* args, void* stream) {
  if (args->n_ops <= 0 || args->n_ops > ZB_MAX_GATHER_OPS) {
    return -(int)cudaErrorInvalidValue;
  }
  const int blocks = args->start[args->n_ops];
  if (blocks <= 0) return 0;
  gather_rows_kernel<<<(unsigned)blocks, ZB_GATHER_THREADS, 0, (cudaStream_t)stream>>>(*args);
  const int err = (int)cudaGetLastError();
  return err ? -err : 1;
}
