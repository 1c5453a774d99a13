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
//
// What bounds it on this card: bytes. Every output byte is written once
// and every requested input row is read once; there is no arithmetic.
// The reads are random rows of tables that mostly fit the 50 MB L2 at the
// main path's sizes, so the floor is (rows read + rows written) over the
// device memory rate, plus one launch.
//
// Design: one launch for the whole op list. The descriptors travel by
// value as the kernel parameter (no host-to-device copy, no extra sync).
// blockIdx.y picks the op; a grid-stride loop over (row, word) pairs lets
// ops of different lengths (3B and B in one call) share one grid. Threads
// copy 4-byte words when the table, its stride, the row width and the
// output are all 4-byte aligned, bytes otherwise (the int8/bool tables).
// A strided column view (one column of a [N, 3] int64 table) is read
// through its row stride, never copied to a contiguous buffer first.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define ZB_MAX_GATHER_OPS 32

struct GatherDesc {
  const char* table;    // the first row of the table (the view's own base)
  int64_t row_stride;   // bytes between consecutive rows
  int64_t row_bytes;    // bytes copied per row
  int64_t rows;         // table row count T
  const int32_t* slots; // [n] row indices (any value; see xla_slot)
  int64_t n;            // slot count
  char* out;            // [n, row_bytes], contiguous
};

struct GatherArgs {
  GatherDesc d[ZB_MAX_GATHER_OPS];
};

__device__ __forceinline__ int64_t xla_slot(int32_t s, int64_t rows) {
  int64_t v = s;
  if (v < 0) v += rows;  // one wrap, as XLA normalizes a negative index
  if (v < 0) v = 0;      // then clamp, as XLA's gather does
  if (v > rows - 1) v = rows - 1;
  return v;
}

__global__ void gather_rows_kernel(GatherArgs args) {
  const GatherDesc d = args.d[blockIdx.y];
  const unsigned aligned =
      (unsigned)(((uintptr_t)d.table | (uintptr_t)d.out |
                  (uint64_t)d.row_stride | (uint64_t)d.row_bytes) & 3u);
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (aligned == 0) {
    const int64_t w = d.row_bytes >> 2;
    const int64_t total = d.n * w;
    uint32_t* out = reinterpret_cast<uint32_t*>(d.out);
    for (int64_t i = first; i < total; i += step) {
      const int64_t r = i / w;
      const int64_t c = i - r * w;
      const int64_t s = xla_slot(__ldg(d.slots + r), d.rows);
      out[i] = __ldg(reinterpret_cast<const uint32_t*>(d.table + s * d.row_stride) + c);
    }
  } else {
    const int64_t w = d.row_bytes;
    const int64_t total = d.n * w;
    for (int64_t i = first; i < total; i += step) {
      const int64_t r = i / w;
      const int64_t c = i - r * w;
      const int64_t s = xla_slot(__ldg(d.slots + r), d.rows);
      d.out[i] = d.table[s * d.row_stride + c];
    }
  }
}

// Launches the gather for ``n_ops`` descriptors on ``stream``. Returns
// cudaGetLastError() after the launch (0 = the launch was accepted).
extern "C" int zb_gather_rows(const GatherDesc* descs, int n_ops,
                              int64_t max_units, void* stream) {
  if (n_ops <= 0 || n_ops > ZB_MAX_GATHER_OPS || max_units <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  GatherArgs args;
  memset(&args, 0, sizeof(args));
  memcpy(args.d, descs, sizeof(GatherDesc) * (size_t)n_ops);
  const int threads = 256;
  int64_t blocks = (max_units + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  dim3 grid((unsigned)blocks, (unsigned)n_ops);
  gather_rows_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}
