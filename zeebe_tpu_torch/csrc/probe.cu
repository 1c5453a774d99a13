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
//   the claim pass (a thread a record) takes an atomicMax of a 64-bit tag
//   (epoch << 32 | rank + 1) per destination row in a scratch word, and
//   the write pass lets only the record whose tag survived write its row,
//   n_writes times (volatile stores, so the repeats are issued as the
//   serial loop issues them). The epoch grows with every call, so the
//   scratch is never cleared. The write pass takes one warp a record: a
//   row of K = 128 int32 is 512 B, 32 lanes of 16 B, so the index and the
//   claim are read once a warp and, at n_writes 1, the row moves in int4
//   loads and stores. Repeated volatile stores to one address cost more
//   as int4 than as 4-byte words (about twice at n_writes 10 on the
//   card), so at n_writes > 1 lane l stores words l, l + 32, ... instead,
//   each warp instruction a whole 128-byte line. The two passes are
//   chained by programmatic dependent launch: the write pass may start
//   while the claim pass runs, loads its record's
//   index and row first, and reads the claim only after
//   griddepcontrol.wait, which returns once the claim pass has completed
//   and its memory is visible. chip_smoke.py times each pass alone
//   (``passes``). PERF.md §6 (PR 8) records the designs measured against
//   this one and why each lost.
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

// the write pass's warps a block
#define ZB_ROW_WARPS 8

struct RowLoop {
  int32_t* tbl;
  const int32_t* idx;
  const int32_t* rows;
  unsigned long long* claims;  // 64-bit tags, one a table row
  unsigned long long epoch;
  int32_t b;
  int32_t cap;
  int32_t k;
  int32_t n_writes;
  int32_t vec;  // 1: rows and the table move in int4 (k % 4 == 0, aligned)
};

__device__ __forceinline__ unsigned long long row_tag(const RowLoop& a, int i) {
  return (a.epoch << 32) | (unsigned long long)(unsigned)(i + 1);
}

__device__ __forceinline__ void store4(int32_t* p, int4 v, int w) {
  asm volatile("st.volatile.global.v4.s32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(v.x + w), "r"(v.y + w), "r"(v.z + w), "r"(v.w + w) : "memory");
}

// One warp writes record i's row if its claim won: lane l moves units l,
// l + 32, ... of the row (a unit is 4 lanes with vec, else one). ``first``
// is lane l's first unit, loaded early by the caller; ``t`` the record's
// row, in range.
__device__ __forceinline__ void write_row(const RowLoop& a, int i, int32_t t, int lane,
                                          int4 first) {
  const int units = a.vec ? a.k >> 2 : a.k;
  int32_t* const dst = a.tbl + (int64_t)t * a.k;
  const int32_t* const src = a.rows + (int64_t)i * a.k;
  for (int u = lane; u < units; u += 32) {
    if (a.vec) {
      const int4 v = u == lane ? first : __ldg(reinterpret_cast<const int4*>(src) + u);
      for (int w = 0; w < a.n_writes; ++w) store4(dst + 4 * u, v, w);
    } else {
      const int32_t v = u == lane ? first.x : __ldg(src + u);
      volatile int32_t* const p = dst + u;
      for (int w = 0; w < a.n_writes; ++w) *p = v + w;
    }
  }
}

__device__ __forceinline__ int4 first_unit(const RowLoop& a, int i, int lane) {
  int4 v = make_int4(0, 0, 0, 0);
  const int units = a.vec ? a.k >> 2 : a.k;
  if (lane < units) {
    const int32_t* const src = a.rows + (int64_t)i * a.k;
    if (a.vec) {
      v = __ldg(reinterpret_cast<const int4*>(src) + lane);
    } else {
      v.x = __ldg(src + lane);
    }
  }
  return v;
}

// pass 1: a thread a record
__global__ void __launch_bounds__(256) row_claim_kernel(const __grid_constant__ RowLoop a) {
  const int i = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (i < a.b) {
    const int32_t t = a.idx[i];
    if (t >= 0 && t < a.cap) atomicMax(a.claims + t, row_tag(a, i));
  }
  // the write pass may be scheduled now: it reads no claim before its
  // griddepcontrol.wait, which waits for this whole grid and its memory
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// pass 2: a warp a record; the record's index and first row unit are
// loaded before the wait, so they overlap the claim pass
__global__ void __launch_bounds__(ZB_ROW_WARPS * 32)
row_write_kernel(const __grid_constant__ RowLoop a) {
  const int i = (int)(blockIdx.x * ZB_ROW_WARPS + (threadIdx.x >> 5));
  const int lane = (int)(threadIdx.x & 31u);
  const int32_t t = i < a.b ? __ldg(a.idx + i) : -1;
  const bool live = t >= 0 && t < a.cap;
  const int4 first = live ? first_unit(a, i, lane) : make_int4(0, 0, 0, 0);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (!live || __ldcg(a.claims + t) != row_tag(a, i)) return;
  write_row(a, i, t, lane, first);
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

// Enqueues the row loop on ``stream``: the passes in ``passes`` (1 the
// claim pass, 2 the write pass, 3 both; one alone is for timing it).
// ``claims`` is scratch of ``cap`` 64-bit tags kept across calls, all
// below ``epoch`` << 32 (``epoch`` unique per call, below 2^32). Returns
// the launches enqueued, or minus a CUDA error.
extern "C" int zb_row_loop(int32_t* tbl, const int32_t* idx, const int32_t* rows,
                           int64_t b, int64_t cap, int64_t k, int n_writes,
                           unsigned long long* claims, unsigned long long epoch,
                           int passes, void* stream) {
  if (b <= 0 || k <= 0 || n_writes <= 0) return 0;
  if (b > 0x7FFFFFFF || cap > 0x7FFFFFFF || k > 0x7FFFFFFF || passes < 1 || passes > 3) {
    return -(int)cudaErrorInvalidValue;
  }
  // int4 units at n_writes 1, where k and the pointers allow them
  const RowLoop a = {tbl, idx, rows, claims, epoch, (int32_t)b, (int32_t)cap, (int32_t)k,
                     n_writes,
                     n_writes == 1 && (k & 3) == 0 &&
                         (((uintptr_t)tbl | (uintptr_t)rows) & 15) == 0};
  cudaStream_t st = (cudaStream_t)stream;
  int launches = 0;
  if (passes & 1) {
    row_claim_kernel<<<blocks_for(b, 256), 256, 0, st>>>(a);
    const int err = (int)cudaGetLastError();
    if (err) return -err;
    ++launches;
  }
  if (passes & 2) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks_for(b, ZB_ROW_WARPS));
    cfg.blockDim = dim3(ZB_ROW_WARPS * 32);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int err = (int)cudaLaunchKernelEx(&cfg, row_write_kernel, a);
    if (!err) err = (int)cudaGetLastError();
    if (err) return -err;
    ++launches;
  }
  return launches;
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
