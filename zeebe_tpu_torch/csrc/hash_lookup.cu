// hash_lookup.cu — every independent probe of the int64 → int32
// open-addressing map in one step, in one launch.
//
// Replaces: zeebe_tpu/tpu/pallas_ops.py `lookup` (its pl.pallas_call at
// :1028), whose XLA form is zeebe_tpu/tpu/hashmap.py `lookup`. The step
// kernel uses it as the fallback for direct-mapped index misses, for the
// timer map and on the join path.
//
// What it computes, per probe p and key i: for a valid key, linear
// probing from h0 over at most MAX_PROBES = 32 buckets, (h0 + j) & (T - 1);
// a bucket holding the key is a hit (found, its value; the key is compared
// before EMPTY, as the XLA loop does); an EMPTY bucket (-1) ends the
// chain; a TOMBSTONE (-2) is stepped over. An invalid key, a miss or an
// exhausted chain returns (false, -1). h0 is bit-identical to
// hashmap._hash (zb_hash.cuh), because tables cross engines in snapshots.
//
// What bounds it on this card: launch overhead, then latency. On the step
// kernel's path almost every key is invalid (a direct-index hit needs no
// probe: 7.5 % of a config-1 drive's fallback keys are valid, most
// launches have none), so a launch is about its fixed cost; a valid key
// is a chain of dependent random 8-byte reads, 1-3 buckets at the load
// the engine keeps.
//
// Design: one launch for up to ZB_MAX_LOOKUPS probes of one step (the
// step's independent fallbacks, on different maps), so a step pays the
// launch once. The descriptors travel by value (__grid_constant__, as
// gather_rows.cu's), so there is no host-to-device copy; the block is
// templated on the probes it holds (1, 2, 4 or 8), and each probe owns a
// block range planned by the wrapper (tpu/ops.py `lookup_plan`). A block
// finds its probe by the starts and runs that probe's inlined copy of the
// walk, which reads the descriptor at a constant index, so its fields are
// constant-bank operands rather than loads. One thread walks one key: a
// thread that took 4 consecutive keys (their flags read as one word, an
// all-invalid quad answered with one 4-byte and one 16-byte store) was
// slower on this card, whether it walked the 4 chains together or one
// after another. Keys may come strided (a column of a wider table) and
// are read through their stride, only where valid.

#include <cuda_runtime.h>
#include <stdint.h>

#include "zb_hash.cuh"

#define ZB_MAX_LOOKUPS 8
// keep equal to tpu/ops.py _LOOKUP_THREADS
#define ZB_LOOKUP_THREADS 256

struct LookupDesc {
  const int64_t* tkeys;  // [T] the map's keys
  const int32_t* tvals;  // [T] the map's values
  const int64_t* keys;   // the probe's keys, element i at keys[i * key_stride]
  const uint8_t* valid;  // [n] bool
  uint8_t* found;        // [n] out
  int32_t* vals;         // [n] out, -1 where not found
  int64_t key_stride;    // in elements
  uint32_t mask;         // T - 1, T a power of two
  int32_t n;             // keys
};

// The argument block of up to N probes. The wrapper fills the largest;
// each launch passes the smallest that holds its probes (less to copy at
// every launch).
template <int N>
struct LookupArgs {
  LookupDesc d[N];
  int32_t start[N + 1];  // first block of each probe; [n_probes] = grid
  int32_t n_probes;
};

// Key ``i`` of probe ``d`` (a descriptor at a constant index of the
// parameter block, so its fields are constant-bank operands, not loads).
__device__ __forceinline__ void probe_key(const LookupDesc& d, int64_t i) {
  if (i >= d.n) return;
  uint8_t f = 0;
  int32_t v = -1;
  if (d.valid[i]) {
    const int64_t key = d.keys[i * d.key_stride];
    uint32_t idx = zb_hash(key, d.mask);
    for (int j = 0; j < ZB_MAX_PROBES; ++j) {
      const int64_t k = __ldg(d.tkeys + idx);
      if (k == key) {  // checked before EMPTY, as the XLA loop does
        f = 1;
        v = __ldg(d.tvals + idx);
        break;
      }
      if (k == ZB_EMPTY) break;
      idx = (idx + 1u) & d.mask;
    }
  }
  d.found[i] = f;
  d.vals[i] = v;
}

template <int N>
__global__ void __launch_bounds__(ZB_LOOKUP_THREADS)
hash_lookup_kernel(const __grid_constant__ LookupArgs<N> a) {
  const int b = (int)blockIdx.x;
  int p = 0;
#pragma unroll
  for (int k = 1; k < N; ++k) {
    if (k < a.n_probes && b >= a.start[k]) p = k;
  }
  // one inlined copy of the probe per descriptor, each at a constant index
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k == p) {
      probe_key(a.d[k], (int64_t)(b - a.start[k]) * ZB_LOOKUP_THREADS + threadIdx.x);
    }
  }
}

template <int N>
static int launch(const LookupArgs<ZB_MAX_LOOKUPS>* args, int blocks, cudaStream_t stream) {
  LookupArgs<N> a;
  for (int p = 0; p < args->n_probes; ++p) {
    a.d[p] = args->d[p];
    a.start[p] = args->start[p];
  }
  a.start[args->n_probes] = blocks;
  a.n_probes = args->n_probes;
  hash_lookup_kernel<N><<<(unsigned)blocks, ZB_LOOKUP_THREADS, 0, stream>>>(a);
  const int err = (int)cudaGetLastError();
  return err ? -err : 1;
}

// Launches the planned probes on ``stream``. Returns the launches enqueued
// (1, or 0 when the plan has no block), or minus a CUDA error.
extern "C" int zb_hash_lookup(const LookupArgs<ZB_MAX_LOOKUPS>* args, void* stream) {
  const int n = args->n_probes;
  if (n <= 0 || n > ZB_MAX_LOOKUPS) return -(int)cudaErrorInvalidValue;
  const int blocks = args->start[n];
  if (blocks <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 1) return launch<1>(args, blocks, s);
  if (n == 2) return launch<2>(args, blocks, s);
  if (n <= 4) return launch<4>(args, blocks, s);
  return launch<ZB_MAX_LOOKUPS>(args, blocks, s);
}
