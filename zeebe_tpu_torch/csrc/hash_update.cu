// hash_update.cu — batched insert and delete on the int64 → int32
// open-addressing map, in place.
//
// Replaces, in zeebe_tpu/tpu/pallas_ops.py: `insert` (its pl.pallas_call
// at :1110) and `delete` (:1188). Their XLA forms, zeebe_tpu/tpu/hashmap.py
// `insert` and `delete`, are what this file reproduces bit for bit — the
// bucket layout, not only the key → value map (the Pallas insert's serial
// order may place colliding keys elsewhere, pallas_ops.py:1044-1045).
//
// insert: up to MAX_PROBES = 32 synchronous rounds. In a round, each
// pending key reads bucket (h0 + probe) & (T - 1) as the table stood at
// the start of the round; where that bucket is EMPTY or TOMBSTONE (< 0)
// the key attempts it, and the lowest batch rank among the attempts on
// one bucket wins it. Winners write key and value; every key still
// pending advances its probe, losers included. `ok` is true for the
// placed keys. A round in which no key is pending changes nothing, so the
// loop stops at the first such round.
//
// delete: per valid key, probe from h0; a bucket holding the key (checked
// first, as the XLA loop does) becomes TOMBSTONE, an EMPTY bucket ends
// the chain. Values are untouched.
//
// What bounds them on this card: latency, not bytes. Each round of an
// insert reads one bucket and does one atomic per pending key, and the
// rounds are serial; at the join path's load (2^14 keys into 2^18
// buckets) almost every key is placed in round 1, so a call is a few
// grid-wide barriers. A delete is one dependent chain of 8-byte reads per
// key, 1-3 buckets long at that load.
//
// Design. insert is ONE cooperative launch (grid-stride over the keys)
// with two grid-wide barriers per round: claim, barrier, write, barrier.
// The claim is an atomicMax of (epoch << 32 | 0x7FFFFFFF - rank) into a
// scratch word per bucket, so the lowest rank holds the largest tag; the
// epoch is new for each round of each call (the wrapper shares the claim
// scratch of table_commit.cu), so the scratch is never cleared. A thread
// keeps its keys for the whole call, so the per-key probe and placed flag
// live in global memory written only by their owner. Whether any key is
// still pending is summed into a per-round counter that every block reads
// after the barrier, so all blocks leave the loop together and no host
// sync happens inside the call. Buckets and claims written by other
// blocks are read past L1 (__ldcg).
// delete is one thread per key, in place: a tombstone that another thread
// writes during the pass neither matches a live key nor ends a chain, so
// a single pass gives the XLA result (for keys held at most once, as the
// engine's are; deleting the EMPTY sentinel twice in one batch is the one
// case that would differ, and no caller does it).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "zb_hash.cuh"

namespace cg = cooperative_groups;

struct InsertArgs {
  int64_t* tkeys;             // [tsize], updated in place
  int32_t* tvals;             // [tsize], updated in place
  int64_t tsize;              // a power of two
  const int64_t* keys;        // [n]
  const int32_t* vals;        // [n]
  const uint8_t* valid;       // [n] bool
  int64_t n;
  int32_t* probe;             // [n] scratch: the key's next probe offset
  uint8_t* ok;                // [n] out: placed
  unsigned long long* claims; // >= tsize words
  unsigned long long epoch;   // first of ZB_MAX_PROBES consecutive epochs
  unsigned int* pending;      // [ZB_MAX_PROBES + 1] scratch counters
};

__global__ void hash_insert_kernel(InsertArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const uint32_t mask = (uint32_t)(a.tsize - 1);
  for (int64_t i = first; i < a.n; i += stride) {
    a.probe[i] = 0;
    a.ok[i] = 0;
  }
  if (first == 0) a.pending[0] = 0;
  for (int round = 0; round < ZB_MAX_PROBES; ++round) {
    const unsigned long long hi = (a.epoch + (unsigned long long)round) << 32;
    // claim: attempt a free bucket of the table as it stood at the round's start
    for (int64_t i = first; i < a.n; i += stride) {
      if (!a.valid[i] || a.ok[i]) continue;
      const uint32_t idx = (zb_hash(a.keys[i], mask) + (uint32_t)a.probe[i]) & mask;
      if (__ldcg(a.tkeys + idx) < 0)
        atomicMax(a.claims + idx, hi | (unsigned long long)(0x7FFFFFFFLL - i));
    }
    // the next round's counter is zeroed here, two barriers before its use
    if (first == 0) a.pending[round + 1] = 0;
    grid.sync();
    // write: the bucket's lowest-rank attempt holds the tag; the rest advance
    unsigned int left = 0;
    for (int64_t i = first; i < a.n; i += stride) {
      if (!a.valid[i] || a.ok[i]) continue;
      const int64_t key = a.keys[i];
      const uint32_t idx = (zb_hash(key, mask) + (uint32_t)a.probe[i]) & mask;
      if (__ldcg(a.claims + idx) == (hi | (unsigned long long)(0x7FFFFFFFLL - i))) {
        a.tkeys[idx] = key;
        a.tvals[idx] = a.vals[i];
        a.ok[i] = 1;
      } else {
        a.probe[i] += 1;
        left = 1;
      }
    }
    if (__syncthreads_or(left) && threadIdx.x == 0) atomicAdd(a.pending + round, 1u);
    grid.sync();
    if (__ldcg(a.pending + round) == 0) break;  // the same answer in every block
  }
}

__global__ void hash_delete_kernel(int64_t* tkeys, int64_t tsize, const int64_t* keys,
                                   const uint8_t* valid, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  const int64_t key = keys[i];
  const uint32_t mask = (uint32_t)(tsize - 1);
  const uint32_t h0 = zb_hash(key, mask);
  for (int j = 0; j < ZB_MAX_PROBES; ++j) {
    const uint32_t idx = (h0 + (uint32_t)j) & mask;
    const int64_t k = __ldcg(tkeys + idx);
    if (k == key) {
      tkeys[idx] = ZB_TOMBSTONE;
      return;
    }
    if (k == ZB_EMPTY) return;
  }
}

// Blocks of ``threads`` for the insert's grid-stride loop over ``n`` keys:
// enough for the keys and no more than can be resident at once, since the
// grid-wide barrier needs every block live. The resident count is asked of
// the runtime once per device. Returns a CUDA error, 0 on success.
static int insert_blocks(int threads, int64_t n, int* blocks) {
  static int resident[64];  // per device ordinal; 0 = not asked yet
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  int most = dev < 64 ? resident[dev] : 0;
  if (most == 0) {
    int sms = 0, per_sm = 0;
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (!err) err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hash_insert_kernel, threads, 0);
    if (err) return err;
    most = sms * per_sm;
    if (dev < 64) resident[dev] = most;
  }
  const int64_t want = (n + threads - 1) / threads;
  *blocks = (int)(want < most ? want : most);
  return 0;
}

static int valid_size(int64_t tsize) {
  return tsize > 0 && (tsize & (tsize - 1)) == 0 && tsize <= (1LL << 32);
}

// Inserts ``n`` keys into the table in place as one cooperative launch on
// ``stream``. ``probe`` ([n] int32) and ``pending`` ([MAX_PROBES + 1]
// uint32) are scratch the caller allocates; ``claims`` and the epochs
// [epoch, epoch + MAX_PROBES) follow the claim-scratch contract above.
// Returns the first CUDA error (0 = the launch was accepted).
extern "C" int zb_hash_insert(int64_t* tkeys, int32_t* tvals, int64_t tsize,
                              const int64_t* keys, const int32_t* vals,
                              const uint8_t* valid, int64_t n, int32_t* probe,
                              uint8_t* ok, unsigned long long* claims,
                              unsigned long long epoch, unsigned int* pending,
                              void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (!valid_size(tsize)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  int blocks = 0;
  const int err = insert_blocks(threads, n, &blocks);
  if (err) return err;
  InsertArgs a{tkeys, tvals, tsize, keys, vals, valid, n, probe, ok, claims, epoch, pending};
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)hash_insert_kernel, dim3(blocks),
                                          dim3(threads), params, 0, (cudaStream_t)stream);
}

// Deletes ``n`` keys from the table in place, one thread per key, on
// ``stream``. Returns cudaGetLastError() after the launch.
extern "C" int zb_hash_delete(int64_t* tkeys, int64_t tsize, const int64_t* keys,
                              const uint8_t* valid, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (!valid_size(tsize)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  hash_delete_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(tkeys, tsize, keys,
                                                                    valid, n);
  return (int)cudaGetLastError();
}
