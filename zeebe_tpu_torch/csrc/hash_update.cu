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
// pending advances its probe, losers included (so a pending key's probe
// is the round's number). `ok` is true for the placed keys. A round in
// which no key is pending changes nothing, so the loop stops at the first
// such round.
//
// delete: per valid key, probe from h0 over at most MAX_PROBES buckets; a
// bucket holding the key (checked first, as the XLA loop does) becomes
// TOMBSTONE, an EMPTY bucket ends the chain. Values are untouched. One
// launch takes up to ZB_MAX_DELETES independent deletes (a step's maps).
//
// What bounds them on this card: latency and the rate of random accesses
// per SM, not bytes. The rounds are serial; each is a claim, a barrier, a
// read of the bucket and the claim, and the winners' writes. At the join
// path's load (2^14 keys into 2^18 buckets, ~40 % live and ~10 %
// tombstones) a call takes 26-32 rounds, at the rebuild shape (2^16 keys
// into a fresh 2^18-bucket map) about 10, and after round 2 under a tenth
// of the keys are pending; round 1, which touches every key (five random
// accesses each), is bound by how many SMs issue them. A delete is a
// dependent chain of 8-byte reads per key: 2.7 buckets on average at that
// load, but up to 32, and a launch lasts as long as its longest chain
// (a thread walking each key alone took 10.9 us on an H100 at
// chip_smoke.py's delete case, 0.01 of its byte bound's rate).
//
// Design. insert is ONE launch of ONE thread-block cluster of
// ZB_INSERT_BLOCKS = 16 blocks of 1,024 threads (the non-portable cluster
// size the H100 allows; 8 blocks, the portable size, took longer at the
// rebuild shape), so the rounds' barriers are the cluster's hardware
// barrier, cluster.sync(), not a grid-wide one: one a round, between the
// claims and the writes. The claim is an atomicMax of (epoch << 32 |
// 0x7FFFFFFF - rank) into a scratch word per bucket, so the lowest rank
// holds the largest tag whatever the order of the claims; the epoch is
// new for each round of each call (the wrapper shares the claim scratch
// of table_commit.cu), so the scratch is never cleared. Every pending key
// claims without reading its bucket first: the keys on one bucket are all
// attempts or none, so the write phase, which reads the bucket beside the
// claim, places the claim's holder only where the bucket was free. The
// writes of a round and the claims of the next need no barrier between
// them, because the claims read nothing and the rounds claim into
// alternate halves of the scratch: a word a round reads after its barrier
// is not claimed again until two barriers later.
// Block b owns keys [b * share, (b + 1) * share) (the wrapper's plan,
// tpu/ops.py `insert_plan`): round 1 reads them all and writes every
// `ok`; from then on the block walks only a worklist of its pending keys,
// (rank, bucket) pairs in global scratch the wrapper provides,
// double-buffered (one list read while the next is written), their
// lengths in the block's shared memory. Whether any key of the cluster is
// still pending after a round is written into every block's shared
// memory through distributed shared memory (a slot per round, three in
// turn); each block reads its own after the next round's barrier, so all
// blocks leave the loop together (the next round's claims are empty
// then), no host sync happens inside the call, and no block reads
// another's shared memory, so none waits for the others to leave (a
// count in block 0 would need a last barrier). Buckets and claims that
// other blocks write are read past L1 (__ldcg); the cluster barrier's
// release and acquire order them. Each thread takes ZB_INSERT_UNROLL keys
// (or entries) of a phase at once, so their loads are in flight together,
// and a key and its value are loaded beside its claim, not after it. Keys
// may come strided (a column of a wider table). A launch of one cluster by
// cudaLaunchKernelEx can be captured in a CUDA graph (chip_smoke.py
// replays one).
// delete walks the chains warp-cooperatively (zb_hash.cuh
// zb_window_walk): a warp takes 32 consecutive keys, reads their valid
// flags with one load a lane, and leaves at once when none is valid (most
// of the step kernel's deletes find no valid key); else each group of
// ZB_DELETE_GROUP = 8 lanes walks 8 of the warp's keys side by side, a
// window of 8 consecutive buckets a key in one step, then the other 24
// buckets of the keys still walking in a second: a chain of up to 32
// buckets takes two dependent steps instead of up to 32 (97 % of
// chip_smoke.py's keys end in the first), and the lane that read the key
// writes the tombstone. Of the widths and step plans tried, G = 8 with
// every remaining window read at once was the fastest on cold maps
// (PERF.md §6). Keys are read only where valid, through their stride.
// In place, in one pass: a tombstone that another group writes during
// the pass neither matches a live key nor ends a chain, whichever of the
// old key and the tombstone a group reads, so the result is the XLA one,
// which finds every slot in the table as it stood before the call (for
// keys held at most once, as the engine's are; deleting the EMPTY
// sentinel twice in one call is the one case that would differ, and no
// caller does it). The launch takes the step's deletes as descriptors
// passed by value (__grid_constant__, as hash_lookup.cu's probes), a
// block templated on 1, 2, 4 or 8 of them reading its own at a constant
// index; the block plan is tpu/ops.py `lookup_plan` (ZB_DELETE_THREADS
// keys a block).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "zb_hash.cuh"

namespace cg = cooperative_groups;

// keep equal to tpu/ops.py _INSERT_BLOCKS
#define ZB_INSERT_BLOCKS 16
#define ZB_INSERT_THREADS 1024
// keys (or worklist entries) a thread takes at once in a phase
#define ZB_INSERT_UNROLL 4
// keep equal to tpu/ops.py _MAX_DELETES, _DELETE_THREADS and _DELETE_GROUP:
// the deletes one launch takes, a block's threads (one key each), and the
// lanes that walk one key together
#define ZB_MAX_DELETES 8
#define ZB_DELETE_THREADS 256
#define ZB_DELETE_GROUP 8

struct InsertArgs {
  int64_t* tkeys;              // [T], updated in place
  int32_t* tvals;              // [T], updated in place
  const int64_t* keys;         // key i at keys[i * key_stride]
  const int32_t* vals;         // [n]
  const uint8_t* valid;        // [n] bool
  uint8_t* ok;                 // [n] out: placed
  unsigned long long* claims;  // >= 2 T words: round r claims into half r % 2
  int2* work;                  // [2 * ZB_INSERT_BLOCKS * share] (rank, bucket) worklists
  int64_t key_stride;          // in elements
  unsigned long long epoch;    // first of `rounds` consecutive epochs
  uint32_t mask;               // T - 1, T a power of two
  int32_t n;                   // keys
  int32_t share;               // keys a block owns: ceil(n / ZB_INSERT_BLOCKS)
  int32_t rounds;              // at most this many rounds (MAX_PROBES)
};

__device__ __forceinline__ unsigned long long claim_tag(unsigned long long epoch_tag,
                                                        int64_t rank) {
  return epoch_tag | (0x7FFFFFFFull - (unsigned long long)rank);
}

__global__ void __launch_bounds__(ZB_INSERT_THREADS, 1)
hash_insert_kernel(const __grid_constant__ InsertArgs a) {
  constexpr int U = ZB_INSERT_UNROLL;
  constexpr int STEP = ZB_INSERT_THREADS * U;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ unsigned int count[2];  // this block's worklists' lengths
  __shared__ unsigned int left[3];   // any block with keys pending, by round % 3
  const unsigned int rank = cluster.block_rank();
  const int tid = (int)threadIdx.x;
  const int64_t lo = (int64_t)rank * a.share;
  const int64_t hi = lo + a.share < a.n ? lo + a.share : (int64_t)a.n;
  int2* const list0 = a.work + (int64_t)rank * a.share;
  int2* const list1 = a.work + (int64_t)(ZB_INSERT_BLOCKS + rank) * a.share;
  const uint64_t tsize = (uint64_t)a.mask + 1;
  // thread t < ZB_INSERT_BLOCKS tells block t that this block has keys pending
  unsigned int* const tell = cluster.map_shared_rank(left, tid % ZB_INSERT_BLOCKS);
  if (tid == 0) {
    count[0] = count[1] = 0;
    left[0] = left[1] = left[2] = 0;
  }
  __syncthreads();
  for (int r = 0; r < a.rounds; ++r) {
    const unsigned long long tag = (a.epoch + (unsigned long long)r) << 32;
    const int cur = r & 1;
    int2* const from = cur ? list1 : list0;  // this round's keys (after round 1)
    int2* const to = cur ? list0 : list1;    // the next round's
    unsigned long long* const claims = a.claims + (cur ? tsize : 0);
    const int len = (int)count[cur];
    // claim: every pending key claims its bucket. All keys on one bucket
    // see the same bucket at the round's start, so they are either all
    // attempts (it is free) or all not; the write phase reads the bucket
    // beside the claim and places a key only where it was free. Each
    // thread takes U keys (or entries) at once, so their loads are in
    // flight together.
    if (r == 0) {
      for (int64_t base = lo + tid; base < hi; base += STEP) {
        bool v[U];
        uint32_t idx[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t i = base + (int64_t)u * ZB_INSERT_THREADS;
          v[u] = i < hi && a.valid[i];
          idx[u] = i < hi ? zb_hash(a.keys[i * a.key_stride], a.mask) : 0u;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (v[u]) atomicMax(claims + idx[u], claim_tag(tag, base + (int64_t)u * ZB_INSERT_THREADS));
        }
      }
    } else {
      for (int base = tid; base < len; base += STEP) {
        int2 w[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = base + u * ZB_INSERT_THREADS;
          w[u] = e < len ? from[e] : make_int2(-1, 0);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (w[u].x >= 0) atomicMax(claims + (uint32_t)w[u].y, claim_tag(tag, w[u].x));
        }
      }
    }
    // the list this round fills was last read in the previous round
    if (tid == 0) count[cur ^ 1] = 0;
    // the round's one barrier: this round's claims are in, the previous
    // round's winners are in the table and its pending count is final
    cluster.sync();
    if (r > 0 && left[(r - 1) % 3] == 0) break;  // the same answer in every block
    if (tid == 0) left[(r + 1) % 3] = 0;  // round r - 2's: read after the previous barrier
    // write: a key whose bucket was free and whose tag the claim holds (the
    // lowest rank on it) places itself; the rest advance. The bucket, the
    // claim, and the key and value are loaded together. Only a bucket's
    // winner writes it, after its own read, so every read sees the bucket
    // as it stood at the round's start, or belongs to a loser. The next
    // round claims into the other half of the scratch, so no block's next
    // claims reach a word this round still reads.
    bool pending = false;
    if (r == 0) {
      for (int64_t base = lo + tid; base < hi; base += STEP) {
        bool v[U];
        uint32_t idx[U];
        int64_t key[U], held[U];
        int32_t val[U];
        unsigned long long got[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t i = base + (int64_t)u * ZB_INSERT_THREADS;
          v[u] = i < hi && a.valid[i];
          key[u] = i < hi ? a.keys[i * a.key_stride] : 0;
          val[u] = i < hi ? a.vals[i] : 0;
          idx[u] = zb_hash(key[u], a.mask);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          got[u] = v[u] ? __ldcg(claims + idx[u]) : 0ull;
          held[u] = v[u] ? __ldcg(a.tkeys + idx[u]) : 0;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t i = base + (int64_t)u * ZB_INSERT_THREADS;
          if (i >= hi) continue;
          const bool won = v[u] && held[u] < 0 && got[u] == claim_tag(tag, i);
          if (won) {
            a.tkeys[idx[u]] = key[u];
            a.tvals[idx[u]] = val[u];
          } else if (v[u]) {
            to[atomicAdd(&count[cur ^ 1], 1u)] = make_int2((int)i, (int)((idx[u] + 1u) & a.mask));
            pending = true;
          }
          a.ok[i] = won;
        }
      }
    } else {
      for (int base = tid; base < len; base += STEP) {
        int2 w[U];
        int64_t key[U], held[U];
        int32_t val[U];
        unsigned long long got[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = base + u * ZB_INSERT_THREADS;
          w[u] = e < len ? from[e] : make_int2(-1, 0);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const bool on = w[u].x >= 0;
          got[u] = on ? __ldcg(claims + (uint32_t)w[u].y) : 0ull;
          held[u] = on ? __ldcg(a.tkeys + (uint32_t)w[u].y) : 0;
          key[u] = on ? a.keys[(int64_t)w[u].x * a.key_stride] : 0;
          val[u] = on ? a.vals[w[u].x] : 0;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (w[u].x < 0) continue;
          const uint32_t idx = (uint32_t)w[u].y;
          if (held[u] < 0 && got[u] == claim_tag(tag, w[u].x)) {
            a.tkeys[idx] = key[u];
            a.tvals[idx] = val[u];
            a.ok[w[u].x] = 1;
          } else {
            to[atomicAdd(&count[cur ^ 1], 1u)] = make_int2(w[u].x, (int)((idx + 1u) & a.mask));
            pending = true;
          }
        }
      }
    }
    // also orders this block's list writes before the next round reads them;
    // after the last round no block reads the slot (and one may have left)
    if (__syncthreads_or(pending) && tid < ZB_INSERT_BLOCKS && r + 1 < a.rounds) {
      tell[r % 3] = 1u;
    }
  }
  // no block touches another's shared memory after its last barrier
}

struct DeleteDesc {
  int64_t* tkeys;        // [T] the map's keys, updated in place
  const int64_t* keys;   // the delete's keys, key i at keys[i * key_stride]
  const uint8_t* valid;  // [n] bool
  int64_t key_stride;    // in elements
  uint32_t mask;         // T - 1, T a power of two
  int32_t n;             // keys
};

// The argument block of up to N deletes (the wrapper fills the largest;
// each launch passes the smallest that holds its deletes).
template <int N>
struct DeleteArgs {
  DeleteDesc d[N];
  int32_t start[N + 1];  // first block of each delete; [n_ops] = grid
  int32_t n_ops;
};

// The warp's 32 consecutive keys of delete ``d`` from key ``i0``.
__device__ __forceinline__ void delete_keys(const DeleteDesc& d, int64_t i0) {
  const int64_t i = i0 + (threadIdx.x & 31u);
  const bool v = i < d.n && d.valid[i];
  const uint32_t todo = __ballot_sync(ZB_FULL_WARP, v);
  if (todo == 0u) return;  // the whole warp: no valid key
  const int64_t key = v ? d.keys[i * d.key_stride] : 0;
  int64_t* const tkeys = d.tkeys;
  const uint32_t mask = d.mask;
  zb_window_walk<ZB_DELETE_GROUP, ZB_MAX_PROBES>(
      tkeys, mask, todo, key, [mask](int64_t k) { return zb_hash(k, mask); },
      [tkeys](int, int64_t slot) {
        if (slot >= 0) tkeys[slot] = ZB_TOMBSTONE;
      });
}

template <int N>
__global__ void __launch_bounds__(ZB_DELETE_THREADS)
hash_delete_kernel(const __grid_constant__ DeleteArgs<N> a) {
  const int b = (int)blockIdx.x;
  int p = 0;
#pragma unroll
  for (int k = 1; k < N; ++k) {
    if (k < a.n_ops && b >= a.start[k]) p = k;
  }
  const int warp_key = (int)(threadIdx.x & ~31u);
  // one inlined copy of the walk per descriptor, each at a constant index
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k == p) delete_keys(a.d[k], (int64_t)(b - a.start[k]) * ZB_DELETE_THREADS + warp_key);
  }
}

static int valid_size(int64_t tsize) {
  return tsize > 0 && (tsize & (tsize - 1)) == 0 && tsize <= (1LL << 32);
}

// ZB_INSERT_BLOCKS = 16 is above the portable cluster size of 8: the
// kernel is allowed it once per device. Returns a CUDA error, 0 on success.
static int allow_cluster_size() {
  static int done[64];  // per device ordinal: 1 once the attribute is set
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err || (dev < 64 && done[dev])) return err;
  err = (int)cudaFuncSetAttribute(hash_insert_kernel,
                                  cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (!err && dev < 64) done[dev] = 1;
  return err;
}

// Inserts the keys of ``args`` into its table in place: one launch of one
// cluster on ``stream``. ``claims``, ``epoch`` and the ``rounds`` epochs
// after it follow the claim-scratch contract above; ``work`` is scratch of
// 2 * ZB_INSERT_BLOCKS * share pairs. Returns the launches enqueued (1, or
// 0 without keys), or minus a CUDA error.
extern "C" int zb_hash_insert(const InsertArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  if (args->rounds < 1 || args->rounds > ZB_MAX_PROBES || args->share < 1 ||
      (int64_t)args->share * ZB_INSERT_BLOCKS < args->n) {
    return -(int)cudaErrorInvalidValue;
  }
  const int allowed = allow_cluster_size();
  if (allowed) return -allowed;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ZB_INSERT_BLOCKS);
  cfg.blockDim = dim3(ZB_INSERT_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ZB_INSERT_BLOCKS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int err = (int)cudaLaunchKernelEx(&cfg, hash_insert_kernel, *args);
  if (!err) err = (int)cudaGetLastError();
  return err ? -err : 1;
}

template <int N>
static int launch_delete(const DeleteArgs<ZB_MAX_DELETES>* args, int blocks,
                         cudaStream_t stream) {
  DeleteArgs<N> a;
  for (int p = 0; p < args->n_ops; ++p) {
    a.d[p] = args->d[p];
    a.start[p] = args->start[p];
  }
  a.start[args->n_ops] = blocks;
  a.n_ops = args->n_ops;
  hash_delete_kernel<N><<<(unsigned)blocks, ZB_DELETE_THREADS, 0, stream>>>(a);
  const int err = (int)cudaGetLastError();
  return err ? -err : 1;
}

// Deletes the planned keys from their tables in place, one launch on
// ``stream``. Returns the launches enqueued (1, or 0 when the plan has no
// block), or minus a CUDA error.
extern "C" int zb_hash_delete(const DeleteArgs<ZB_MAX_DELETES>* args, void* stream) {
  const int n = args->n_ops;
  if (n <= 0 || n > ZB_MAX_DELETES) return -(int)cudaErrorInvalidValue;
  for (int p = 0; p < n; ++p) {
    if (!valid_size((int64_t)args->d[p].mask + 1)) return -(int)cudaErrorInvalidValue;
  }
  const int blocks = args->start[n];
  if (blocks <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 1) return launch_delete<1>(args, blocks, s);
  if (n == 2) return launch_delete<2>(args, blocks, s);
  if (n <= 4) return launch_delete<4>(args, blocks, s);
  return launch_delete<ZB_MAX_DELETES>(args, blocks, s);
}
