// crush_do_rule over a batch of placement inputs on Hopper (sm_90a), for
// the rules and maps placement/bulk.py's CompiledMap accepts: straw2
// buckets, no local retries, take -> choose|chooseleaf firstn|indep -> emit.
//
// Replaces the XLA program of ceph_tpu/placement/bulk.py::_jit_engine
// (_choose_firstn_vec, _choose_indep_vec, _descend, _is_out; entered
// through do_rule_bulk). That engine ran every lane in lockstep: a masked
// descent unrolled over the map's depth, lax.while_loops with per-lane
// masks for the retries, one-hot table lookups. Here a group of G lanes
// of one warp (G a power of two <= 32, chosen per launch by the wrapper,
// bulk.py:group_width) carries one input x and runs the C's own loop
// order (CrushMap._choose_firstn and _choose_indep with the chooseleaf
// recursion, mapper.c:438, :633), reading the dense arrays of the
// CompiledMap. Any G gives the same rows and the same draw count.
//
// Semantics, as the engine and host oracle it is held to:
//  - firstn: replica rank rep, failure count ftotal, r = rep + ftotal;
//    the descent's item must not collide with out[0..pos); chooseleaf
//    recurses into it with r' = (stable ? 0 : pos) + (r >> (vary_r - 1))
//    + ft2 (sub_r 0 when vary_r is 0) for recurse_tries attempts, the leaf
//    checked against out2[0..pos) and the reweights; ftotal reaching
//    choose_tries skips the rank. Rows are compacted, ITEM_NONE at the
//    tail.
//  - indep: rounds ftotal < choose_tries over the ranks still ITEM_UNDEF,
//    r = rep + numrep * ftotal, collisions against the whole row, the
//    chooseleaf recursion with r2 = rep + r + numrep * ft2; ITEM_UNDEF
//    becomes ITEM_NONE. Rows are positional.
//  - an empty bucket rejects the attempt (bulk.py:235); a descent longer
//    than the map's depth, or one that meets a device above the choose
//    type (compile_rule refuses such maps), rejects it too;
//  - is_out: a device past the end of the reweight vector is out; a
//    reweight >= 0x10000 keeps it, 0 drops it, else hash32_2(x, item) &
//    0xffff >= w drops it. Items of a compiled map are always below its
//    max_devices, so the host's skip for larger items cannot arise.
//
// Bound: operations. Every attempt is a descent of one straw2 choose per
// level, a draw (~170 integer-ALU instructions with its 64-bit division,
// crush_common.cuh) per slot of the bucket; the draws an input needs are
// a serial chain of ranks and retries that depend on earlier results.
// One thread per input, the earlier design, walked that chain slot by
// slot: a 64-input batch was 64 threads on one SM running 841 draws each
// in a row (EC 8+3), the lanes of a warp diverged over 32 inputs'
// retries, and the rows sat in a 2 KB local-memory frame. With a group
// per input:
//  - bucket_choose spreads a bucket's slots over the group (lane j draws
//    slots j, j+G, ...; the group's loads of a bucket row coalesce) and
//    takes the best (draw, slot) in a shuffle reduction, the lower slot
//    winning ties as in the C's serial loop (an all-zero bucket draws
//    INT64_MIN everywhere and slot 0 wins); one attempt on a 50-host x
//    20-OSD tree is 3 rounds of 32 lanes instead of 70 draws in a row;
//  - everything else (ranks, retries, collisions, is_out, the depth
//    walk) is uniform in the group, so a warp of G = 32 never diverges
//    between inputs;
//  - the rows live in shared memory, slot i kept by lane i % G: a
//    collision test is one pass over a lane's own slots and __any_sync.
//    A lane reads and writes only the slots it keeps, so no slot crosses
//    lanes but through a shuffle (indep's "rank placed" test);
//  - the width trades latency for throughput. A batch the card holds
//    whole at one lane per slot of the widest bucket takes that G: the
//    shortest chain an input can have (64 inputs, EC 8+3: 0.05 ms of
//    H100 device time, against 1.2 ms at one thread an input). A batch
//    that fills the card takes G of about an eighth of the widest
//    bucket: on the 50 x 20 tree G = 8 packs a 50- and a 20-slot choose
//    into 7 + 3 rounds of 8 lanes (88% of the lanes drawing, against 73%
//    at G = 32) and shares each choose's reduction and the rank and
//    retry control among the 4 inputs of a warp. At 10 M inputs on an
//    H100 it was the fastest width for the EC rule and within 1.3% of
//    G = 4 for the replicated one (PERF.md, "K4 redesigned").
// Buckets are small and read by every group, so they stay in L1/L2; the
// ln tables sit in shared memory. The draw count is the work the inputs
// need: the bucket's size per choose, once per group, whatever G is.
#include <climits>
#include <cuda_runtime.h>

#include "crush_common.cuh"

namespace {

constexpr int kThreads = 128;  // most threads a block
constexpr int kMaxRep = 256;   // rs codecs take k + m <= 256
constexpr int kMaxGroup = 32;
// Shared memory for the groups' rows (out and out2, int32 each); with the
// 4 KB of ln tables a block stays under the 48 KB of static shared memory.
constexpr int kRowBytes = 40 * 1024;
constexpr int32_t kItemNone = 0x7fffffff;
constexpr int32_t kItemUndef = 0x7ffffffe;

struct Rule {
  int root_bno, firstn, leaf, numrep, choose_type, tries, recurse_tries,
      vary_r, stable, max_depth, nb, mi, nw, group;
};

struct Map {
  const int32_t* items;    // (nb, mi)
  const uint32_t* weights; // (nb, mi), 16.16
  const int32_t* sizes;    // (nb,)
  const int32_t* btype;    // (nb,)
  const uint32_t* devw;    // (nw,) reweights, 16.16
  const int64_t* tbl;      // the ln tables, in shared memory
  unsigned long long* draws;  // nullable: the launch's straw2 draw count
  unsigned long long drawn;   // this group's draws so far
  Rule rule;
};

// The G lanes of one warp that carry one input.
struct Group {
  int lane;       // 0..G-1
  int size;       // G
  unsigned mask;  // the group's lanes in its warp
};

__device__ __forceinline__ int item_type(const Map& m, int32_t item) {
  if (item >= 0) return 0;
  const int b = min(max(-1 - item, 0), m.rule.nb - 1);
  return m.btype[b];
}

// bucket_straw2_choose over row bno (size >= 1), first slot wins on ties.
__device__ int32_t bucket_choose(Map& m, const Group& g, int bno, uint32_t x,
                                 uint32_t r) {
  const int n = m.sizes[bno];
  m.drawn += (unsigned long long)n;
  const int32_t* it = m.items + (long long)bno * m.rule.mi;
  const uint32_t* w = m.weights + (long long)bno * m.rule.mi;
  int64_t best = crush::kInt64Min;
  int slot = INT_MAX;  // a lane with no slot loses every comparison
  for (int i = g.lane; i < n; i += g.size) {
    const int64_t d = crush::straw2_draw(x, (uint32_t)it[i], r, w[i], m.tbl);
    if (slot == INT_MAX || d > best) {
      best = d;
      slot = i;
    }
  }
  for (int off = g.size >> 1; off > 0; off >>= 1) {
    const int64_t ob = __shfl_xor_sync(g.mask, best, off);
    const int os = __shfl_xor_sync(g.mask, slot, off);
    if (ob > best || (ob == best && os < slot)) {
      best = ob;
      slot = os;
    }
  }
  return it[slot];
}

// From bucket row bno down to an item of type target; false rejects.
__device__ bool descend(Map& m, const Group& g, int bno, uint32_t x,
                        uint32_t r, int target, int32_t* found) {
  for (int depth = 0; depth < m.rule.max_depth; ++depth) {
    if (m.sizes[bno] == 0) return false;
    const int32_t item = bucket_choose(m, g, bno, x, r);
    if (item_type(m, item) == target) {
      *found = item;
      return true;
    }
    if (item >= 0) return false;
    bno = -1 - item;
  }
  return false;
}

__device__ __forceinline__ bool is_out(const Map& m, int32_t item,
                                       uint32_t x) {
  if (item >= m.rule.nw) return true;
  const uint32_t w = m.devw[item];
  if (w >= 0x10000u) return false;
  if (w == 0) return true;
  return (crush::hash32_2(x, (uint32_t)item) & 0xffffu) >= w;
}

// Whether item sits in row[0..n): each lane tests the slots it keeps.
__device__ __forceinline__ bool in_row(const Group& g, const int32_t* row,
                                       int n, int32_t item) {
  bool hit = false;
  for (int i = g.lane; i < n; i += g.size) hit |= row[i] == item;
  return __any_sync(g.mask, hit);
}

// row[i] = v, by the lane that keeps slot i.
__device__ __forceinline__ void put(const Group& g, int32_t* row, int i,
                                    int32_t v) {
  if ((i & (g.size - 1)) == g.lane) row[i] = v;
}

// row[i] in every lane of the group, read by the lane that keeps it.
__device__ __forceinline__ int32_t get(const Group& g, const int32_t* row,
                                       int i) {
  const int owner = i & (g.size - 1);
  return __shfl_sync(g.mask, g.lane == owner ? row[i] : 0, owner, g.size);
}

// chooseleaf firstn: one leaf under bucket item `host` for rank pos.
__device__ bool leaf_firstn(Map& m, const Group& g, int32_t host, uint32_t x,
                            uint32_t r, int pos, const int32_t* out2,
                            int32_t* leaf) {
  const Rule& R = m.rule;
  uint32_t sub_r = 0;
  if (R.vary_r) sub_r = (R.vary_r - 1) >= 32 ? 0u : r >> (R.vary_r - 1);
  const uint32_t base = R.stable ? sub_r : (uint32_t)pos + sub_r;
  for (int ft2 = 0; ft2 < R.recurse_tries; ++ft2) {
    int32_t cand;
    if (!descend(m, g, -1 - host, x, base + (uint32_t)ft2, 0, &cand))
      continue;
    if (in_row(g, out2, pos, cand) || is_out(m, cand, x)) continue;
    *leaf = cand;
    return true;
  }
  return false;
}

// chooseleaf indep: one leaf under bucket item `host` for position rep.
__device__ bool leaf_indep(Map& m, const Group& g, int32_t host, uint32_t x,
                           uint32_t r, int rep, int32_t* leaf) {
  const Rule& R = m.rule;
  for (int ft2 = 0; ft2 < R.recurse_tries; ++ft2) {
    const uint32_t r2 = (uint32_t)rep + r + (uint32_t)(R.numrep * ft2);
    int32_t cand;
    if (!descend(m, g, -1 - host, x, r2, 0, &cand)) continue;
    if (is_out(m, cand, x)) continue;
    *leaf = cand;
    return true;
  }
  return false;
}

__device__ void choose_firstn(Map& m, const Group& g, uint32_t x,
                              int32_t* out, int32_t* out2) {
  const Rule& R = m.rule;
  int pos = 0;
  for (int rep = 0; rep < R.numrep && pos < R.numrep; ++rep) {
    for (int ftotal = 0; ftotal < R.tries; ++ftotal) {
      const uint32_t r = (uint32_t)(rep + ftotal);
      int32_t item;
      if (!descend(m, g, R.root_bno, x, r, R.choose_type, &item)) continue;
      if (in_row(g, out, pos, item)) continue;
      int32_t leaf = item;
      if (R.leaf && item < 0 &&
          !leaf_firstn(m, g, item, x, r, pos, out2, &leaf))
        continue;
      if (R.choose_type == 0 && is_out(m, item, x)) continue;
      put(g, out, pos, item);
      put(g, out2, pos, leaf);
      ++pos;
      break;
    }
  }
  for (int i = g.lane; i < R.numrep; i += g.size)
    if (i >= pos) out[i] = out2[i] = kItemNone;
}

__device__ void choose_indep(Map& m, const Group& g, uint32_t x,
                             int32_t* out, int32_t* out2) {
  const Rule& R = m.rule;
  for (int i = g.lane; i < R.numrep; i += g.size)
    out[i] = out2[i] = kItemUndef;
  int left = R.numrep;
  for (int ftotal = 0; left > 0 && ftotal < R.tries; ++ftotal) {
    for (int rep = 0; rep < R.numrep; ++rep) {
      if (get(g, out, rep) != kItemUndef) continue;
      const uint32_t r = (uint32_t)rep + (uint32_t)(R.numrep * ftotal);
      int32_t item;
      if (!descend(m, g, R.root_bno, x, r, R.choose_type, &item)) continue;
      if (in_row(g, out, R.numrep, item)) continue;
      int32_t leaf = item;
      if (R.leaf && item < 0 && !leaf_indep(m, g, item, x, r, rep, &leaf))
        continue;
      if (R.choose_type == 0 && is_out(m, item, x)) continue;
      put(g, out, rep, item);
      put(g, out2, rep, leaf);
      --left;
    }
  }
  for (int i = g.lane; i < R.numrep; i += g.size) {
    if (out[i] == kItemUndef) out[i] = kItemNone;
    if (out2[i] == kItemUndef) out2[i] = kItemNone;
  }
}

__global__ void __launch_bounds__(kThreads)
crush_rule_kernel(Map m, const uint32_t* __restrict__ xs, long long nx,
                  const int64_t* __restrict__ tables,
                  int32_t* __restrict__ rows) {
  __shared__ int64_t s_tbl[crush::kTables];
  extern __shared__ int32_t s_rows[];  // (groups, 2, numrep)
  crush::stage_tables(s_tbl, tables);
  __syncthreads();
  const int G = m.rule.group;
  const int lg = __ffs(G) - 1;
  const int group = threadIdx.x >> lg;
  // a group past the end leaves whole: its lanes share one input
  const long long gi = (long long)blockIdx.x * (blockDim.x >> lg) + group;
  if (gi >= nx) return;
  Group g;
  g.lane = threadIdx.x & (G - 1);
  g.size = G;
  g.mask = G == kMaxGroup
               ? 0xffffffffu
               : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  m.tbl = s_tbl;
  m.drawn = 0;
  const int numrep = m.rule.numrep;
  int32_t* out = s_rows + (long long)group * 2 * numrep;
  int32_t* out2 = out + numrep;
  const uint32_t x = xs[gi];
  if (m.rule.firstn)
    choose_firstn(m, g, x, out, out2);
  else
    choose_indep(m, g, x, out, out2);
  const int32_t* res = m.rule.leaf ? out2 : out;
  int32_t* row = rows + gi * numrep;
  for (int i = g.lane; i < numrep; i += G) row[i] = res[i];
  if (m.draws && g.lane == 0) atomicAdd(m.draws, m.drawn);
}

}  // namespace

// params: the 14 ints of Rule, in its order, in host memory (group: the
// lanes an input takes, a power of two <= 32). draws: null, or one zeroed
// uint64 on the card that receives the number of straw2 draws the launch
// made (the data-dependent work, for its bound).
extern "C" int crush_rule_launch(const void* items, const void* weights,
                                 const void* sizes, const void* btype,
                                 const void* devw, const void* xs,
                                 long long nx, const void* tables, void* rows,
                                 const int* params, void* draws,
                                 void* stream) {
  Map m;
  const int* p = params;
  m.rule = Rule{p[0], p[1], p[2],  p[3],  p[4],  p[5],  p[6],
                p[7], p[8], p[9], p[10], p[11], p[12], p[13]};
  const Rule& R = m.rule;
  if (nx < 0 || R.numrep < 1 || R.numrep > kMaxRep || R.nb < 1 || R.mi < 1 ||
      R.root_bno < 0 || R.root_bno >= R.nb || R.nw < 0 || R.max_depth < 0 ||
      R.vary_r < 0 || R.group < 1 || R.group > kMaxGroup ||
      (R.group & (R.group - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (nx == 0) return (int)cudaSuccess;
  const int row_bytes = 2 * R.numrep * (int)sizeof(int32_t);
  const int groups = kThreads / R.group < kRowBytes / row_bytes
                         ? kThreads / R.group
                         : kRowBytes / row_bytes;
  const long long blocks = (nx + groups - 1) / groups;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  m.items = static_cast<const int32_t*>(items);
  m.weights = static_cast<const uint32_t*>(weights);
  m.sizes = static_cast<const int32_t*>(sizes);
  m.btype = static_cast<const int32_t*>(btype);
  m.devw = static_cast<const uint32_t*>(devw);
  m.tbl = nullptr;
  m.draws = static_cast<unsigned long long*>(draws);
  m.drawn = 0;
  crush_rule_kernel<<<(unsigned)blocks, groups * R.group,
                      (size_t)groups * row_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      m, static_cast<const uint32_t*>(xs), nx,
      static_cast<const int64_t*>(tables), static_cast<int32_t*>(rows));
  return (int)cudaGetLastError();
}
