// crush_do_rule over a batch of placement inputs on Hopper (sm_90a), for
// the rules and maps placement/bulk.py's CompiledMap accepts: straw2
// buckets, no local retries, take -> choose|chooseleaf firstn|indep -> emit.
//
// Replaces the XLA program of ceph_tpu/placement/bulk.py::_jit_engine
// (_choose_firstn_vec, _choose_indep_vec, _descend, _is_out; entered
// through do_rule_bulk). That engine ran every lane in lockstep: a masked
// descent unrolled over the map's depth, lax.while_loops with per-lane
// masks for the retries, one-hot table lookups. A GPU thread has its own
// control flow, so here one thread takes one x and runs the C's own loop
// order (CrushMap._choose_firstn and _choose_indep with the chooseleaf
// recursion, mapper.c:438, :633), reading the dense arrays of the
// CompiledMap. Nothing per lane goes to device memory but the output row.
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
// Bound: operations: every attempt is a descent of one straw2 choose per
// level, a draw (~170 integer-ALU instructions with its 64-bit division,
// crush_common.cuh) per slot of the bucket.
// Buckets are small and read by every thread, so they stay in L1/L2; the
// ln tables sit in shared memory. The per-thread out/out2 arrays hold at
// most kMaxRep entries (compile_rule refuses more).
#include <cuda_runtime.h>

#include "crush_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRep = 256;  // rs codecs take k + m <= 256
constexpr int32_t kItemNone = 0x7fffffff;
constexpr int32_t kItemUndef = 0x7ffffffe;

struct Rule {
  int root_bno, firstn, leaf, numrep, choose_type, tries, recurse_tries,
      vary_r, stable, max_depth, nb, mi, nw;
};

struct Map {
  const int32_t* items;    // (nb, mi)
  const uint32_t* weights; // (nb, mi), 16.16
  const int32_t* sizes;    // (nb,)
  const int32_t* btype;    // (nb,)
  const uint32_t* devw;    // (nw,) reweights, 16.16
  const int64_t* tbl;      // the ln tables, in shared memory
  unsigned long long* draws;  // nullable: the launch's straw2 draw count
  unsigned long long drawn;   // this thread's draws so far
  Rule rule;
};

__device__ __forceinline__ int item_type(const Map& m, int32_t item) {
  if (item >= 0) return 0;
  const int b = min(max(-1 - item, 0), m.rule.nb - 1);
  return m.btype[b];
}

// bucket_straw2_choose over row bno (size >= 1), first wins on ties.
__device__ int32_t bucket_choose(Map& m, int bno, uint32_t x, uint32_t r) {
  const int n = m.sizes[bno];
  m.drawn += (unsigned long long)n;
  const int32_t* it = m.items + (long long)bno * m.rule.mi;
  const uint32_t* w = m.weights + (long long)bno * m.rule.mi;
  int high = 0;
  int64_t best = 0;
  for (int i = 0; i < n; ++i) {
    const int64_t d = crush::straw2_draw(x, (uint32_t)it[i], r, w[i], m.tbl);
    if (i == 0 || d > best) {
      high = i;
      best = d;
    }
  }
  return it[high];
}

// From bucket row bno down to an item of type target; false rejects.
__device__ bool descend(Map& m, int bno, uint32_t x, uint32_t r,
                        int target, int32_t* found) {
  for (int depth = 0; depth < m.rule.max_depth; ++depth) {
    if (m.sizes[bno] == 0) return false;
    const int32_t item = bucket_choose(m, bno, x, r);
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

// chooseleaf firstn: one leaf under bucket item `host` for rank pos.
__device__ bool leaf_firstn(Map& m, int32_t host, uint32_t x,
                            uint32_t r, int pos, const int32_t* out2,
                            int32_t* leaf) {
  const Rule& R = m.rule;
  uint32_t sub_r = 0;
  if (R.vary_r) sub_r = (R.vary_r - 1) >= 32 ? 0u : r >> (R.vary_r - 1);
  const uint32_t base = R.stable ? sub_r : (uint32_t)pos + sub_r;
  for (int ft2 = 0; ft2 < R.recurse_tries; ++ft2) {
    int32_t cand;
    if (!descend(m, -1 - host, x, base + (uint32_t)ft2, 0, &cand)) continue;
    bool collide = false;
    for (int i = 0; i < pos; ++i) collide |= out2[i] == cand;
    if (collide || is_out(m, cand, x)) continue;
    *leaf = cand;
    return true;
  }
  return false;
}

// chooseleaf indep: one leaf under bucket item `host` for position rep.
__device__ bool leaf_indep(Map& m, int32_t host, uint32_t x,
                           uint32_t r, int rep, int32_t* leaf) {
  const Rule& R = m.rule;
  for (int ft2 = 0; ft2 < R.recurse_tries; ++ft2) {
    const uint32_t r2 = (uint32_t)rep + r + (uint32_t)(R.numrep * ft2);
    int32_t cand;
    if (!descend(m, -1 - host, x, r2, 0, &cand)) continue;
    if (is_out(m, cand, x)) continue;
    *leaf = cand;
    return true;
  }
  return false;
}

__device__ void choose_firstn(Map& m, uint32_t x, int32_t* out,
                              int32_t* out2) {
  const Rule& R = m.rule;
  int pos = 0;
  for (int rep = 0; rep < R.numrep && pos < R.numrep; ++rep) {
    for (int ftotal = 0; ftotal < R.tries; ++ftotal) {
      const uint32_t r = (uint32_t)(rep + ftotal);
      int32_t item;
      if (!descend(m, R.root_bno, x, r, R.choose_type, &item)) continue;
      bool collide = false;
      for (int i = 0; i < pos; ++i) collide |= out[i] == item;
      if (collide) continue;
      int32_t leaf = item;
      if (R.leaf && item < 0 && !leaf_firstn(m, item, x, r, pos, out2, &leaf))
        continue;
      if (R.choose_type == 0 && is_out(m, item, x)) continue;
      out[pos] = item;
      out2[pos] = leaf;
      ++pos;
      break;
    }
  }
  for (int i = pos; i < R.numrep; ++i) out[i] = out2[i] = kItemNone;
}

__device__ void choose_indep(Map& m, uint32_t x, int32_t* out,
                             int32_t* out2) {
  const Rule& R = m.rule;
  for (int i = 0; i < R.numrep; ++i) out[i] = out2[i] = kItemUndef;
  int left = R.numrep;
  for (int ftotal = 0; left > 0 && ftotal < R.tries; ++ftotal) {
    for (int rep = 0; rep < R.numrep; ++rep) {
      if (out[rep] != kItemUndef) continue;
      const uint32_t r = (uint32_t)rep + (uint32_t)(R.numrep * ftotal);
      int32_t item;
      if (!descend(m, R.root_bno, x, r, R.choose_type, &item)) continue;
      bool collide = false;
      for (int i = 0; i < R.numrep; ++i) collide |= out[i] == item;
      if (collide) continue;
      int32_t leaf = item;
      if (R.leaf && item < 0 && !leaf_indep(m, item, x, r, rep, &leaf))
        continue;
      if (R.choose_type == 0 && is_out(m, item, x)) continue;
      out[rep] = item;
      out2[rep] = leaf;
      --left;
    }
  }
  for (int i = 0; i < R.numrep; ++i) {
    if (out[i] == kItemUndef) out[i] = kItemNone;
    if (out2[i] == kItemUndef) out2[i] = kItemNone;
  }
}

__global__ void __launch_bounds__(kThreads)
crush_rule_kernel(Map m, const uint32_t* __restrict__ xs, long long nx,
                  const int64_t* __restrict__ tables,
                  int32_t* __restrict__ rows) {
  __shared__ int64_t s_tbl[crush::kTables];
  crush::stage_tables(s_tbl, tables);
  __syncthreads();
  const long long gi = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (gi >= nx) return;
  m.tbl = s_tbl;
  m.drawn = 0;
  int32_t out[kMaxRep], out2[kMaxRep];
  const uint32_t x = xs[gi];
  if (m.rule.firstn)
    choose_firstn(m, x, out, out2);
  else
    choose_indep(m, x, out, out2);
  const int32_t* res = m.rule.leaf ? out2 : out;
  int32_t* row = rows + gi * m.rule.numrep;
  for (int i = 0; i < m.rule.numrep; ++i) row[i] = res[i];
  if (m.draws) atomicAdd(m.draws, m.drawn);
}

}  // namespace

// params: the 13 ints of Rule, in its order, in host memory. draws:
// null, or one zeroed uint64 on the card that receives the number of
// straw2 draws the launch made (the data-dependent work, for its bound).
extern "C" int crush_rule_launch(const void* items, const void* weights,
                                 const void* sizes, const void* btype,
                                 const void* devw, const void* xs,
                                 long long nx, const void* tables, void* rows,
                                 const int* params, void* draws,
                                 void* stream) {
  Map m;
  const int* p = params;
  m.rule = Rule{p[0], p[1], p[2], p[3], p[4], p[5], p[6],
                p[7], p[8], p[9], p[10], p[11], p[12]};
  const Rule& R = m.rule;
  if (nx < 0 || R.numrep < 1 || R.numrep > kMaxRep || R.nb < 1 || R.mi < 1 ||
      R.root_bno < 0 || R.root_bno >= R.nb || R.nw < 0 || R.max_depth < 0 ||
      R.vary_r < 0)
    return (int)cudaErrorInvalidValue;
  if (nx == 0) return (int)cudaSuccess;
  const long long blocks = (nx + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  m.items = static_cast<const int32_t*>(items);
  m.weights = static_cast<const uint32_t*>(weights);
  m.sizes = static_cast<const int32_t*>(sizes);
  m.btype = static_cast<const int32_t*>(btype);
  m.devw = static_cast<const uint32_t*>(devw);
  m.tbl = nullptr;
  m.draws = static_cast<unsigned long long*>(draws);
  m.drawn = 0;
  crush_rule_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      m, static_cast<const uint32_t*>(xs), nx,
      static_cast<const int64_t*>(tables), static_cast<int32_t*>(rows));
  return (int)cudaGetLastError();
}
