// Bulk straw2 choose on Hopper (sm_90a): one bucket, one draw rank r, and
// for every placement input x the item whose straw is longest (first wins
// on ties, as bucket_straw2_choose, src/crush/mapper.c:339).
//
// Replaces the XLA program of ceph_tpu/ops/crush.py::straw2_choose (jitted
// as _jit_straw2, entered through straw2_bulk), which computed every
// (x, item) draw with one-hot table lookups (the TPU has no gather) and a
// float-reciprocal division. Here one thread takes one x and runs the C
// loop over the bucket: a gather from shared memory per table lookup, an
// exact 64-bit division per draw.
//
// Bound: operations on the integer ALUs. A draw is 172 of them in the
// SASS (most of them the Jenkins hash; the 64-by-64-bit division is a
// software routine, its 35 multiply-adds on the FMA pipe); a draw reads
// nothing from device memory, since the
// block stages the bucket's ids, items and weights (12 bytes a slot, in
// tiles of kTile slots: 12 KB at n = 1,000) and the ln tables (4 KB) into
// shared memory once. Every lane of a warp reads the same slot at once (a
// broadcast); the table reads are per lane.
#include <cuda_runtime.h>

#include "crush_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // bucket slots staged per pass: 24 KB

__global__ void __launch_bounds__(kThreads)
straw2_kernel(const int32_t* __restrict__ items,
              const int32_t* __restrict__ ids,
              const uint32_t* __restrict__ weights, int n,
              const uint32_t* __restrict__ xs, long long nx, uint32_t r,
              const int64_t* __restrict__ tables, int32_t* __restrict__ out) {
  __shared__ int64_t s_tbl[crush::kTables];
  __shared__ uint32_t s_ids[kTile];
  __shared__ uint32_t s_w[kTile];
  __shared__ int32_t s_items[kTile];
  const long long gi = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = gi < nx;
  const uint32_t x = live ? xs[gi] : 0u;
  crush::stage_tables(s_tbl, tables);
  int64_t best = 0;
  int32_t chosen = 0;
  for (int base = 0; base < n; base += kTile) {
    const int m = min(kTile, n - base);
    __syncthreads();  // the previous tile is read (and the tables staged)
    for (int j = threadIdx.x; j < m; j += kThreads) {
      s_ids[j] = (uint32_t)ids[base + j];
      s_w[j] = weights[base + j];
      s_items[j] = items[base + j];
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < m; ++j) {
        const int64_t d = crush::straw2_draw(x, s_ids[j], r, s_w[j], s_tbl);
        if (base + j == 0 || d > best) {
          best = d;
          chosen = s_items[j];
        }
      }
    }
  }
  if (live) out[gi] = chosen;
}

}  // namespace

extern "C" int straw2_launch(const void* items, const void* ids,
                             const void* weights, int n, const void* xs,
                             long long nx, unsigned int r, const void* tables,
                             void* out, void* stream) {
  if (n < 1 || nx < 0) return (int)cudaErrorInvalidValue;
  if (nx == 0) return (int)cudaSuccess;
  const long long blocks = (nx + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  straw2_kernel<<<(unsigned)blocks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(items), static_cast<const int32_t*>(ids),
      static_cast<const uint32_t*>(weights), n,
      static_cast<const uint32_t*>(xs), nx, r,
      static_cast<const int64_t*>(tables), static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
