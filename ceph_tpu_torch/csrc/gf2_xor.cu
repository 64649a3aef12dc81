// GF(2) XOR schedule of the bitmatrix erasure codes (sm_90a).
//
// Replaces the jitted XLA function ceph_tpu/ops/gf2.py::gf2_apply (the
// device half of the blaum_roth, liberation, liber8tion and cauchy_bm
// encodes and decodes): for every stripe n and output packet row r,
//
//   out[n, r, :] = XOR over t of rows_ext[n, plan[r, t], :]
//
// where rows (N, C, L) holds the C input packet rows of a stripe (C = k*w
// for an encode, k'*w for a decode), plan (R, T) the gather indices the
// host lowered the binary matrix to (ops/gf2.py::xor_plan) and rows_ext is
// rows with one all-zero row appended at index C: a plan row shorter than
// T pads with C. Any index outside 0..C-1 reads as that zero row here, so
// a bad plan cannot read out of bounds.
//
// Bound: bytes. Each input word must be read once and each output word
// written once, (C + R) * L * 4 * N bytes, with no arithmetic but XOR (an
// output word costs T XORs, T <= C). At the full-width liber8tion k=8, m=2
// shape (N = 256, C = 64, R = 16, L = 16384 words) that is 1.34 GB, 0.40
// ms at 3.35 TB/s (H100 SXM).
//
// Design. An input word feeds every output row whose plan names its row,
// a few times over for the Q rows of a RAID6 code, so read from device
// memory once per use it would cost several times the bound. A block
// therefore takes one stripe's column slice of `tile` words (a power of
// two, as wide as 32 KiB of shared memory holds for C rows): its threads
// copy the C x tile slice into shared memory with coalesced loads (each
// input word leaves HBM once), then compute all R output rows of the
// slice from shared memory and store them coalesced. The plan sits in
// shared memory too when it takes at most 16 KiB (else it is read through
// L1, where every lane of a warp reads the same entry). Words go as 16 B
// vectors when L % 4 == 0, the pointers are 16 B aligned and C <= 2048
// (one vector a row fits), else as 4 B words, which take C <= 8192
// (kernels.GF2_MAX_ROWS); L may be any count, the ragged slice of a row is
// masked. Blocks grid-stride over (stripe, slice) pairs; 64-bit offsets
// throughout.
// Making it fast (overlapping one slice's loads with the last one's XORs,
// or a GF(2) product on the b1 tensor cores as csrc/gf_matmul.cu does) is
// later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBytes = 32 * 1024;  // shared memory for the input slice
constexpr int kPlanBytes = 16 * 1024;  // the most plan kept in shared memory
constexpr int kMaxLogTile = 10;        // at most 1024 units a slice

__device__ __forceinline__ uint32_t xor_words(uint32_t a, uint32_t b) {
  return a ^ b;
}

__device__ __forceinline__ uint4 xor_words(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

template <typename V>
__device__ __forceinline__ V zero_words();

template <>
__device__ __forceinline__ uint32_t zero_words<uint32_t>() {
  return 0u;
}

template <>
__device__ __forceinline__ uint4 zero_words<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}

// V is the unit a thread moves: uint4 (4 words) or uint32_t. `lv` is the
// row length in units, a slice is 1 << log_tile units.
template <typename V>
__global__ void __launch_bounds__(kThreads)
gf2_xor_kernel(const V* __restrict__ rows, V* __restrict__ out,
               const int32_t* __restrict__ plan, long long n, int c, int r,
               int terms, long long lv, int log_tile, int plan_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int plan_words = plan_in_smem ? (r * terms + 3) & ~3 : 0;
  int32_t* plan_s = reinterpret_cast<int32_t*>(smem);
  V* tile_s = reinterpret_cast<V*>(smem + plan_words * 4);
  if (plan_in_smem)
    for (int i = threadIdx.x; i < r * terms; i += kThreads) plan_s[i] = plan[i];
  const int32_t* pl = plan_in_smem ? plan_s : plan;

  const int tile = 1 << log_tile, mask = tile - 1;
  const long long per_row = (lv + tile - 1) >> log_tile;
  const long long total = n * per_row;
  for (long long blk = blockIdx.x; blk < total; blk += gridDim.x) {
    const long long s = blk / per_row;
    const long long l0 = (blk - s * per_row) << log_tile;
    const int width = (int)(lv - l0 < tile ? lv - l0 : tile);
    __syncthreads();  // the plan is in; the last slice's readers are done
    const V* src = rows + s * c * lv + l0;
    for (int i = threadIdx.x; i < (c << log_tile); i += kThreads) {
      const int j = i & mask;
      if (j < width) tile_s[i] = src[(long long)(i >> log_tile) * lv + j];
    }
    __syncthreads();
    V* dst = out + s * r * lv + l0;
    for (int i = threadIdx.x; i < (r << log_tile); i += kThreads) {
      const int j = i & mask;
      if (j >= width) continue;
      const int32_t* p = pl + (i >> log_tile) * terms;
      V acc = zero_words<V>();
      for (int t = 0; t < terms; ++t) {
        const int idx = p[t];
        if ((unsigned)idx < (unsigned)c)
          acc = xor_words(acc, tile_s[(idx << log_tile) + j]);
      }
      dst[(long long)(i >> log_tile) * lv + j] = acc;
    }
  }
}

template <typename V>
cudaError_t launch(const uint32_t* rows, uint32_t* out, const int32_t* plan,
                   long long n, int c, int r, int terms, long long l,
                   cudaStream_t stream) {
  constexpr int unit = sizeof(V) / 4;  // words a unit
  const long long lv = l / unit;
  int log_tile = 0;  // widest slice that fits, no wider than a row
  while (log_tile < kMaxLogTile && (1LL << log_tile) < lv &&
         (long long)c * (2LL << log_tile) * (long long)sizeof(V) <= kTileBytes)
    ++log_tile;
  if ((long long)c * (1LL << log_tile) * (long long)sizeof(V) > kTileBytes)
    return cudaErrorInvalidValue;  // C too large for one unit a row
  const long long plan_bytes = (long long)r * terms * 4;
  const int plan_in_smem = plan_bytes <= kPlanBytes ? 1 : 0;
  const int smem = (plan_in_smem ? (int)((plan_bytes + 15) & ~15LL) : 0) +
                   (int)((long long)c * sizeof(V) << log_tile);
  const auto kernel = gf2_xor_kernel<V>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long total = n * ((lv + (1LL << log_tile) - 1) >> log_tile);
  long long blocks = total;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;  // blocks grid-stride the rest
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      reinterpret_cast<const V*>(rows), reinterpret_cast<V*>(out), plan, n, c,
      r, terms, lv, log_tile, plan_in_smem);
  return cudaGetLastError();
}

}  // namespace

// rows (n, c, l) and out (n, r, l) uint32, plan (r, terms) int32, all
// contiguous on the card. Launches on `stream`, does not synchronise,
// returns the launch's cudaError_t (0 when it was accepted).
extern "C" int gf2_xor_launch(const void* rows, void* out, const void* plan,
                              long long n, int c, int r, int terms,
                              long long l, void* stream) {
  if (n < 0 || c < 0 || r < 0 || terms < 1 || l < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || r == 0 || l == 0) return (int)cudaSuccess;
  const auto* rp = static_cast<const uint32_t*>(rows);
  auto* op = static_cast<uint32_t*>(out);
  const auto* pp = static_cast<const int32_t*>(plan);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = l % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   (long long)c * 16 <= kTileBytes;
  cudaError_t err = vec ? launch<uint4>(rp, op, pp, n, c, r, terms, l, s)
                        : launch<uint32_t>(rp, op, pp, n, c, r, terms, l, s);
  return (int)err;
}
