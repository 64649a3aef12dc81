// Batched seed-0 CRC32C (Castagnoli, reflected poly 0x82F63B78) on Hopper's
// binary tensor cores (sm_90a), over cells where they lie.
//
// Replaces the Pallas kernel ceph_tpu/ops/crc32c.py::crc32c_words_pallas
// (and computes the same function as the XLA tree fold _crc0_words that
// the JAX write path calls): out[n] = crc32c(state 0, blob n) for blobs of W
// little-endian uint32 words. The seed folds in on the host
// (crc(seed, blob) = Z_len(seed) ^ crc0(blob)).
//
// The product. CRC from state 0 is linear over GF(2): the crc0 of a segment
// of S words is XOR over (word i, bit j) of bit j of word i times the column
// Z_{4(S-1-i)}(A_j) (ceph_tpu/ops/crc32c.py::_crc_bitmatrix for one
// segment). So segment CRCs are one GF(2) product (segments, 32S) x
// (32S, 32), and
//
//   mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc
//
// takes the packed words as its A operand as they are: a K-step is 8 words,
// with no bit-plane unpack (the cost that sank the TPU's MXU version). The
// output bit is the low bit of the popcount sum.
//
// Rows, K order, loads. One A row is one (blob, segment) pair; a block
// takes 256 rows at a time (8 warps x 2 m-tiles x 16 rows), i.e. one blob
// of 256 segments or several short blobs. K runs over chunks of 32 words:
// lane t of a group loads words 8t..8t+3 and 8t+4..8t+7 of the chunk as two
// 16 B loads, and K-step kk of the chunk takes word 8t+4h+kk for fragment
// half h. The host builds B in exactly that order (ops/crc32c.py
// b1_fragments), so each warp load is eight 128 B runs. N order: column n
// of n-tile j is crc bit 8(n >> 1) + 2j + (n & 1), so lane t of a group
// holds one byte of its row's CRC; one funnel shift per bit packs it and
// two shuffles join the four bytes.
//
// Joining. A row covers `subs` segments of S words, joined in the row with
// crc = Z_{4S}(crc) ^ next; a blob's nseg rows are joined in log2(nseg)
// levels with crc(L || R) = Z_|R|(crc(L)) ^ crc(R), 32-column GF(2)
// operators from the host (zcols). W that does not fill nseg * subs * S
// words is front-padded with zero words in the index math (neutral from
// state 0). B (S/32 x 4 KiB, 64 KiB at S = 512) sits in shared memory and
// blocks are persistent, so it is loaded once per block.
//
// Two sources. Blob n = b * (rows0 + rows1) + c is row c of stripe b of the
// first source (c < rows0, a (B, rows0, W) array) or row c - rows0 of the
// second ((B, rows1, W)), and its CRC goes to out[n]: the write step hands
// data and parity cells as they lie and gets (B, k+m) CRCs, with no copy.
//
// Bound: each input word is read once and each output written once. Write
// step of the main path, 2,816 cells of 512 KiB: 1.48 GB, 0.441 ms at
// 3.35 TB/s (H100 SXM); 2,048 rebuilt cells 0.32 ms; Checksummer pass of
// 16,384 x 64 KiB 0.32 ms. MMAs: one per 32 words (11.5 M at the write
// shape); ALU work per word is a fraction of an op (the pack and joins run
// once per row), so the kernel is meant to be bound by its loads.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // rows per block step: 8 warps x 32 rows
constexpr int kWarps = kThreads / 32;
constexpr int kLevels = 8;     // log2(kThreads): most join levels
constexpr int kMaxSeg = 512;   // most words per segment (64 KiB of B)
constexpr int kChunkFrags = 4 * 4 * 32;  // uint2 fragments per 32-word chunk

__device__ __forceinline__ void mma_b1(uint32_t (&d)[4], const uint32_t (&a)[4],
                                       uint2 b) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ uint32_t apply_cols(const uint32_t* cols,
                                               uint32_t x) {
  uint32_t acc = 0u;
#pragma unroll
  for (int b = 0; b < 32; ++b) acc ^= cols[b] & (0u - ((x >> b) & 1u));
  return acc;
}

template <bool VEC>
__device__ __forceinline__ uint4 load4(const uint32_t* row, long long pos) {
  if (row == nullptr) return make_uint4(0u, 0u, 0u, 0u);
  if (VEC)
    return pos >= 0 ? __ldg(reinterpret_cast<const uint4*>(row + pos))
                    : make_uint4(0u, 0u, 0u, 0u);
  uint32_t v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = pos + i >= 0 ? __ldg(row + pos + i) : 0u;
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t lane_of(const uint4& u, int kk) {
  return kk == 0 ? u.x : kk == 1 ? u.y : kk == 2 ? u.z : u.w;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
crc_b1_kernel(const uint32_t* __restrict__ src0, int rows0,
              const uint32_t* __restrict__ src1, int rows1,
              uint32_t* __restrict__ out, const uint2* __restrict__ frags_g,
              const uint32_t* __restrict__ zcols, long long n_blobs,
              long long w, int seg, int subs, int log_nseg, long long groups) {
  extern __shared__ uint2 frags[];
  __shared__ uint32_t z[(kLevels + 1) * 32];
  __shared__ uint32_t part[kThreads];
  const int nfrags = seg / 32 * kChunkFrags;
  for (int i = threadIdx.x; i < nfrags; i += kThreads) frags[i] = frags_g[i];
  for (int i = threadIdx.x; i < (kLevels + 1) * 32; i += kThreads) z[i] = zcols[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nseg = 1 << log_nseg;
  const int cells = rows0 + rows1;
  const long long row_words = (long long)subs * seg;
  const long long pad = (long long)nseg * row_words - w;
  const int chunks = seg / 32;
  for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const uint32_t* rp[2][2];  // [m-tile][row g / g+8] blob base, or null
    long long start[2][2];     // word of the blob where the row starts
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long row = grp * kThreads + warp * 32 + mt * 16 + hh * 8 + g;
        const long long blob = row >> log_nseg;
        const long long sidx = row & (nseg - 1);
        const long long b = blob / cells;
        const int c = (int)(blob - b * cells);
        rp[mt][hh] = blob >= n_blobs ? nullptr
                     : c < rows0 ? src0 + (b * rows0 + c) * w
                                 : src1 + (b * rows1 + c - rows0) * w;
        start[mt][hh] = sidx * row_words - pad + 8 * t;
      }
    uint32_t crc[2][2] = {};
    for (int l = 0; l < subs; ++l) {
      uint32_t acc[2][4][4] = {};  // [m-tile][n-tile][fragment]
      for (int ch = 0; ch < chunks; ++ch) {
        uint4 u[2][2][2];  // [m-tile][row g / g+8][half h]
        const long long off = (long long)l * seg + 32 * ch;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              u[mt][hh][h] = load4<VEC>(rp[mt][hh], start[mt][hh] + off + 4 * h);
        const uint2* f = frags + ch * kChunkFrags + lane;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            a[mt][0] = lane_of(u[mt][0][0], kk);
            a[mt][1] = lane_of(u[mt][1][0], kk);
            a[mt][2] = lane_of(u[mt][0][1], kk);
            a[mt][3] = lane_of(u[mt][1][1], kk);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint2 bb = f[(kk * 4 + j) * 32];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) mma_b1(acc[mt][j], a[mt], bb);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          uint32_t v = 0u;  // crc bits 8t + 2j + e land at 24 + 2j + e
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v = __funnelshift_r(v, acc[mt][j][2 * hh], 1);
            v = __funnelshift_r(v, acc[mt][j][2 * hh + 1], 1);
          }
          uint32_t sub = (v >> 24) << (8 * t);
          sub |= __shfl_xor_sync(0xffffffffu, sub, 1);
          sub |= __shfl_xor_sync(0xffffffffu, sub, 2);
          crc[mt][hh] = apply_cols(z, crc[mt][hh]) ^ sub;
        }
    }
    if (t == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          part[warp * 32 + mt * 16 + hh * 8 + g] = crc[mt][hh];
    }
    __syncthreads();
    for (int lvl = 0; lvl < log_nseg; ++lvl) {
      const int stride = 1 << lvl;
      if ((threadIdx.x & (2 * stride - 1)) == 0)
        part[threadIdx.x] = apply_cols(z + 32 * (lvl + 1), part[threadIdx.x]) ^
                            part[threadIdx.x + stride];
      __syncthreads();
    }
    if ((threadIdx.x & (nseg - 1)) == 0) {
      const long long blob = (grp * kThreads + threadIdx.x) >> log_nseg;
      if (blob < n_blobs) out[blob] = part[threadIdx.x];
    }
    __syncthreads();  // part[] is reused by the next group
  }
}

template <bool VEC>
cudaError_t launch(const uint32_t* src0, int rows0, const uint32_t* src1,
                   int rows1, uint32_t* out, const uint2* frags,
                   const uint32_t* zcols, long long n_blobs, long long w,
                   int seg, int subs, int log_nseg, cudaStream_t stream) {
  const auto kernel = crc_b1_kernel<VEC>;
  const int smem = seg / 32 * kChunkFrags * (int)sizeof(uint2);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSeg / 32 * kChunkFrags * (int)sizeof(uint2));
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long groups =
      ((n_blobs << log_nseg) + kThreads - 1) / kThreads;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > groups) blocks = groups;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      src0, rows0, src1, rows1, out, frags, zcols, n_blobs, w, seg, subs,
      log_nseg, groups);
  return cudaGetLastError();
}

}  // namespace

// Sources: src0 (batch, rows0, w) and, when rows1 > 0, src1 (batch, rows1, w)
// uint32, contiguous on the card; out (batch, rows0 + rows1) uint32. frags
// the B fragments (seg/32, 4, 4, 32, 2) and zcols (kLevels + 1, 32) the join
// operators Z_{4 seg}, Z_{4 seg subs 2^l} (l = 0..7), as ops/crc32c.py
// builds them for this w. seg is a multiple of 32 up to kMaxSeg, nseg =
// 2^log_nseg <= kThreads, and nseg * subs * seg >= w. Launches on
// `stream`, does not synchronise, returns the launch's cudaError_t (0 when
// it was accepted).
extern "C" int crc32c_launch(const void* src0, int rows0, const void* src1,
                             int rows1, long long batch, long long w,
                             void* out, const void* frags, const void* zcols,
                             int seg, int subs, int log_nseg, void* stream) {
  if (batch < 0 || w < 1 || rows0 < 1 || rows1 < 0 ||
      (rows1 > 0 && src1 == nullptr) || seg < 32 || seg > kMaxSeg ||
      seg % 32 != 0 || subs < 1 || log_nseg < 0 || log_nseg > kLevels ||
      ((long long)subs * seg << log_nseg) < w)
    return (int)cudaErrorInvalidValue;
  const long long n_blobs = batch * (rows0 + rows1);
  if (n_blobs == 0) return (int)cudaSuccess;
  const auto* s0 = static_cast<const uint32_t*>(src0);
  const auto* s1 = static_cast<const uint32_t*>(src1);
  auto* op = static_cast<uint32_t*>(out);
  const auto* fp = static_cast<const uint2*>(frags);
  const auto* zp = static_cast<const uint32_t*>(zcols);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(src0) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(src1) % 16 == 0;
  cudaError_t err =
      vec ? launch<true>(s0, rows0, s1, rows1, op, fp, zp, n_blobs, w, seg,
                         subs, log_nseg, s)
          : launch<false>(s0, rows0, s1, rows1, op, fp, zp, n_blobs, w, seg,
                          subs, log_nseg, s);
  return (int)err;
}
