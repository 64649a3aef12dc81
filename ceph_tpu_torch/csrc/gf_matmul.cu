// GF(2^8) matrix times packed byte streams on Hopper's binary tensor cores
// (sm_90a).
//
// Replaces the Pallas kernel ceph_tpu/ops/rs.py::_gf_pallas_raw (entered
// through gf_matmul_pallas): out[b, r, :] = XOR_c M[r, c] * x[b, c, :] over
// GF(2^8) (poly 0x11D), four bytes packed little-endian per uint32 word.
// GF(2^8) is linear over GF(2), so with BM = the lifted (8R, 8C) bit-matrix
// (ceph_tpu/ops/rs.py::_lift_bitmatrix) every output bit is a GF(2) inner
// product, and
//
//   mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc
//
// computes sum_k popc(a_k & b_k): its low bit is exactly that product.
//
// Operands. One A row is one word column w of one stripe b; its K bits are
// the raw input words x[b, c, w] of 8 inputs (8 x 32 = 256 bits), so A needs
// no unpacking or byte transpose at all. B is the lifted bit-matrix laid
// out block-diagonally over the 4 byte lanes of a word: output bit 8p+i of
// row r takes input bit 8p'+j of input c when p == p', with weight
// BM[8r+i, 8c+j]. This is _lift_bitmatrix_packed's idea (4 byte positions
// per pass). Reckoning for C = 8, per word column: the word form builds A
// with 0 ALU ops and spends 4x the tensor-core bit-work of the byte form;
// the byte form (one A row per byte position, K = 8C = 64 padded to 128 or
// 256) needs a 4x4 byte transpose (~2 PRMT per input word) and pads K by
// 2-4x anyway. Tensor-core work is the cheap side here (one MMA per word
// column at the write shape), ALU work is not: the word form wins.
//
// N order. The host chooses which output bit each B column stands for so
// that the accumulator fragment lands where the pack wants it. Output rows
// go in quads of 4; a quad is 16 n-tiles of 8 columns. Column n of n-tile j
// is output row 4q + (n >> 1), bit 2j + (n & 1). A thread (group g, lane t
// in group) receives columns 2t, 2t+1 of every n-tile: all 32 bits of
// output row 4q + t for its two A rows, in bit order as j runs 0..15. The
// pack is then one funnel shift per bit, v = (v >> 1) | (acc << 31): 32 ALU
// ops per output word, no shuffles, no shared memory. C > 8 takes more
// K-steps into the same accumulators (the parity of a sum of popcounts is
// the XOR of their parities). R not a multiple of 4 leaves a quad's spare
// rows zero in B and unstored.
//
// M order and loads. A warp walks chunks of 64 word columns of one stripe.
// Lane (g, t) loads 16 B of input t (and 4+t) at columns 4g..4g+3 and
// 32+4g..32+4g+3: m-tile i takes row g = column 4g+i and row g+8 = column
// 32+4g+i. Every warp load is four 128 B runs, and the same map sends each
// thread its four output words of one row as two 16 B stores. When W is not
// a multiple of 4 (or a pointer is not 16 B aligned) the same map runs on
// 4 B accesses; the ragged W edge is masked in the index math.
//
// B fragments sit in shared memory when they fit (R <= 12 at C <= 8; in
// general ceil(R/4) * ceil(C/8) * 4 KiB <= 48 KiB) and are read from device
// memory (L2) otherwise, so any 1 <= R, C <= 256 works. Any B >= 0, any
// W >= 1, 64-bit offsets; warps grid-stride over chunks.
//
// Bound, main path (B=256, k=8, m=3, W=131072, 512 KiB cells): 1.074 GB read
// + 0.403 GB written = 1.48 GB, 0.441 ms at 3.35 TB/s (H100 SXM); 0.64 ms
// at the 8x8 repair shape. ALU per word column: 32 per output word of each
// quad (128 at m=3, 256 at 8x8), against the ~220 and ~318 ops the memory
// bound leaves at 16.7 T int32 op/s; MMAs: ceil(R/4) * ceil(C/8) per
// column. At C <= 8 each warp keeps the next chunk's 2 KiB of loads in
// flight while it runs the current one (PERF.md has the times).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;               // word columns per warp step
constexpr int kFragWords = 16 * 32 * 2;  // one (quad, K-step) of B, uint32s
constexpr int kSmemLimit = 48 * 1024;

__device__ __forceinline__ void mma_b1(uint32_t (&d)[4], const uint32_t (&a)[4],
                                       uint2 b) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// A fragments of the 4 m-tiles of one chunk for the K-step of inputs
// c0..c0+7: a[i] = {x[c0+t][col 4g+i], x[c0+t][col 32+4g+i],
//                   x[c0+4+t][col 4g+i], x[c0+4+t][col 32+4g+i]}.
template <bool VEC>
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4],
                                       const uint32_t* __restrict__ xb,
                                       int cols, long long words,
                                       long long w0, int c0, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + 4 * h + t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long col = w0 + 32 * half + 4 * g;
      const int reg = 2 * h + half;
      const uint32_t* p = xb + (long long)c * words + col;
      if (VEC) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (c < cols && col < words) v = __ldg(reinterpret_cast<const uint4*>(p));
        a[0][reg] = v.x; a[1][reg] = v.y; a[2][reg] = v.z; a[3][reg] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i][reg] = (c < cols && col + i < words) ? __ldg(p + i) : 0u;
      }
    }
  }
}

// Stores the packed words v[i][half] of output row r (columns 4g+i and
// 32+4g+i of the chunk at w0).
template <bool VEC>
__device__ __forceinline__ void store_row(uint32_t* __restrict__ ob,
                                          const uint32_t (&v)[4][2], int r,
                                          long long words, long long w0,
                                          int g) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long col = w0 + 32 * half + 4 * g;
    uint32_t* p = ob + (long long)r * words + col;
    if (VEC) {
      if (col < words)
        *reinterpret_cast<uint4*>(p) =
            make_uint4(v[0][half], v[1][half], v[2][half], v[3][half]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (col + i < words) p[i] = v[i][half];
    }
  }
}

// Two blocks (16 warps) per SM: <= 128 registers a thread.
template <bool VEC, bool ONE_K>
__global__ void __launch_bounds__(kThreads, 2)
gf_b1_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
             const uint2* __restrict__ frags_global, int rows, int cols,
             long long words, long long chunks_per_b, long long chunks,
             int quads, int ksteps, int frags_in_smem) {
  extern __shared__ uint2 smem[];
  const uint2* frags = frags_global;
  if (frags_in_smem) {  // uniform over the block: kernel argument
    const int n = quads * ksteps * kFragWords / 2;
    for (int i = threadIdx.x; i < n; i += kThreads) smem[i] = frags_global[i];
    __syncthreads();
    frags = smem;
  }
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long nwarps = (long long)gridDim.x * kWarps;
  const long long first = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if constexpr (ONE_K) {
    // C <= 8 (the main path): one K-step, A loaded once per chunk, and the
    // next chunk's loads in flight while this one runs its MMAs.
    uint32_t a[4][4], an[4][4];
    if (first < chunks) {
      const long long b = first / chunks_per_b;
      load_a<VEC>(a, x + b * cols * words, cols, words,
                  (first - b * chunks_per_b) * kChunk, 0, g, t);
    }
    for (long long ch = first; ch < chunks; ch += nwarps) {
      const long long b = ch / chunks_per_b;
      const long long w0 = (ch - b * chunks_per_b) * kChunk;
      const long long nx = ch + nwarps;
      if (nx < chunks) {
        const long long nb = nx / chunks_per_b;
        load_a<VEC>(an, x + nb * cols * words, cols, words,
                    (nx - nb * chunks_per_b) * kChunk, 0, g, t);
      }
      uint32_t* ob = out + b * rows * words;
      for (int q = 0; q < quads; ++q) {
        uint32_t v[4][2] = {};
        const uint2* f = frags + q * 16 * 32 + lane;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const uint2 bb = f[j * 32];
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // bits 2j, 2j+1 of row 4q+t
            uint32_t acc[4] = {0u, 0u, 0u, 0u};
            mma_b1(acc, a[i], bb);
            v[i][0] = __funnelshift_r(v[i][0], acc[0], 1);
            v[i][0] = __funnelshift_r(v[i][0], acc[1], 1);
            v[i][1] = __funnelshift_r(v[i][1], acc[2], 1);
            v[i][1] = __funnelshift_r(v[i][1], acc[3], 1);
          }
        }
        if (4 * q + t < rows) store_row<VEC>(ob, v, 4 * q + t, words, w0, g);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[i][e] = an[i][e];
    }
  } else {
    // C > 8: K-steps accumulate before the parity is taken, four n-tiles
    // at a time; A is re-read for each group of n-tiles (from L1/L2).
    for (long long ch = first; ch < chunks; ch += nwarps) {
      const long long b = ch / chunks_per_b;
      const long long w0 = (ch - b * chunks_per_b) * kChunk;
      const uint32_t* xb = x + b * cols * words;
      uint32_t* ob = out + b * rows * words;
      for (int q = 0; q < quads; ++q) {
        uint32_t v[4][2] = {};
#pragma unroll
        for (int jc = 0; jc < 4; ++jc) {
          uint32_t acc[4][4][4] = {};  // [m-tile][n-tile in jc][fragment]
          for (int k = 0; k < ksteps; ++k) {
            uint32_t a[4][4];
            load_a<VEC>(a, xb, cols, words, w0, 8 * k, g, t);
            const uint2* f =
                frags + ((long long)(q * ksteps + k) * 16 + 4 * jc) * 32 + lane;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const uint2 bb = f[jj * 32];
#pragma unroll
              for (int i = 0; i < 4; ++i) mma_b1(acc[i][jj], a[i], bb);
            }
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int i = 0; i < 4; ++i) {  // bits 2j, 2j+1 of row 4q+t
              v[i][0] = __funnelshift_r(v[i][0], acc[i][jj][0], 1);
              v[i][0] = __funnelshift_r(v[i][0], acc[i][jj][1], 1);
              v[i][1] = __funnelshift_r(v[i][1], acc[i][jj][2], 1);
              v[i][1] = __funnelshift_r(v[i][1], acc[i][jj][3], 1);
            }
        }
        if (4 * q + t < rows) store_row<VEC>(ob, v, 4 * q + t, words, w0, g);
      }
    }
  }
}

template <bool VEC, bool ONE_K>
cudaError_t launch(const uint32_t* x, uint32_t* out, const uint2* frags,
                   int batch, int rows, int cols, long long words, int quads,
                   int ksteps, cudaStream_t stream) {
  const auto kernel = gf_b1_kernel<VEC, ONE_K>;
  const long long frag_bytes = (long long)quads * ksteps * kFragWords * 4;
  const int smem = frag_bytes <= kSmemLimit ? (int)frag_bytes : 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long chunks_per_b = (words + kChunk - 1) / kChunk;
  const long long chunks = (long long)batch * chunks_per_b;
  long long blocks = (chunks + kWarps - 1) / kWarps;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;  // warps grid-stride the rest
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, out, frags, rows, cols, words, chunks_per_b, chunks, quads, ksteps,
      smem > 0 ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// x (batch, cols, words) and out (batch, rows, words) uint32, frags the B
// fragments (ceil(rows/4), ceil(cols/8), 16, 32, 2) uint32 as
// ops/rs.py::b1_fragments builds them, all contiguous on the card.
// Launches on `stream`, does not synchronise, returns the launch's
// cudaError_t (0 when it was accepted).
extern "C" int gf_matmul_launch(const void* x, void* out, const void* frags,
                                int batch, int rows, int cols, long long words,
                                void* stream) {
  if (batch < 0 || rows < 1 || cols < 1 || rows > 256 || cols > 256 ||
      words < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || words == 0) return (int)cudaSuccess;
  const auto* xp = static_cast<const uint32_t*>(x);
  auto* op = static_cast<uint32_t*>(out);
  const auto* fp = static_cast<const uint2*>(frags);
  auto s = static_cast<cudaStream_t>(stream);
  const int quads = (rows + 3) / 4, ksteps = (cols + 7) / 8;
  const bool vec = words % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaError_t err;
  if (vec && ksteps == 1)
    err = launch<true, true>(xp, op, fp, batch, rows, cols, words, quads, ksteps, s);
  else if (vec)
    err = launch<true, false>(xp, op, fp, batch, rows, cols, words, quads, ksteps, s);
  else if (ksteps == 1)
    err = launch<false, true>(xp, op, fp, batch, rows, cols, words, quads, ksteps, s);
  else
    err = launch<false, false>(xp, op, fp, batch, rows, cols, words, quads, ksteps, s);
  return (int)err;
}
