// XOR combine of the multi-device data plane (sm_90a): K6.
//
// GF(2^8) addition is XOR, and no reducer of a collective library has it
// (NCCL's are sum, prod, min, max and avg). The JAX package's mesh code
// gets its XOR combines from XLA inside shard_map; this file is the port's
// form of them, four elementwise passes over words of packed bytes, each
// on the card where the slot that runs it lives:
//
//   xor_fold           out[i] = XOR_j parts[j, i]                  (n, N) -> (N)
//     replaces ceph_tpu/parallel/shard_comm.py:88-91 (allgather's fold of
//     the gathered partials) and the scrub digest of __graft_entry__.py:74.
//   bit_planes         planes[b, i] = (x[i] >> b) & 1              (N) -> (32, N)
//     replaces shard_comm.py:95-96 (psum_bits' one-bit planes).
//   plane_parity_pack  out[i] = OR_b ((SUM_j planes[j, b, i]) & 1) << b
//                                                                  (n, 32, N) -> (N)
//     replaces shard_comm.py:98-100 (psum_bits' parity of the summed
//     planes, repacked).
//   crc_join           out[m] = seed ^ XOR_j Z_j(parts[j, m])      (w, M) -> (M)
//     replaces the cross-width levels of the XLA CRC tree
//     (ceph_tpu/ops/crc32c.py:158-170 as crc32c_cells_device :321 runs it
//     under a width-sharded mesh): the seed-0 CRCs of a cell's w segments,
//     each carried past the bytes after it by its 32 x 32 GF(2) operator
//     Z_j (given as 32 uint32 columns), XORed with the cell's seed term.
//
// Planes are one byte an element (e = 1), not the reference's int32: only
// the parity of a plane sum is read, and the parity of a byte sum is that
// of the whole sum, so the result is bit-exact while plane traffic drops to
// a quarter. plane_parity_pack takes the parity as the XOR of the low bits,
// which is (sum & 1) for any byte values and any n.
//
// Bound: bytes. Every entry reads each input word once and writes each
// output word once with a few integer operations per word (crc_join: 32
// AND/XOR pairs per segment word), so each is bound by device memory:
// xor_fold 4N(n+1) bytes, bit_planes 4N + 32N, plane_parity_pack
// 32Nn + 4N, crc_join 4M(w+1). At the collective repair shape (B = 256,
// R = 8, W = 131,072 words, mesh 2 x 4) one xor_fold of 4 partials of
// 128 x 8 x 131,072 words moves 2.5 GiB: 0.80 ms at 3.35 TB/s (H100 SXM).
//
// Design: one simple pass a launch. Neighbouring threads take neighbouring
// 16 B vectors (xor_fold, crc_join: 4 words; bit_planes and
// plane_parity_pack: 16 words, whose 32 planes are 16 B each) when the row
// length allows it and the pointers are 16 B aligned, else one word a
// thread; blocks grid-stride and the ragged tail is masked; offsets are
// 64-bit. crc_join keeps the w x 32 columns in shared memory. Fusing the
// fold into the copies that gather the partials is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // grid-stride beyond this
constexpr int kMaxSegments = 256;           // crc_join columns in smem

unsigned blocks_for(long long units) {
  long long b = (units + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (unsigned)(b > 0 ? b : 1);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

// ------------------------------------------------------------ xor_fold

__global__ void __launch_bounds__(kThreads)
xor_fold_vec(const uint4* __restrict__ parts, uint4* __restrict__ out, int n,
             long long nv) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < nv;
       i += (long long)gridDim.x * kThreads) {
    uint4 acc = parts[i];
    for (int j = 1; j < n; ++j) acc = xor4(acc, parts[(long long)j * nv + i]);
    out[i] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
xor_fold_word(const uint32_t* __restrict__ parts, uint32_t* __restrict__ out,
              int n, long long len) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < len;
       i += (long long)gridDim.x * kThreads) {
    uint32_t acc = parts[i];
    for (int j = 1; j < n; ++j) acc ^= parts[(long long)j * len + i];
    out[i] = acc;
  }
}

// ---------------------------------------------------------- bit_planes

// 16 words a thread: plane b of them is 16 bytes, byte t = bit b of word t.
__global__ void __launch_bounds__(kThreads)
bit_planes_vec(const uint4* __restrict__ x, uint4* __restrict__ planes,
               long long len) {
  const long long groups = len / 16;
  for (long long g = blockIdx.x * (long long)kThreads + threadIdx.x;
       g < groups; g += (long long)gridDim.x * kThreads) {
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = x[g * 4 + q];
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
#pragma unroll 4
    for (int b = 0; b < 32; ++b) {
      uint32_t o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        o[q] = ((w[4 * q] >> b) & 1u) | (((w[4 * q + 1] >> b) & 1u) << 8) |
               (((w[4 * q + 2] >> b) & 1u) << 16) |
               (((w[4 * q + 3] >> b) & 1u) << 24);
      planes[((long long)b * len) / 16 + g] = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bit_planes_word(const uint32_t* __restrict__ x, uint8_t* __restrict__ planes,
                long long len) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < len;
       i += (long long)gridDim.x * kThreads) {
    const uint32_t v = x[i];
    for (int b = 0; b < 32; ++b)
      planes[(long long)b * len + i] = (uint8_t)((v >> b) & 1u);
  }
}

// --------------------------------------------------- plane_parity_pack

__global__ void __launch_bounds__(kThreads)
plane_parity_pack_vec(const uint4* __restrict__ planes,
                      uint4* __restrict__ out, int n, long long len) {
  const long long groups = len / 16;
  const long long plane_v = len / 16;  // 16 B vectors in one plane
  for (long long g = blockIdx.x * (long long)kThreads + threadIdx.x;
       g < groups; g += (long long)gridDim.x * kThreads) {
    uint32_t o[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) o[t] = 0u;
    for (int b = 0; b < 32; ++b) {
      uint4 acc = make_uint4(0u, 0u, 0u, 0u);
      for (int j = 0; j < n; ++j)
        acc = xor4(acc, planes[((long long)j * 32 + b) * plane_v + g]);
      const uint32_t a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
      for (int t = 0; t < 16; ++t)
        o[t] |= ((a[t >> 2] >> (8 * (t & 3))) & 1u) << b;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      out[g * 4 + q] = make_uint4(o[4 * q], o[4 * q + 1], o[4 * q + 2],
                                  o[4 * q + 3]);
  }
}

__global__ void __launch_bounds__(kThreads)
plane_parity_pack_word(const uint8_t* __restrict__ planes,
                       uint32_t* __restrict__ out, int n, long long len) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < len;
       i += (long long)gridDim.x * kThreads) {
    uint32_t o = 0u;
    for (int b = 0; b < 32; ++b) {
      uint32_t bit = 0u;
      for (int j = 0; j < n; ++j)
        bit ^= planes[((long long)j * 32 + b) * len + i];
      o |= (bit & 1u) << b;
    }
    out[i] = o;
  }
}

// ------------------------------------------------------------ crc_join

__device__ __forceinline__ uint32_t apply_cols(const uint32_t* cols,
                                               uint32_t v) {
  uint32_t acc = 0u;
#pragma unroll
  for (int b = 0; b < 32; ++b) acc ^= cols[b] & (0u - ((v >> b) & 1u));
  return acc;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
crc_join_kernel(const uint32_t* __restrict__ parts,
                const uint32_t* __restrict__ zcols, uint32_t* __restrict__ out,
                int w, long long m, uint32_t seed) {
  __shared__ uint32_t cols[kMaxSegments * 32];
  for (int i = threadIdx.x; i < w * 32; i += kThreads) cols[i] = zcols[i];
  __syncthreads();
  const long long units = VEC ? m / 4 : m;
  for (long long u = blockIdx.x * (long long)kThreads + threadIdx.x;
       u < units; u += (long long)gridDim.x * kThreads) {
    if (VEC) {
      const uint4* p = reinterpret_cast<const uint4*>(parts);
      uint4 acc = make_uint4(seed, seed, seed, seed);
      for (int j = 0; j < w; ++j) {
        const uint4 v = p[(long long)j * units + u];
        const uint32_t* c = cols + j * 32;
        acc.x ^= apply_cols(c, v.x);
        acc.y ^= apply_cols(c, v.y);
        acc.z ^= apply_cols(c, v.z);
        acc.w ^= apply_cols(c, v.w);
      }
      reinterpret_cast<uint4*>(out)[u] = acc;
    } else {
      uint32_t acc = seed;
      for (int j = 0; j < w; ++j)
        acc ^= apply_cols(cols + j * 32, parts[(long long)j * m + u]);
      out[u] = acc;
    }
  }
}

}  // namespace

// Every entry: contiguous tensors on the card, the stream last. Launches
// on `stream`, does not synchronise, returns the launch's cudaError_t (0
// when it was accepted). Words are uint32 (the port's int32 tensors).

// parts (n, len) -> out (len).
extern "C" int xor_fold_launch(const void* parts, void* out, int n,
                               long long len, void* stream) {
  if (n < 1 || len < 0) return (int)cudaErrorInvalidValue;
  if (len == 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (len % 4 == 0 && aligned16(parts) && aligned16(out)) {
    xor_fold_vec<<<blocks_for(len / 4), kThreads, 0, s>>>(
        static_cast<const uint4*>(parts), static_cast<uint4*>(out), n,
        len / 4);
  } else {
    xor_fold_word<<<blocks_for(len), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(parts), static_cast<uint32_t*>(out), n,
        len);
  }
  return (int)cudaGetLastError();
}

// x (len) -> planes (32, len) uint8.
extern "C" int bit_planes_launch(const void* x, void* planes, long long len,
                                 void* stream) {
  if (len < 0) return (int)cudaErrorInvalidValue;
  if (len == 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (len % 16 == 0 && aligned16(x) && aligned16(planes)) {
    bit_planes_vec<<<blocks_for(len / 16), kThreads, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(planes), len);
  } else {
    bit_planes_word<<<blocks_for(len), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(x), static_cast<uint8_t*>(planes), len);
  }
  return (int)cudaGetLastError();
}

// planes (n, 32, len) uint8 -> out (len).
extern "C" int plane_parity_pack_launch(const void* planes, void* out, int n,
                                        long long len, void* stream) {
  if (n < 1 || len < 0) return (int)cudaErrorInvalidValue;
  if (len == 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (len % 16 == 0 && aligned16(planes) && aligned16(out)) {
    plane_parity_pack_vec<<<blocks_for(len / 16), kThreads, 0, s>>>(
        static_cast<const uint4*>(planes), static_cast<uint4*>(out), n, len);
  } else {
    plane_parity_pack_word<<<blocks_for(len), kThreads, 0, s>>>(
        static_cast<const uint8_t*>(planes), static_cast<uint32_t*>(out), n,
        len);
  }
  return (int)cudaGetLastError();
}

// parts (w, m) seed-0 segment CRCs, zcols (w, 32) columns -> out (m).
extern "C" int crc_join_launch(const void* parts, const void* zcols,
                               void* out, int w, long long m,
                               unsigned seed, void* stream) {
  if (w < 1 || w > kMaxSegments || m < 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint32_t*>(parts);
  const auto* z = static_cast<const uint32_t*>(zcols);
  auto* o = static_cast<uint32_t*>(out);
  if (m % 4 == 0 && aligned16(parts) && aligned16(out)) {
    crc_join_kernel<true><<<blocks_for(m / 4), kThreads, 0, s>>>(p, z, o, w,
                                                                  m, seed);
  } else {
    crc_join_kernel<false><<<blocks_for(m), kThreads, 0, s>>>(p, z, o, w, m,
                                                               seed);
  }
  return (int)cudaGetLastError();
}
