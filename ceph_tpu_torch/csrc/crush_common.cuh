// Device functions shared by the CRUSH kernels (straw2.cu, crush_rule.cu):
// the Jenkins hashes of src/crush/hash.c, crush_ln of src/crush/mapper.c:226
// and the straw2 draw of mapper.c:313-337, on uint32_t/uint64_t, bit-exact
// against the port's C++ host core (native/ct_native.cc).
//
// crush_ln's tables (RH, LH: 129 entries each, LL: 256, all int64; 4 KB)
// come from the wrapper as one device array (ops/crush.py kernel_tables) and
// are staged into shared memory by each block: lanes index different
// entries, which constant memory would serialise.
#pragma once

#include <cstdint>

namespace crush {

constexpr uint32_t kHashSeed = 1315423911u;
// Offsets of RH, LH and LL in the table operand, and its length.
constexpr int kRH = 0, kLH = 129, kLL = 258, kTables = 514;
constexpr int64_t kInt64Min = -0x7fffffffffffffffll - 1;

__device__ __forceinline__ void hashmix(uint32_t& a, uint32_t& b,
                                        uint32_t& c) {
  a -= b; a -= c; a ^= c >> 13;
  b -= c; b -= a; b ^= a << 8;
  c -= a; c -= b; c ^= b >> 13;
  a -= b; a -= c; a ^= c >> 12;
  b -= c; b -= a; b ^= a << 16;
  c -= a; c -= b; c ^= b >> 5;
  a -= b; a -= c; a ^= c >> 3;
  b -= c; b -= a; b ^= a << 10;
  c -= a; c -= b; c ^= b >> 15;
}

__device__ __forceinline__ uint32_t hash32_2(uint32_t a, uint32_t b) {
  uint32_t h = kHashSeed ^ a ^ b, x = 231232u, y = 1232u;
  hashmix(a, b, h);
  hashmix(x, a, h);
  hashmix(b, y, h);
  return h;
}

__device__ __forceinline__ uint32_t hash32_3(uint32_t a, uint32_t b,
                                             uint32_t c) {
  uint32_t h = kHashSeed ^ a ^ b ^ c, x = 231232u, y = 1232u;
  hashmix(a, b, h);
  hashmix(c, x, h);
  hashmix(y, a, h);
  hashmix(b, x, h);
  hashmix(y, c, h);
  return h;
}

// 2^44 * log2(u + 1), 16.44 fixed point, u < 2^16. The reference forms
// (int64_t)x * RH, which wraps at x == 0x10000 (signed overflow); the
// product is taken here in uint64_t, whose bits are the wrapped ones, and
// only bits 48..55 of it are used.
__device__ __forceinline__ int64_t crush_ln(uint32_t u, const int64_t* tbl) {
  uint32_t x = (u & 0xffffu) + 1u;
  int iexpon = 15;
  if (!(x & 0x18000u)) {
    const int bits = __clz(x & 0x1ffffu) - 16;
    x <<= bits;
    iexpon = 15 - bits;
  }
  const int i1 = (int)(x >> 8) - 128;
  const uint64_t prod = (uint64_t)x * (uint64_t)tbl[kRH + i1];
  const int i2 = (int)((prod >> 48) & 0xffu);
  return ((int64_t)iexpon << 44) + ((tbl[kLH + i1] + tbl[kLL + i2]) >> 4);
}

// (ln - 2^48) / w with C truncation; the numerator is never positive, so
// that is minus the exact 64-bit floor division of 2^48 - ln by w. A zero
// weight never wins.
__device__ __forceinline__ int64_t straw2_draw(uint32_t x, uint32_t id,
                                               uint32_t r, uint32_t w,
                                               const int64_t* tbl) {
  if (w == 0) return kInt64Min;
  const int64_t ln = crush_ln(hash32_3(x, id, r) & 0xffffu, tbl);
  return -(int64_t)(((1ull << 48) - (uint64_t)ln) / (uint64_t)w);
}

// Copy the table operand into shared memory (all threads of the block
// take part; the caller synchronises before reading it).
__device__ __forceinline__ void stage_tables(int64_t* s, const int64_t* g) {
  for (int i = threadIdx.x; i < kTables; i += blockDim.x) s[i] = g[i];
}

}  // namespace crush
