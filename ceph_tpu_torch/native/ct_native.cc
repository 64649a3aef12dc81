// ceph_tpu native host core: GF(2^8) Reed-Solomon, CRC32C, CRUSH straw2.
//
// This is the C++ "jerasure role" of the framework (SURVEY.md §7): the
// bit-exactness oracle for the JAX/TPU kernels and the honest CPU baseline
// for bench.py's vs_baseline ratio. It replaces the reference's vendored
// math submodules (gf-complete/jerasure, ISA-L, crc32c asm — see
// SURVEY.md §2.4, empty in the reference checkout) with a self-contained
// implementation: scalar table paths everywhere, plus SSSE3/AVX2 nibble-
// shuffle GF multiply and SSE4.2 hardware CRC where the host supports
// them (runtime dispatch, same idea as ceph_choose_crc32,
// reference src/common/crc32c.cc:17-53).
//
// Flat extern "C" API consumed via ctypes from ceph_tpu.native; this file
// is ceph_tpu_torch's own copy of it, consumed from ceph_tpu_torch.native.

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#include <mutex>
#include <thread>
#include <vector>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

#include "crush_ln_tables.h"

extern "C" {

// ---------------------------------------------------------------- GF(2^8)

static const uint32_t GF_POLY = 0x11d;
static uint8_t gf_exp[512];
static uint8_t gf_log[256];
static uint8_t gf_mul_tbl[256][256];
static std::once_flag gf_once;

static void gf_init_impl() {
  uint32_t x = 1;
  for (int i = 0; i < 255; i++) {
    gf_exp[i] = (uint8_t)x;
    gf_log[x] = (uint8_t)i;
    x <<= 1;
    if (x & 0x100) x ^= GF_POLY;
  }
  for (int i = 255; i < 512; i++) gf_exp[i] = gf_exp[i - 255];
  for (int a = 1; a < 256; a++)
    for (int b = 1; b < 256; b++)
      gf_mul_tbl[a][b] = gf_exp[gf_log[a] + gf_log[b]];
}

static void gf_init() { std::call_once(gf_once, gf_init_impl); }

uint8_t ct_gf_mul(uint8_t a, uint8_t b) {
  gf_init();
  return gf_mul_tbl[a][b];
}

uint8_t ct_gf_inv(uint8_t a) {
  gf_init();
  return a ? gf_exp[255 - gf_log[a]] : 0;
}

static uint8_t gf_pow_i(int a, int n) {
  gf_init();
  if (n == 0) return 1;
  if (a == 0) return 0;
  return gf_exp[(gf_log[a] * n) % 255];
}

// Systematic Vandermonde RS coding matrix (m x k), same construction as
// ceph_tpu.ops.gf8.vandermonde_rs_matrix (reed_sol_van role).
int ct_rs_matrix_vandermonde(int k, int m, uint8_t* out) {
  gf_init();
  if (k + m > 256) return -1;
  int rows = k + m;
  std::vector<uint8_t> v((size_t)rows * k);
  for (int i = 0; i < rows; i++)
    for (int j = 0; j < k; j++) v[(size_t)i * k + j] = gf_pow_i(i, j);
  for (int col = 0; col < k; col++) {
    if (!v[(size_t)col * k + col]) {
      int c2 = col + 1;
      for (; c2 < k; c2++)
        if (v[(size_t)col * k + c2]) break;
      if (c2 == k) return -1;
      for (int r = 0; r < rows; r++) {
        uint8_t t = v[(size_t)r * k + col];
        v[(size_t)r * k + col] = v[(size_t)r * k + c2];
        v[(size_t)r * k + c2] = t;
      }
    }
    uint8_t inv = ct_gf_inv(v[(size_t)col * k + col]);
    for (int r = 0; r < rows; r++)
      v[(size_t)r * k + col] = gf_mul_tbl[inv][v[(size_t)r * k + col]];
    for (int c2 = 0; c2 < k; c2++) {
      if (c2 == col) continue;
      uint8_t f = v[(size_t)col * k + c2];
      if (!f) continue;
      for (int r = 0; r < rows; r++)
        v[(size_t)r * k + c2] ^= gf_mul_tbl[f][v[(size_t)r * k + col]];
    }
  }
  memcpy(out, v.data() + (size_t)k * k, (size_t)m * k);
  return 0;
}

int ct_rs_matrix_cauchy(int k, int m, uint8_t* out) {
  gf_init();
  if (k + m > 256) return -1;
  for (int i = 0; i < m; i++)
    for (int j = 0; j < k; j++) out[i * k + j] = ct_gf_inv((uint8_t)((i + k) ^ j));
  return 0;
}

// In-place Gauss-Jordan inverse of an n x n GF(2^8) matrix. 0 ok, -1 singular.
int ct_gf_matinv(uint8_t* m, int n) {
  gf_init();
  std::vector<uint8_t> aug((size_t)n * 2 * n, 0);
  for (int r = 0; r < n; r++) {
    memcpy(&aug[(size_t)r * 2 * n], m + (size_t)r * n, n);
    aug[(size_t)r * 2 * n + n + r] = 1;
  }
  for (int col = 0; col < n; col++) {
    int piv = -1;
    for (int r = col; r < n; r++)
      if (aug[(size_t)r * 2 * n + col]) { piv = r; break; }
    if (piv < 0) return -1;
    if (piv != col)
      for (int c = 0; c < 2 * n; c++) {
        uint8_t t = aug[(size_t)col * 2 * n + c];
        aug[(size_t)col * 2 * n + c] = aug[(size_t)piv * 2 * n + c];
        aug[(size_t)piv * 2 * n + c] = t;
      }
    uint8_t inv = ct_gf_inv(aug[(size_t)col * 2 * n + col]);
    for (int c = 0; c < 2 * n; c++)
      aug[(size_t)col * 2 * n + c] = gf_mul_tbl[inv][aug[(size_t)col * 2 * n + c]];
    for (int r = 0; r < n; r++) {
      if (r == col) continue;
      uint8_t f = aug[(size_t)r * 2 * n + col];
      if (!f) continue;
      for (int c = 0; c < 2 * n; c++)
        aug[(size_t)r * 2 * n + c] ^= gf_mul_tbl[f][aug[(size_t)col * 2 * n + c]];
    }
  }
  for (int r = 0; r < n; r++) memcpy(m + (size_t)r * n, &aug[(size_t)r * 2 * n + n], n);
  return 0;
}

// ------------------------------------------------ RS encode (data plane)

// Scalar region-multiply-accumulate: out ^= c * src bytewise.
static void gf_madd_scalar(uint8_t c, const uint8_t* src, uint8_t* out, size_t len) {
  if (c == 0) return;
  if (c == 1) {
    size_t i = 0;
    for (; i + 8 <= len; i += 8)
      *(uint64_t*)(out + i) ^= *(const uint64_t*)(src + i);
    for (; i < len; i++) out[i] ^= src[i];
    return;
  }
  const uint8_t* row = gf_mul_tbl[c];
  size_t i = 0;
  for (; i + 4 <= len; i += 4) {
    out[i] ^= row[src[i]];
    out[i + 1] ^= row[src[i + 1]];
    out[i + 2] ^= row[src[i + 2]];
    out[i + 3] ^= row[src[i + 3]];
  }
  for (; i < len; i++) out[i] ^= row[src[i]];
}

#if defined(__x86_64__)
// Nibble-table shuffle GF multiply (the standard SIMD technique the
// reference gets from gf-complete "split table w=8" / ISA-L).
__attribute__((target("avx2"))) static void gf_madd_avx2(
    uint8_t c, const uint8_t* src, uint8_t* out, size_t len) {
  uint8_t lo[16], hi[16];
  for (int n = 0; n < 16; n++) {
    lo[n] = gf_mul_tbl[c][n];
    hi[n] = gf_mul_tbl[c][n << 4];
  }
  __m256i vlo = _mm256_broadcastsi128_si256(_mm_loadu_si128((const __m128i*)lo));
  __m256i vhi = _mm256_broadcastsi128_si256(_mm_loadu_si128((const __m128i*)hi));
  __m256i mask = _mm256_set1_epi8(0x0f);
  size_t i = 0;
  for (; i + 32 <= len; i += 32) {
    __m256i x = _mm256_loadu_si256((const __m256i*)(src + i));
    __m256i l = _mm256_shuffle_epi8(vlo, _mm256_and_si256(x, mask));
    __m256i h = _mm256_shuffle_epi8(
        vhi, _mm256_and_si256(_mm256_srli_epi64(x, 4), mask));
    __m256i y = _mm256_xor_si256(l, h);
    __m256i o = _mm256_loadu_si256((const __m256i*)(out + i));
    _mm256_storeu_si256((__m256i*)(out + i), _mm256_xor_si256(o, y));
  }
  if (i < len) gf_madd_scalar(c, src + i, out + i, len - i);
}

__attribute__((target("avx2"))) static void gf_xor_avx2(
    const uint8_t* src, uint8_t* out, size_t len) {
  size_t i = 0;
  for (; i + 32 <= len; i += 32) {
    __m256i x = _mm256_loadu_si256((const __m256i*)(src + i));
    __m256i o = _mm256_loadu_si256((const __m256i*)(out + i));
    _mm256_storeu_si256((__m256i*)(out + i), _mm256_xor_si256(o, x));
  }
  for (; i < len; i++) out[i] ^= src[i];
}

static bool have_avx2() {
  static int v = -1;
  if (v < 0) v = __builtin_cpu_supports("avx2") ? 1 : 0;
  return v == 1;
}
#endif

static void gf_madd(uint8_t c, const uint8_t* src, uint8_t* out, size_t len) {
  if (c == 0) return;
#if defined(__x86_64__)
  if (have_avx2()) {
    if (c == 1)
      gf_xor_avx2(src, out, len);
    else
      gf_madd_avx2(c, src, out, len);
    return;
  }
#endif
  gf_madd_scalar(c, src, out, len);
}

// out (rows, len) = matrix (rows, k) * data (k, len) over GF(2^8).
// Contiguous row-major buffers; this is the encode_chunks /
// decode_chunks data-plane primitive (ErasureCodeInterface.h:370,411).
void ct_rs_matmul(const uint8_t* matrix, int rows, int k,
                  const uint8_t* data, size_t len, uint8_t* out) {
  gf_init();
  memset(out, 0, (size_t)rows * len);
  for (int r = 0; r < rows; r++)
    for (int c = 0; c < k; c++)
      gf_madd(matrix[r * k + c], data + (size_t)c * len, out + (size_t)r * len, len);
}

void ct_rs_matmul_mt(const uint8_t* matrix, int rows, int k,
                     const uint8_t* data, size_t len, uint8_t* out,
                     int nthreads) {
  gf_init();
  if (nthreads <= 1 || len < 65536) {
    ct_rs_matmul(matrix, rows, k, data, len, out);
    return;
  }
  size_t slice = ((len / nthreads) + 63) & ~(size_t)63;
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; t++) {
    size_t off = t * slice;
    if (off >= len) break;
    size_t n = (off + slice <= len) ? slice : len - off;
    ts.emplace_back([=] {
      for (int r = 0; r < rows; r++) {
        uint8_t* o = out + (size_t)r * len + off;
        memset(o, 0, n);
        for (int c = 0; c < k; c++)
          gf_madd(matrix[r * k + c], data + (size_t)c * len + off, o, n);
      }
    });
  }
  for (auto& th : ts) th.join();
}

// Decode: given m x k coding matrix and the k surviving chunk indices
// (order matches rows of `chunks`), recover all k data chunks.
int ct_rs_decode(const uint8_t* matrix, int k, int m, const int* present,
                 const uint8_t* chunks, size_t len, uint8_t* out) {
  gf_init();
  std::vector<uint8_t> sub((size_t)k * k, 0);
  for (int r = 0; r < k; r++) {
    int idx = present[r];
    if (idx < 0 || idx >= k + m) return -1;
    if (idx < k)
      sub[(size_t)r * k + idx] = 1;
    else
      memcpy(&sub[(size_t)r * k], matrix + (size_t)(idx - k) * k, k);
  }
  if (ct_gf_matinv(sub.data(), k) != 0) return -1;
  ct_rs_matmul(sub.data(), k, k, chunks, len, out);
  return 0;
}

// ----------------------------------------------------------------- CRC32C

// Castagnoli, reflected polynomial 0x82F63B78. Contract matches the
// reference's ceph_crc32c (src/common/crc32c.h): no pre/post inversion
// (callers pass seed -1), and data == NULL computes the CRC of `len`
// zero bytes via the linear shift operator (ceph_crc32c_zeros role).
static uint32_t crc_tbl[8][256];
static std::once_flag crc_once;

static void crc_init_impl() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int j = 0; j < 8; j++) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
    crc_tbl[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++)
    for (int t = 1; t < 8; t++)
      crc_tbl[t][i] = (crc_tbl[t - 1][i] >> 8) ^ crc_tbl[0][crc_tbl[t - 1][i] & 0xff];
}

static void crc_init() { std::call_once(crc_once, crc_init_impl); }

static uint32_t crc32c_sw(uint32_t crc, const uint8_t* p, size_t len) {
  crc_init();
  while (len && ((uintptr_t)p & 7)) {
    crc = (crc >> 8) ^ crc_tbl[0][(crc ^ *p++) & 0xff];
    len--;
  }
  while (len >= 8) {
    uint64_t v = *(const uint64_t*)p ^ crc;
    crc = crc_tbl[7][v & 0xff] ^ crc_tbl[6][(v >> 8) & 0xff] ^
          crc_tbl[5][(v >> 16) & 0xff] ^ crc_tbl[4][(v >> 24) & 0xff] ^
          crc_tbl[3][(v >> 32) & 0xff] ^ crc_tbl[2][(v >> 40) & 0xff] ^
          crc_tbl[1][(v >> 48) & 0xff] ^ crc_tbl[0][v >> 56];
    p += 8;
    len -= 8;
  }
  while (len--) crc = (crc >> 8) ^ crc_tbl[0][(crc ^ *p++) & 0xff];
  return crc;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2"))) static uint32_t crc32c_hw(
    uint32_t crc, const uint8_t* p, size_t len) {
  while (len && ((uintptr_t)p & 7)) {
    crc = _mm_crc32_u8(crc, *p++);
    len--;
  }
  uint64_t c = crc;
  while (len >= 8) {
    c = _mm_crc32_u64(c, *(const uint64_t*)p);
    p += 8;
    len -= 8;
  }
  crc = (uint32_t)c;
  while (len--) crc = _mm_crc32_u8(crc, *p++);
  return crc;
}

static bool have_sse42() {
  static int v = -1;
  if (v < 0) v = __builtin_cpu_supports("sse4.2") ? 1 : 0;
  return v == 1;
}
#endif

// GF(2) 32x32 matrix ops for the zero-extension operator (crc of N zero
// bytes appended), the ceph_crc32c_zeros / crc combine technique.
static uint32_t gf2_matvec(const uint32_t* mat, uint32_t v) {
  uint32_t s = 0;
  for (int b = 0; v; b++, v >>= 1)
    if (v & 1) s ^= mat[b];
  return s;
}

static void gf2_matsq(uint32_t* dst, const uint32_t* src) {
  for (int b = 0; b < 32; b++) dst[b] = gf2_matvec(src, src[b]);
}

uint32_t ct_crc32c_zeros(uint32_t crc, uint64_t len) {
  crc_init();
  if (len == 0) return crc;
  // operator for one zero byte: crc' = (crc >> 8) ^ tbl[crc & 0xff]
  uint32_t op[32], tmp[32];
  for (int b = 0; b < 32; b++) {
    uint32_t v = 1u << b;
    op[b] = (v >> 8) ^ crc_tbl[0][v & 0xff];
  }
  // square-and-multiply over byte count
  while (len) {
    if (len & 1) crc = gf2_matvec(op, crc);
    len >>= 1;
    if (!len) break;
    gf2_matsq(tmp, op);
    memcpy(op, tmp, sizeof(op));
  }
  return crc;
}

uint32_t ct_crc32c(uint32_t crc, const uint8_t* data, uint64_t len) {
  if (!data) return ct_crc32c_zeros(crc, len);
#if defined(__x86_64__)
  if (have_sse42()) return crc32c_hw(crc, data, len);
#endif
  return crc32c_sw(crc, data, len);
}

uint32_t ct_crc32c_sw(uint32_t crc, const uint8_t* data, uint64_t len) {
  return crc32c_sw(crc, data, len);
}

// Batched: nblobs blobs of blob_len bytes each, contiguous; out[i] = crc.
void ct_crc32c_batch(uint32_t seed, const uint8_t* data, uint64_t blob_len,
                     uint64_t nblobs, uint32_t* out) {
  for (uint64_t i = 0; i < nblobs; i++)
    out[i] = ct_crc32c(seed, data + i * blob_len, blob_len);
}

void ct_crc32c_batch_mt(uint32_t seed, const uint8_t* data, uint64_t blob_len,
                        uint64_t nblobs, uint32_t* out, int nthreads) {
  if (nthreads <= 1) {
    ct_crc32c_batch(seed, data, blob_len, nblobs, out);
    return;
  }
  std::vector<std::thread> ts;
  uint64_t per = (nblobs + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    uint64_t lo = t * per, hi = lo + per > nblobs ? nblobs : lo + per;
    if (lo >= hi) break;
    ts.emplace_back([=] {
      for (uint64_t i = lo; i < hi; i++)
        out[i] = ct_crc32c(seed, data + i * blob_len, blob_len);
    });
  }
  for (auto& th : ts) th.join();
}

// --------------------------------------------------------- CRUSH straw2

// Robert Jenkins' 96-bit mix (public domain), as used by the reference's
// crush_hash32_* family (src/crush/hash.c).
#define CT_HASHMIX(a, b, c) \
  do {                      \
    a = a - b; a = a - c; a = a ^ (c >> 13); \
    b = b - c; b = b - a; b = b ^ (a << 8);  \
    c = c - a; c = c - b; c = c ^ (b >> 13); \
    a = a - b; a = a - c; a = a ^ (c >> 12); \
    b = b - c; b = b - a; b = b ^ (a << 16); \
    c = c - a; c = c - b; c = c ^ (b >> 5);  \
    a = a - b; a = a - c; a = a ^ (c >> 3);  \
    b = b - c; b = b - a; b = b ^ (a << 10); \
    c = c - a; c = c - b; c = c ^ (b >> 15); \
  } while (0)

static const uint32_t CT_HASH_SEED = 1315423911u;

uint32_t ct_crush_hash32_2(uint32_t a, uint32_t b) {
  uint32_t hash = CT_HASH_SEED ^ a ^ b;
  uint32_t x = 231232u, y = 1232u;
  CT_HASHMIX(a, b, hash);
  CT_HASHMIX(x, a, hash);
  CT_HASHMIX(b, y, hash);
  return hash;
}

uint32_t ct_crush_hash32_3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t hash = CT_HASH_SEED ^ a ^ b ^ c;
  uint32_t x = 231232u, y = 1232u;
  CT_HASHMIX(a, b, hash);
  CT_HASHMIX(c, x, hash);
  CT_HASHMIX(y, a, hash);
  CT_HASHMIX(b, x, hash);
  CT_HASHMIX(y, c, hash);
  return hash;
}

// 2^44 * log2(x+1), 16.44 fixed point (reference src/crush/mapper.c:226).
// Domain is 16 bits: straw2 always feeds hash & 0xffff; mask here so the
// public binding can't index past the tables.
uint64_t ct_crush_ln(uint32_t xin) {
  uint32_t x = (xin & 0xffff) + 1;
  int iexpon = 15;
  if (!(x & 0x18000)) {
    int bits = __builtin_clz(x & 0x1FFFF) - 16;
    x <<= bits;
    iexpon = 15 - bits;
  }
  int index1 = (x >> 8) << 1;
  int64_t RH = CT_RH_LH_TBL[(index1 - 256) / 2][0];
  int64_t LH = CT_RH_LH_TBL[(index1 - 256) / 2][1];
  int64_t xl64 = (int64_t)x * RH;
  xl64 >>= 48;
  uint64_t result = (uint64_t)iexpon << 44;
  int index2 = xl64 & 0xff;
  int64_t LL = CT_LL_TBL[index2];
  LH += LL;
  LH >>= (48 - 12 - 32);
  return result + (uint64_t)LH;
}

// draw for one (x, item, r): ln(hash & 0xffff) - 2^48, / 16.16 weight.
int64_t ct_straw2_draw(uint32_t x, uint32_t id, uint32_t r, uint32_t weight) {
  if (weight == 0) return INT64_MIN;
  uint32_t u = ct_crush_hash32_3(x, id, r) & 0xffff;
  int64_t ln = (int64_t)ct_crush_ln(u) - 0x1000000000000ll;
  return ln / (int64_t)weight;  // C truncation == div64_s64
}

// straw2 bucket choose (reference mapper.c:339): argmax of draws,
// first-wins ties. ids are the per-item hash inputs, items the returned
// values (usually identical; split mirrors choose_args remapping).
int32_t ct_straw2_choose(const int32_t* items, const int32_t* ids,
                         const uint32_t* weights, int n, uint32_t x,
                         uint32_t r) {
  int high = 0;
  int64_t high_draw = 0;
  for (int i = 0; i < n; i++) {
    int64_t draw = ct_straw2_draw(x, (uint32_t)ids[i], r, weights[i]);
    if (i == 0 || draw > high_draw) {
      high = i;
      high_draw = draw;
    }
  }
  return items[high];
}

void ct_straw2_bulk(const int32_t* items, const int32_t* ids,
                    const uint32_t* weights, int n, const uint32_t* xs,
                    uint64_t nx, uint32_t r, int32_t* out) {
  for (uint64_t j = 0; j < nx; j++)
    out[j] = ct_straw2_choose(items, ids, weights, n, xs[j], r);
}

void ct_straw2_bulk_mt(const int32_t* items, const int32_t* ids,
                       const uint32_t* weights, int n, const uint32_t* xs,
                       uint64_t nx, uint32_t r, int32_t* out, int nthreads) {
  if (nthreads <= 1) {
    ct_straw2_bulk(items, ids, weights, n, xs, nx, r, out);
    return;
  }
  std::vector<std::thread> ts;
  uint64_t per = (nx + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    uint64_t lo = t * per, hi = lo + per > nx ? nx : lo + per;
    if (lo >= hi) break;
    ts.emplace_back([=] {
      for (uint64_t j = lo; j < hi; j++)
        out[j] = ct_straw2_choose(items, ids, weights, n, xs[j], r);
    });
  }
  for (auto& th : ts) th.join();
}

// xxhash32/64 (Yann Collet's public algorithm) for the Checksummer's
// xxhash variants (reference src/common/Checksummer.h:15-193 uses the
// vendored xxHash submodule).
uint32_t ct_xxhash32(const uint8_t* p, uint64_t len, uint32_t seed) {
  const uint32_t P1 = 2654435761u, P2 = 2246822519u, P3 = 3266489917u,
                 P4 = 668265263u, P5 = 374761393u;
  const uint8_t* end = p + len;
  uint32_t h;
  if (len >= 16) {
    uint32_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 16;
    do {
      uint32_t w;
#define CT_RD32(dst) memcpy(&dst, p, 4), p += 4
      CT_RD32(w); v1 += w * P2; v1 = (v1 << 13) | (v1 >> 19); v1 *= P1;
      CT_RD32(w); v2 += w * P2; v2 = (v2 << 13) | (v2 >> 19); v2 *= P1;
      CT_RD32(w); v3 += w * P2; v3 = (v3 << 13) | (v3 >> 19); v3 *= P1;
      CT_RD32(w); v4 += w * P2; v4 = (v4 << 13) | (v4 >> 19); v4 *= P1;
    } while (p <= limit);
    h = ((v1 << 1) | (v1 >> 31)) + ((v2 << 7) | (v2 >> 25)) +
        ((v3 << 12) | (v3 >> 20)) + ((v4 << 18) | (v4 >> 14));
  } else {
    h = seed + P5;
  }
  h += (uint32_t)len;
  while (p + 4 <= end) {
    uint32_t w;
    CT_RD32(w);
    h += w * P3;
    h = ((h << 17) | (h >> 15)) * P4;
  }
  while (p < end) {
    h += (*p++) * P5;
    h = ((h << 11) | (h >> 21)) * P1;
  }
  h ^= h >> 15; h *= P2; h ^= h >> 13; h *= P3; h ^= h >> 16;
  return h;
}

uint64_t ct_xxhash64(const uint8_t* p, uint64_t len, uint64_t seed) {
  const uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                 P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                 P5 = 2870177450012600261ull;
  const uint8_t* end = p + len;
  uint64_t h;
  auto rot = [](uint64_t v, int s) { return (v << s) | (v >> (64 - s)); };
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      uint64_t w;
#define CT_RD64(dst) memcpy(&dst, p, 8), p += 8
      CT_RD64(w); v1 = rot(v1 + w * P2, 31) * P1;
      CT_RD64(w); v2 = rot(v2 + w * P2, 31) * P1;
      CT_RD64(w); v3 = rot(v3 + w * P2, 31) * P1;
      CT_RD64(w); v4 = rot(v4 + w * P2, 31) * P1;
    } while (p <= limit);
    h = rot(v1, 1) + rot(v2, 7) + rot(v3, 12) + rot(v4, 18);
    auto merge = [&](uint64_t v) {
      h ^= rot(v * P2, 31) * P1;
      h = h * P1 + P4;
    };
    merge(v1); merge(v2); merge(v3); merge(v4);
  } else {
    h = seed + P5;
  }
  h += len;
  while (p + 8 <= end) {
    uint64_t w;
    CT_RD64(w);
    h ^= rot(w * P2, 31) * P1;
    h = rot(h, 27) * P1 + P4;
  }
  if (p + 4 <= end) {
    uint32_t w;
    CT_RD32(w);
    h ^= (uint64_t)w * P1;
    h = rot(h, 23) * P2 + P3;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rot(h, 11) * P1;
  }
  h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
  return h;
}

}  // extern "C"
