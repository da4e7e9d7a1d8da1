// Adler-32, vectorized host path.
//
// zlib-compatible (reference: adler32/adler32.cpp:85, SIMD tap-weighted dot
// product).  Own formulation: per 32-byte chunk c_t within an NMAX block,
//   s1' = s1 + sum_t sum(c_t)
//   s2' = s2 + blk*s1 + 32*sum_t (running s1 before step t) + sum_t dot(c_t, [32..1])
// with the running-sum accumulated in a vector register (acc += vs1 before
// each step).  All lane accumulators stay below 2^31 for blk <= NMAX.

#include <cstdint>
#include <cstddef>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace tbsc {

using u8 = uint8_t;
using u32 = uint32_t;
using i64 = int64_t;

static constexpr u32 BASE = 65521;
static constexpr i64 NMAX = 5536;  // zlib's overflow bound, divisible by 32

static u32 adler32_scalar(const u8* p, i64 n, u32 s1, u32 s2) {
  while (n > 0) {
    i64 blk = n < NMAX ? n : NMAX;
    n -= blk;
    for (i64 i = 0; i < blk; ++i) {
      s1 += p[i];
      s2 += s1;
    }
    p += blk;
    s1 %= BASE;
    s2 %= BASE;
  }
  return (s2 << 16) | s1;
}

u32 adler32(const u8* p, i64 n, u32 adler) {
  u32 s1 = adler & 0xFFFF, s2 = (adler >> 16) & 0xFFFF;
#if defined(__AVX2__)
  const __m256i zero = _mm256_setzero_si256();
  const __m256i ones16 = _mm256_set1_epi16(1);
  alignas(32) static const u8 wtab[32] = {
      32, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18, 17,
      16, 15, 14, 13, 12, 11, 10, 9,  8,  7,  6,  5,  4,  3,  2,  1};
  const __m256i w = _mm256_load_si256((const __m256i*)wtab);
  while (n >= 32) {
    i64 blk = n < NMAX ? (n & ~(i64)31) : NMAX;
    n -= blk;
    __m256i vs1 = zero, acc = zero, vdot = zero;
    for (i64 i = 0; i < blk; i += 32) {
      __m256i c = _mm256_loadu_si256((const __m256i*)(p + i));
      acc = _mm256_add_epi32(acc, vs1);
      vs1 = _mm256_add_epi32(vs1, _mm256_sad_epu8(c, zero));
      __m256i prod = _mm256_maddubs_epi16(c, w);
      vdot = _mm256_add_epi32(vdot, _mm256_madd_epi16(prod, ones16));
    }
    p += blk;
    alignas(32) u32 lanes[8];
    u32 h1 = 0, hacc = 0, hdot = 0;
    _mm256_store_si256((__m256i*)lanes, vs1);
    h1 = lanes[0] + lanes[2] + lanes[4] + lanes[6];
    _mm256_store_si256((__m256i*)lanes, acc);
    hacc = lanes[0] + lanes[2] + lanes[4] + lanes[6];
    _mm256_store_si256((__m256i*)lanes, vdot);
    for (int t = 0; t < 8; ++t) hdot += lanes[t];
    // s2 terms: blk*s1 can reach 5536*65520 < 2^29; 32*hacc < 2^31; fold
    // with 64-bit intermediates to be safe
    uint64_t s2w = (uint64_t)s2 + (uint64_t)blk * s1 +
                   32ull * hacc + hdot;
    s1 = (s1 + h1) % BASE;
    s2 = (u32)(s2w % BASE);
  }
#endif
  return adler32_scalar(p, n, s1, s2);
}

}  // namespace tbsc
