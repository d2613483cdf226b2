// The exact integer 8x8 IDCT of the decode kernels' integer mode (K2x and
// K3 with exact_idct): compeg_tpu/ops/int_idct.py idct_1d (:51-100) and
// idct_2d_rows (:103-123), the 13-bit fixed-point Loeffler butterfly that
// golden.decode_rgb(idct="int") evaluates in numpy int32.
//
// The reference evaluates it in int32 with two's-complement wrap, and
// int16-range inputs do wrap. Signed overflow is undefined in C++, so every
// product and sum here is taken in uint32_t (arithmetic mod 2^32, the same
// bits as the wrapping int32), and only the descale reinterprets the sum as
// int32_t for its arithmetic right shift. The Pallas kernel evaluates each
// pass as a matrix product on bf16 limbs instead (int_idct.mxu_operators),
// since the TPU has no fast int32 multiply; the pre-descale sums agree mod
// 2^32 either way.
#pragma once

#include <cstdint>

namespace int_idct {

constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;

constexpr uint32_t FIX_0_298631336 = 2446;
constexpr uint32_t FIX_0_390180644 = 3196;
constexpr uint32_t FIX_0_541196100 = 4433;
constexpr uint32_t FIX_0_765366865 = 6270;
constexpr uint32_t FIX_0_899976223 = 7373;
constexpr uint32_t FIX_1_175875602 = 9633;
constexpr uint32_t FIX_1_501321110 = 12299;
constexpr uint32_t FIX_1_847759065 = 15137;
constexpr uint32_t FIX_1_961570560 = 16069;
constexpr uint32_t FIX_2_053119869 = 16819;
constexpr uint32_t FIX_2_562915447 = 20995;
constexpr uint32_t FIX_3_072711026 = 25172;

// Natural (row-major) position n of an 8x8 block -> its zigzag index
// (compeg_tpu/tables.py ZIGZAG; a CPU test compares the two).
__device__ __constant__ int kZigzag[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

// Round-half-up arithmetic right shift of the wrapped sum x (int_idct.descale).
__device__ __forceinline__ int32_t descale(uint32_t x, int n) {
  return static_cast<int32_t>(x + (1u << (n - 1))) >> n;
}

// One 8-point pass: the pre-descale sums of idct_1d, mod 2^32.
__device__ __forceinline__ void idct8(const uint32_t s[8], uint32_t o[8]) {
  // Even part.
  uint32_t z2 = s[2], z3 = s[6];
  uint32_t z1 = (z2 + z3) * FIX_0_541196100;
  const uint32_t tmp2 = z1 - z3 * FIX_1_847759065;
  const uint32_t tmp3 = z1 + z2 * FIX_0_765366865;
  const uint32_t tmp0 = (s[0] + s[4]) << CONST_BITS;
  const uint32_t tmp1 = (s[0] - s[4]) << CONST_BITS;
  const uint32_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
  const uint32_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
  // Odd part.
  uint32_t t0 = s[7], t1 = s[5], t2 = s[3], t3 = s[1];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  uint32_t z4 = t1 + t3;
  const uint32_t z5 = (z3 + z4) * FIX_1_175875602;
  t0 *= FIX_0_298631336;
  t1 *= FIX_2_053119869;
  t2 *= FIX_3_072711026;
  t3 *= FIX_1_501321110;
  z1 *= 0u - FIX_0_899976223;
  z2 *= 0u - FIX_2_562915447;
  z3 = z3 * (0u - FIX_1_961570560) + z5;
  z4 = z4 * (0u - FIX_0_390180644) + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  o[0] = t10 + t3;
  o[1] = t11 + t2;
  o[2] = t12 + t1;
  o[3] = t13 + t0;
  o[4] = t13 - t0;
  o[5] = t12 - t1;
  o[6] = t11 - t2;
  o[7] = t10 - t3;
}

// Dequantize one coefficient as golden does (golden.py:286-287): the
// product in 64 bits, then a saturating clamp to the int16 range.
__device__ __forceinline__ uint32_t dequant(int coeff, int q) {
  long long v = static_cast<long long>(coeff) * q;
  v = v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
  return static_cast<uint32_t>(static_cast<int32_t>(v));
}

}  // namespace int_idct
