// The colour conversion that every kernel writing RGBA shares, a pixel at a
// time for the RGBA kernels' composite (csrc/decode.cu rgba_word) and a
// quad, two pixels a word, for the planes epilogue (csrc/epilogue.cu).
// Integer BT.601 as the reference has it (ops/color.ycbcr_to_rgba;
// compeg_tpu/ops/fused.py rgba_at): 45/32, 11/32 + 23/32 and 113/64 with
// arithmetic shifts, clamped to [0, 255]. The two forms are one rule: a
// change goes into both (tests/test_torch_epilogue.py holds the second to
// the first for every sample).
#pragma once

#include <cstdint>

// One RGBA word r | g << 8 | b << 16 | 0xFF << 24 from a luma sample and its
// two other component samples: gray replicated to three channels, RGB-ID
// samples passed through, YCbCr converted.
__device__ __forceinline__ uint32_t rgba_pixel(bool gray, bool rgb, int y,
                                               int c1, int c2) {
  int rr, gg, bb;
  if (gray) {
    rr = gg = bb = y;
  } else if (rgb) {
    rr = y;
    gg = c1;
    bb = c2;
  } else {
    const int cb = c1 - 128, cr = c2 - 128;
    rr = y + ((45 * cr) >> 5);
    gg = y - ((11 * cb + 23 * cr) >> 5);
    bb = y + ((113 * cb) >> 6);
  }
  rr = min(max(rr, 0), 255);
  gg = min(max(gg, 0), 255);
  bb = min(max(bb, 0), 255);
  return (uint32_t)rr | ((uint32_t)gg << 8) | ((uint32_t)bb << 16) | 0xFF000000u;
}

// A component's four samples of a quad (four neighbouring pixels of a row)
// in two words of 16-bit lanes: `lo` holds pixels 0 and 2, `hi` pixels 1
// and 3.
struct QuadSamples {
  uint32_t lo, hi;
};

// rgba_pixel for the four pixels of a quad, two to a word. With cb = c1 -
// 128 and cr = c2 - 128, (45 cr) >> 5 = (45 c2 >> 5) - 180, (11 cb + 23 cr)
// >> 5 = ((11 c1 + 23 c2) >> 5) - 136 and (113 cb) >> 6 = (113 c1 >> 6) -
// 226 (each constant a whole multiple of the divisor), so every lane stays
// non-negative until one DPX instruction adds the rest and clamps:
// __viaddmin_s16x2_relu(a, b, 255) = max(min(a + b, 255), 0).
__device__ __forceinline__ uint4 rgba_quad(bool gray, bool rgb, QuadSamples y,
                                           QuadSamples c1, QuadSamples c2) {
  const uint32_t top = 0x00FF00FFu;  // 255 in both lanes
  uint32_t w[2][2];  // [lo, hi][pixels (0, 1) or (2, 3)]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t yy = h ? y.hi : y.lo;
    uint32_t r = yy, g = yy, b = yy;
    if (!gray) {
      const uint32_t u = h ? c1.hi : c1.lo, v = h ? c2.hi : c2.lo;
      if (rgb) {
        g = u;
        b = v;
      } else {
        const uint32_t rt = (v * 45u) >> 5 & 0x01FF01FFu;
        const uint32_t gt = (u * 11u + v * 23u) >> 5 & 0x01FF01FFu;
        const uint32_t bt = (u * 113u) >> 6 & 0x01FF01FFu;
        r = __viaddmin_s16x2_relu(yy + rt, 0xFF4CFF4Cu, top);  // - 180
        g = __viaddmin_s16x2_relu(yy + 0x02880288u - gt, 0xFE00FE00u,
                                  top);  // + 648 - 512
        b = __viaddmin_s16x2_relu(yy + bt, 0xFF1EFF1Eu, top);  // - 226
      }
    }
    const uint32_t rg = r | g << 8, ba = b | 0xFF00FF00u;
    w[h][0] = __byte_perm(rg, ba, 0x5410);  // r g b a of the lane-0 pixel
    w[h][1] = __byte_perm(rg, ba, 0x7632);  // of the lane-1 pixel
  }
  return make_uint4(w[0][0], w[1][0], w[0][1], w[1][1]);
}
