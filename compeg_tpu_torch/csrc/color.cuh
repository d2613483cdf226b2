// The colour conversion that every kernel writing RGBA shares: the RGBA
// kernels' composite (csrc/decode.cu rgba_word) and the planes epilogue
// (csrc/epilogue.cu). Integer BT.601 as the reference has it
// (ops/color.ycbcr_to_rgba; compeg_tpu/ops/fused.py rgba_at): 45/32,
// 11/32 + 23/32 and 113/64 with arithmetic shifts, clamped to [0, 255].
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
