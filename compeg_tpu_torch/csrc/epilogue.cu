// The planes epilogue of compeg_tpu_torch, for Hopper (sm_90a): the u8
// component planes that the planes kernel K3 writes (csrc/decode.cu,
// kOutPlanes) to packed RGBA, in one pass.
//
// planes_epilogue_kernel replaces no pl.pallas_call. It is the counterpart
// of the XLA output fusion that ends the JAX package's
// decode_frame_fused_planes (compeg_tpu/pipeline.py:153): finalize_planes
// (compeg_tpu/ops/fused.py:890) with its packed forms
// _finalize_planes_nearest_packed (:737) and _finalize_planes_fancy422_packed
// (:803), and the banded vertical filter _upsample_fancy_v_sharded (:696),
// which XLA fuses into the one output pass. Its plain twin is
// ops/color.finalize_planes_reference, whose integer arithmetic it repeats
// sample for sample:
//
//  * nearest: replication by fx in {1, 2, 4} and fy in {1, 2};
//  * fancy: libjpeg's triangle filter, vertical first, then horizontal, each
//    a 2x step, (3 * near + far + 1) >> 2 for even outputs and + 2 for odd
//    ones; the horizontal step reads the vertically filtered neighbours. It
//    clamps at the edge of the MCU-padded plane, never at the image edge;
//    fx = 4 (4:1:1) stays replication, as in libjpeg;
//  * a band's plane (parallel/sharding.py): the row above its first row and
//    the row below its last come as halo rows (null: the plane's own edge
//    row), and the rows from valid - 1 on take themselves as the row below
//    (the content edge of the last band);
//  * gray replicated, RGB-ID passed through, else integer BT.601
//    (csrc/color.cuh rgba_pixel, shared with K2's composite);
//  * packed RGBA int32 [frames, height, width], cropped.
//
// What bounds it on the H100: bytes. A 4K 4:2:2 frame reads 16.6 MB of
// planes and writes 33.2 MB of RGBA, 0.0149 ms at 3.35 TB/s, and does about
// 40 integer operations a pixel, far under the card's rate. What the design
// does about it: one thread takes four neighbouring pixels of one row (a
// quad), a warp 32 quads side by side and a block four rows, so a warp reads
// 128 neighbouring luma bytes (one word a thread where the row allows it)
// and the few chroma samples its quads share, which the other rows of the
// block find in L1; every plane byte comes from device memory about once.
// A quad is one 16-byte store where the raster allows it (width % 4 == 0
// and a 16-byte aligned base), else four word stores with the right edge
// checked, as K2's composite stores. The batch is the grid's z, so a batch
// of frames or a rank's band frames take one launch and the vertical filter
// never reads a neighbouring frame's rows.

#include <cuda_runtime.h>

#include <cstdint>

#include "color.cuh"

// Mirror of compeg_tpu_torch.ops._build.EpilogueParams (all int32).
struct EpilogueParams {
  int frames;      // frames of the batch (the grid's z)
  int ncomp;       // components: 1 (gray) or 3
  int rgb;         // the samples are already RGB (component IDs R, G, B)
  int fancy;       // the triangle filter; else nearest replication
  int width;       // output [frames, height, width] RGBA words
  int height;
  int plane_h[3];  // a frame's plane, [plane_h, plane_w] u8, contiguous
  int plane_w[3];
  int fx[3];       // upsampling to the output grid, fx in {1, 2, 4}
  int fy[3];       // fy in {1, 2}
  int valid[3];    // content rows of a band's plane, -1: every row
};

namespace {

constexpr int EP_QUADS = 32;  // quads of a row a block takes: one warp
constexpr int EP_ROWS = 4;    // rows a block takes: one warp each

struct EpilogueTensors {
  const uint8_t* plane[3];  // [frames, plane_h, plane_w]
  const uint8_t* above[3];  // [frames, plane_w] halo rows, or null
  const uint8_t* below[3];
};

__device__ __forceinline__ int sample(const uint8_t* p) { return __ldg(p); }

// Four neighbouring bytes, as one load where their address allows it.
__device__ __forceinline__ uint32_t load_quad(const uint8_t* p) {
  if ((reinterpret_cast<uintptr_t>(p) & 3) == 0)
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  return (uint32_t)sample(p) | ((uint32_t)sample(p + 1) << 8) |
         ((uint32_t)sample(p + 2) << 16) | ((uint32_t)sample(p + 3) << 24);
}

// Component c's samples at output row Y, columns X0..X0+3 of frame f.
__device__ __forceinline__ void component_quad(const EpilogueParams& p,
                                               const EpilogueTensors& t,
                                               int c, int f, int Y, int X0,
                                               int v[4]) {
  const int H = p.plane_h[c], W = p.plane_w[c], fx = p.fx[c];
  const bool up2 = p.fy[c] == 2;
  const int r = up2 ? Y >> 1 : Y;
  const uint8_t* row = t.plane[c] + ((size_t)f * H + r) * W;
  // The vertical step: the row itself, or with the triangle filter its
  // blend with the row above (even Y) or below (odd Y).
  const bool filt = p.fancy && up2;
  const uint8_t* nb = row;
  int bias = 0;
  if (filt) {
    if (Y & 1) {
      const int limit = p.valid[c] < 0 ? H : p.valid[c] - 1;
      nb = r >= limit  ? row
           : r + 1 < H ? row + W
           : t.below[c] ? t.below[c] + (size_t)f * W
                        : row;
      bias = 2;
    } else {
      nb = r > 0       ? row - W
           : t.above[c] ? t.above[c] + (size_t)f * W
                        : row;
      bias = 1;
    }
  }
  auto vert = [&](int x) {
    const int a = sample(row + x);
    return filt ? (3 * a + sample(nb + x) + bias) >> 2 : a;
  };
  if (fx == 1) {
    if (X0 + 4 <= W) {
      const uint32_t a = load_quad(row + X0);
      const uint32_t b = filt ? load_quad(nb + X0) : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = (a >> (8 * j)) & 0xFF;
        v[j] = filt ? (3 * s + (int)((b >> (8 * j)) & 0xFF) + bias) >> 2 : s;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = vert(min(X0 + j, W - 1));
    }
  } else if (fx == 2) {
    // Pixels X0..X0+3 take samples x, x, x + 1, x + 1; the filter's
    // neighbours are x - 1 and x + 2, clamped at the plane's edge.
    const int x = X0 >> 1;
    const int m0 = vert(x), m1 = vert(min(x + 1, W - 1));
    if (p.fancy) {
      const int left = vert(max(x - 1, 0)), right = vert(min(x + 2, W - 1));
      v[0] = (3 * m0 + left + 1) >> 2;
      v[1] = (3 * m0 + m1 + 2) >> 2;
      v[2] = (3 * m1 + m0 + 1) >> 2;
      v[3] = (3 * m1 + right + 2) >> 2;
    } else {
      v[0] = v[1] = m0;
      v[2] = v[3] = m1;
    }
  } else {  // fx == 4: replication in either mode
    v[0] = v[1] = v[2] = v[3] = vert(min(X0 >> 2, W - 1));
  }
}

__global__ void __launch_bounds__(EP_QUADS * EP_ROWS)
    planes_epilogue_kernel(EpilogueTensors t, uint32_t* out,
                           EpilogueParams p) {
  const int X0 = (blockIdx.x * EP_QUADS + threadIdx.x) * 4;
  const int Y = blockIdx.y * EP_ROWS + threadIdx.y;
  const int f = blockIdx.z;
  if (X0 >= p.width || Y >= p.height) return;
  int s[3][4];
  const bool gray = p.ncomp == 1;
  component_quad(p, t, 0, f, Y, X0, s[0]);
  if (!gray) {
    component_quad(p, t, 1, f, Y, X0, s[1]);
    component_quad(p, t, 2, f, Y, X0, s[2]);
  }
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = gray ? rgba_pixel(true, false, s[0][j], 0, 0)
                : rgba_pixel(false, p.rgb, s[0][j], s[1][j], s[2][j]);
  uint32_t* dst = out + ((size_t)f * p.height + Y) * p.width + X0;
  if ((p.width & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (X0 + j < p.width) dst[j] = w[j];
  }
}

}  // namespace

extern "C" {

// planes y, cb, cr [frames, plane_h, plane_w] u8 (cb, cr null for gray);
// above and below each component's halo rows [frames, plane_w] or null;
// out [frames, height, width] int32. ops/color.finalize_planes checks the
// shapes; a configuration the kernel does not take is refused here.
int compeg_planes_epilogue(const void* y, const void* cb, const void* cr,
                           const void* above_y, const void* above_cb,
                           const void* above_cr, const void* below_y,
                           const void* below_cb, const void* below_cr,
                           void* out, const EpilogueParams* p, void* stream) {
  if (p->frames < 1 || p->frames > 65535 || (p->ncomp != 1 && p->ncomp != 3) ||
      p->width < 1 || p->height < 1 || p->height > 65535 * EP_ROWS)
    return (int)cudaErrorInvalidValue;
  const EpilogueTensors t = {
      {(const uint8_t*)y, (const uint8_t*)cb, (const uint8_t*)cr},
      {(const uint8_t*)above_y, (const uint8_t*)above_cb,
       (const uint8_t*)above_cr},
      {(const uint8_t*)below_y, (const uint8_t*)below_cb,
       (const uint8_t*)below_cr}};
  for (int c = 0; c < p->ncomp; ++c) {
    const int fx = p->fx[c], fy = p->fy[c];
    if (t.plane[c] == nullptr || p->plane_h[c] < 1 || p->plane_w[c] < 1 ||
        (fx != 1 && fx != 2 && fx != 4) || (fy != 1 && fy != 2) ||
        p->plane_w[c] * fx < p->width || p->plane_h[c] * fy < p->height)
      return (int)cudaErrorInvalidValue;
  }
  const int quads = (p->width + 3) / 4;
  const dim3 grid((quads + EP_QUADS - 1) / EP_QUADS,
                  (p->height + EP_ROWS - 1) / EP_ROWS, p->frames);
  planes_epilogue_kernel<<<grid, dim3(EP_QUADS, EP_ROWS), 0,
                           (cudaStream_t)stream>>>(t, (uint32_t*)out, *p);
  return (int)cudaGetLastError();
}

}  // extern "C"
