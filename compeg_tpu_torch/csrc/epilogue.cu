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
//    (csrc/color.cuh rgba_quad, the rule of K2's rgba_pixel two pixels a
//    word);
//  * packed RGBA int32 [frames, height, width], cropped.
//
// What bounds it on the H100: bytes. A 4K 4:2:2 frame reads 16.6 MB of
// planes and writes 33.2 MB of RGBA, 0.0149 ms at 3.35 TB/s (4:2:0: 12.4 MB
// read, 0.0136 ms), and does about 40 integer operations a pixel, under the
// card's rate but not by much once each takes an instruction. What held
// the kernel's first form (a lane a quad, a load a chroma byte) to 2.1-2.4 x
// that bound, measured with tools/compare_csrc.py on copies of it with parts
// taken out: its stores alone ran at 2.7 TB/s (0.0123 ms), its loads alone
// at 0.7-1.0 TB/s (nine load instructions a quad with the triangle filter),
// and the two added up. A lane that stores 16 pixels as four
// 16-byte vectors ran 2.3 x slower than lanes that each store one vector
// side by side, so the design keeps that store and cuts the loads and the
// instructions around them:
//
//  * a lane takes a quad (4 pixels of a row, one 16-byte store) and walks a
//    strip of EP_STRIP rows; the warp's lanes take neighbouring quads, so
//    every load and store of a warp is one contiguous run;
//  * a component's samples of a quad come in one load a row (4 bytes, 2 at
//    4:2:2 and 4:2:0 chroma, 1 at 4:1:1), all rows of the strip issued
//    before the first conversion; where every lane's samples lie in aligned
//    words (WIDE, decided once a warp) no byte-wise path is issued at all;
//  * the triangle filter's horizontal neighbours come from the lanes beside
//    it by shuffle; only the warp's first and last lanes load one column;
//  * with fy = 2 the strip's chroma rows are loaded once and a far row that
//    is one of them comes from the registers (the row window); the row above
//    the strip and the one below it (or a halo row) are the only others;
//  * filter and colour run on two samples to a word: the filter's blend in
//    16-bit lanes, BT.601 as csrc/color.cuh rgba_quad, whose constants are
//    folded so that one DPX add-min-relu (__viaddmin_s16x2_relu) adds and
//    clamps.
//
// The batch is the grid's z, so a batch of frames or a rank's band frames
// take one launch and the vertical filter never reads a neighbouring
// frame's rows. Stores are one 16-byte vector where the raster allows it
// (width % 4 == 0 and a 16-byte aligned base), else word stores with the
// right edge checked.

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

constexpr int EP_STRIP = 4;  // output rows a lane walks down: two row pairs
constexpr int EP_WARPS = 4;  // warps a block, one strip each
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t LANES16 = 0x00FF00FFu;  // bytes 0 and 2: two 16-bit lanes

struct EpilogueTensors {
  const uint8_t* plane[3];  // [frames, plane_h, plane_w]
  const uint8_t* above[3];  // [frames, plane_w] halo rows, or null
  const uint8_t* below[3];
};

// N neighbouring samples of a plane row from column x0, low byte first: one
// load where WIDE says the row holds them at an address aligned for it,
// else byte by byte with every column clamped to the row.
template <int N, bool WIDE>
__device__ __forceinline__ uint32_t load_samples(const uint8_t* row, int x0,
                                                 int W) {
  if (WIDE) {
    if (N == 4) return __ldg(reinterpret_cast<const unsigned int*>(row + x0));
    if (N == 2)
      return __ldg(reinterpret_cast<const unsigned short*>(row + x0));
    return __ldg(row + x0);
  }
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < N; ++j)
    v |= (uint32_t)__ldg(row + min(x0 + j, W - 1)) << (8 * j);
  return v;
}

// (3 * near + far + bias) >> 2 in each byte of a word, two bytes to a 16-bit
// lane (at most 1,022, so no lane carries into the next).
__device__ __forceinline__ uint32_t blend(uint32_t near, uint32_t far,
                                          uint32_t bias) {
  const uint32_t k = bias * 0x10001u;
  const uint32_t lo = ((near & LANES16) * 3u + (far & LANES16) + k) >> 2;
  const uint32_t hi =
      ((near >> 8 & LANES16) * 3u + (far >> 8 & LANES16) + k) >> 2;
  return (lo & LANES16) | (hi & LANES16) << 8;
}

// The same in the two 16-bit lanes of a word of samples.
__device__ __forceinline__ uint32_t blend16(uint32_t near, uint32_t far,
                                            uint32_t bias) {
  return (near * 3u + far + bias * 0x10001u) >> 2 & LANES16;
}

// Component c's samples of the quad whose samples start at column x0 of
// its plane in frame f, in each output row Y0 .. Y0 + EP_STRIP - 1,
// upsampled by FX x FY, where WIDE says every lane's samples lie in aligned
// words of the plane's rows. The strip's plane rows are loaded once, and
// with the vertical filter the row above the strip and the one below its
// last row (or a halo row, or the row itself at an edge); a far row that is
// one of the strip's comes from the registers (the row window). Horizontal
// neighbours come from the lanes beside this one, or from this lane's own
// samples where the plane ends at x0 + 1; the warp's first lane loads its
// left neighbour's column and its last lane its right one's, alongside the
// strip's rows. A lane past the row's end takes the quad past it inside
// the plane, so the first of them holds the last quad's right neighbour
// wherever the plane runs on past that quad.
template <int FX, int FY, bool WIDE>
__device__ __forceinline__ void component_strip(
    const EpilogueParams& p, const EpilogueTensors& t, int c, int f, int Y0,
    int x0, int lane, QuadSamples s[EP_STRIP]) {
  constexpr int N = 4 / FX;         // samples a quad takes from a row
  constexpr int P = EP_STRIP / FY;  // plane rows of the strip
  const int H = p.plane_h[c], W = p.plane_w[c];
  // Where the samples are loaded from: WIDE moves a lane past the row's end
  // back inside the row. No lane reads the samples of such a lane but the
  // last quad's, from the first lane past it, and only where the plane runs
  // on past the last quad's x0 + 1, where that lane does not move.
  const int xl = WIDE ? min(x0, W - N) : x0;
  const uint8_t* plane = t.plane[c] + (size_t)f * H * W;
  const int r0 = Y0 / FY;  // < H: Y0 is an output row
  const bool filt = FY == 2 && p.fancy;
  const bool nb = FX == 2 && p.fancy;
  // The edge lanes' neighbour column (clamped); `edge` where it is loaded.
  const int ecol = min(max(lane == 0 ? x0 - 1 : x0 + 2, 0), W - 1);
  const bool edge = nb && ((lane == 0 && x0 > 0) || lane == 31);
  uint32_t v[P], e[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const uint8_t* row = plane + (size_t)min(r0 + j, H - 1) * W;
    v[j] = load_samples<N, WIDE>(row, xl, W);
    e[j] = edge ? __ldg(row + ecol) : 0u;
  }
  // The vertical filter's rows outside the window: above the strip's first
  // row, and below its last row inside the plane.
  uint32_t up = 0, dn = 0, eup = 0, edn = 0;
  int limit = 0, rlast = 0;
  if (filt) {
    limit = p.valid[c] < 0 ? H : p.valid[c] - 1;
    rlast = min(r0 + P - 1, H - 1);
    const uint8_t* first = plane + (size_t)r0 * W;
    const uint8_t* last = plane + (size_t)rlast * W;
    const uint8_t* above = r0 > 0        ? first - W
                           : t.above[c]  ? t.above[c] + (size_t)f * W
                                         : first;
    const uint8_t* below = rlast + 1 < H ? last + W
                           : t.below[c]  ? t.below[c] + (size_t)f * W
                                         : last;
    const bool halo_wide =
        ((reinterpret_cast<uintptr_t>(above) |
          reinterpret_cast<uintptr_t>(below)) & (N - 1)) == 0;
    up = WIDE && halo_wide ? load_samples<N, true>(above, xl, W)
                           : load_samples<N, false>(above, xl, W);
    dn = WIDE && halo_wide ? load_samples<N, true>(below, xl, W)
                           : load_samples<N, false>(below, xl, W);
    if (edge) {
      eup = __ldg(above + ecol);
      edn = __ldg(below + ecol);
    }
  }
#pragma unroll
  for (int k = 0; k < EP_STRIP; ++k) {
    const int j = k / FY;
    const uint32_t bias = 1 + (k & 1);
    uint32_t m = v[j], em = e[j];  // the vertically filtered samples
    if (filt) {
      // The row above (even k) or below (odd k); from the content edge
      // (valid - 1) on, the row itself, whose blend is the row.
      const int r = r0 + j;
      uint32_t fv, fe;
      if (k & 1) {
        const bool self = r >= limit, in = r < rlast;
        fv = self ? v[j] : in ? v[min(j + 1, P - 1)] : dn;
        fe = self ? e[j] : in ? e[min(j + 1, P - 1)] : edn;
      } else {
        fv = j == 0 ? up : v[max(j - 1, 0)];
        fe = j == 0 ? eup : e[max(j - 1, 0)];
      }
      m = blend(v[j], fv, bias);
      em = (3 * e[j] + fe + bias) >> 2;
    }
    if (FX == 1) {
      s[k] = {m & LANES16, m >> 8 & LANES16};
    } else if (FX == 4) {  // replication in either mode
      s[k].lo = s[k].hi = m * 0x10001u;
    } else if (!nb) {
      s[k].lo = s[k].hi = __byte_perm(m, 0, 0x4140);  // x0, x0 + 1
    } else {
      // The quad's pixels take samples x0, x0, x0 + 1, x0 + 1 and the
      // neighbours x0 - 1 and x0 + 2, clamped at the plane's edge: the left
      // lane's second sample and the right lane's first.
      uint32_t lt = __shfl_up_sync(FULL, m, 1) >> 8 & 0xFF;
      uint32_t rt = __shfl_down_sync(FULL, m, 1) & 0xFF;
      if (lane == 0) lt = x0 > 0 ? em : m & 0xFF;
      if (lane == 31) rt = em;
      if (x0 + 2 >= W) rt = m >> 8 & 0xFF;
      const uint32_t pair = __byte_perm(m, 0, 0x4140);  // x0, x0 + 1
      s[k].lo = blend16(pair, __byte_perm(m, lt, 0x2024), 1);  // - 1, x0
      s[k].hi = blend16(pair, __byte_perm(m, rt, 0x2421), 2);  // x0 + 1, + 2
    }
  }
}

// component_strip with the factors of the kernel's instantiation, or, where
// it takes them from the parameters (0), with the component's own, for the
// quad q of a row of `quads`; WIDE where every row's samples of the warp's
// quads lie in aligned words.
template <int FX, int FY>
__device__ __forceinline__ void component_any(
    const EpilogueParams& p, const EpilogueTensors& t, int c, int f, int Y0,
    int q, int quads, int lane, QuadSamples s[EP_STRIP]) {
  if constexpr (FX != 0 && FY != 0) {
    constexpr int N = 4 / FX;
    const int W = p.plane_w[c];
    const uint8_t* plane = t.plane[c] + (size_t)f * p.plane_h[c] * W;
    const int x0 = q * 4 / FX;
    const bool wide =
        __all_sync(FULL, q >= quads || x0 + N <= W) &&
        ((reinterpret_cast<uintptr_t>(plane) | (uintptr_t)W) & (N - 1)) == 0;
    if (wide)
      component_strip<FX, FY, true>(p, t, c, f, Y0, x0, lane, s);
    else
      component_strip<FX, FY, false>(p, t, c, f, Y0, x0, lane, s);
  } else {
    const int fx = p.fx[c];
    if (p.fy[c] == 1) {
      if (fx == 1) component_any<1, 1>(p, t, c, f, Y0, q, quads, lane, s);
      else if (fx == 2) component_any<2, 1>(p, t, c, f, Y0, q, quads, lane, s);
      else component_any<4, 1>(p, t, c, f, Y0, q, quads, lane, s);
    } else {
      if (fx == 1) component_any<1, 2>(p, t, c, f, Y0, q, quads, lane, s);
      else if (fx == 2) component_any<2, 2>(p, t, c, f, Y0, q, quads, lane, s);
      else component_any<4, 2>(p, t, c, f, Y0, q, quads, lane, s);
    }
  }
}

// A lane takes a quad (four neighbouring pixels of a row) and walks down a
// strip of EP_STRIP rows: the grid's x the warps side by side along the
// rows, y the strips (a warp each), z the frames. Lanes past a row's end
// store nothing. FX0, FY0 are component 0's factors, FXC, FYC the other
// two's, 0 where they are read from the parameters.
template <int FX0, int FY0, int FXC, int FYC>
__global__ void __launch_bounds__(EP_WARPS * 32)
    planes_epilogue_kernel(EpilogueTensors t, uint32_t* out,
                           EpilogueParams p) {
  const int lane = threadIdx.x;
  const int quads = (p.width + 3) / 4;
  const int q = blockIdx.x * 32 + lane;
  const int X0 = q * 4;
  const int Y0 = (blockIdx.y * EP_WARPS + threadIdx.y) * EP_STRIP;
  const int f = blockIdx.z;
  if (Y0 >= p.height) return;  // the whole warp
  const bool gray = p.ncomp == 1;
  QuadSamples y[EP_STRIP], u[EP_STRIP], v[EP_STRIP];
  component_any<FX0, FY0>(p, t, 0, f, Y0, q, quads, lane, y);
  if (!gray) {
    component_any<FXC, FYC>(p, t, 1, f, Y0, q, quads, lane, u);
    component_any<FXC, FYC>(p, t, 2, f, Y0, q, quads, lane, v);
  }
  if (q >= quads) return;  // a lane past the row's end only lends
  uint32_t* dst = out + ((size_t)f * p.height + Y0) * p.width + X0;
  const bool vector =
      (p.width & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
#pragma unroll
  for (int k = 0; k < EP_STRIP; ++k, dst += p.width) {
    if (Y0 + k >= p.height) break;
    const uint4 px = gray ? rgba_quad(true, false, y[k], y[k], y[k])
                          : rgba_quad(false, p.rgb, y[k], u[k], v[k]);
    if (vector) {
      *reinterpret_cast<uint4*>(dst) = px;
    } else {
      const uint32_t w[4] = {px.x, px.y, px.z, px.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (X0 + j < p.width) dst[j] = w[j];
    }
  }
}

using EpilogueKernel = void (*)(EpilogueTensors, uint32_t*, EpilogueParams);

// The instantiation for the parameters' factors: the common samplings each
// have their own, any other takes the factors from the parameters. Each
// pays: the one kernel that reads them from the parameters for every
// sampling (56 registers) ran 2-10 % slower on each of these at 4K
// (PERF.md).
EpilogueKernel pick_kernel(const EpilogueParams& p) {
  const bool luma_full = p.fx[0] == 1 && p.fy[0] == 1;
  if (p.ncomp == 1)
    return luma_full ? planes_epilogue_kernel<1, 1, 1, 1>
                     : planes_epilogue_kernel<0, 0, 0, 0>;
  if (luma_full && p.fx[1] == p.fx[2] && p.fy[1] == p.fy[2]) {
    const int fx = p.fx[1], fy = p.fy[1];
    if (fx == 1 && fy == 1) return planes_epilogue_kernel<1, 1, 1, 1>;  // 4:4:4
    if (fx == 2 && fy == 1) return planes_epilogue_kernel<1, 1, 2, 1>;  // 4:2:2
    if (fx == 2 && fy == 2) return planes_epilogue_kernel<1, 1, 2, 2>;  // 4:2:0
    if (fx == 1 && fy == 2) return planes_epilogue_kernel<1, 1, 1, 2>;  // 4:4:0
    if (fx == 4 && fy == 1) return planes_epilogue_kernel<1, 1, 4, 1>;  // 4:1:1
  }
  return planes_epilogue_kernel<0, 0, 0, 0>;
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
  const int rows_per_block = EP_WARPS * EP_STRIP;
  if (p->frames < 1 || p->frames > 65535 || (p->ncomp != 1 && p->ncomp != 3) ||
      p->width < 1 || p->height < 1 ||
      (p->height + rows_per_block - 1) / rows_per_block > 65535)
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
  const dim3 grid((quads + 31) / 32,
                  (p->height + rows_per_block - 1) / rows_per_block,
                  p->frames);
  pick_kernel(*p)<<<grid, dim3(32, EP_WARPS), 0, (cudaStream_t)stream>>>(
      t, (uint32_t*)out, *p);
  return (int)cudaGetLastError();
}

}  // extern "C"
