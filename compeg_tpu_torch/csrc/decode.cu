// The decode kernels of compeg_tpu_torch, for Hopper (sm_90a).
//
// entropy_kernel (K1) replaces the Pallas kernel entropy_decode
// (compeg_tpu/ops/entropy.py:440, body _make_kernel :365): it writes every
// restart segment's raw zigzag coefficients, [nseg, ri, dus, 64] int32.
//
// fused_decode_kernel<IDCT, OUT> replaces the Pallas kernels built from
// _make_fused_kernel (compeg_tpu/ops/fused.py:63) and the XLA assembly after
// them. One launch decodes a batch of same-geometry frames (the JAX package
// concatenates their blocks along the grid, compeg_tpu/batch.py:71); here
// the frame is the grid's second dimension. Phase 1, the entropy decode, is the same in every mode; phase 2
// (IDCT) and phase 3 (output) are chosen by the template arguments:
//
//   K2  <kIdctFloat,  kOutRgba>    fused_decode_blocks (fused.py:419), default
//       mode: dequant + f32 8x8 IDCT -> nearest upsampling, integer BT.601,
//       packed RGBA written straight into the raster [H, W]
//   K2x <kIdctInt,    kOutRgba>    the same with exact_idct (fused.py:162-222):
//       the 13-bit integer Loeffler IDCT of csrc/int_idct.cuh, byte-identical
//       to golden.decode_rgb(idct="int")
//   K3  <kIdct*,      kOutPlanes>  fused_decode_planes (fused.py:580, phase 3
//       :328-365), float or integer IDCT: one u8 plane per component at its
//       own resolution, MCU-padded [height_mcus*8*v, width_mcus*8*h]; the
//       chroma upsampling and colour conversion run after it as torch ops
//       (ops/color.py), because the vertical triangle filter spans MCU rows
//       and so segments
//   K2s <kIdctScaled, kOutRgba>    fused_decode_blocks with scale=k
//       (fused.py:140-161): the k-point scaled IDCT, k in {1, 2, 4}, and the
//       composite of k x k blocks into the [ceil(H*k/8), ceil(W*k/8)] raster
//
// What bounds them on the H100. K1 is bound by its bit-serial entropy
// decode: each thread decodes one segment symbol by symbol, a chain of
// dependent shifts, compares and table loads, and the threads of a warp
// diverge on code lengths and symbol counts. The 4K frame (Ri 1) has 64,800
// segments, about 2,025 warps over 132 SMs, barely one wave, so its time is
// close to that of the slowest warps on each SM. The fused kernels run the
// same entropy phase but are bound by their IDCT and output phases: the
// float IDCT's warp walks the 64 coefficients of a data unit one by one from
// shared memory, and the composite's integer index maths runs per pixel;
// both run far below the card's FMA and memory rates and are the first
// things to make fast (PERF.md has the measured split). The integer IDCT is
// cheaper than the float one (about 80 integer operations per column or row
// and no operator loads); the scaled IDCT reads only the first 1, 5 or 25
// zigzag coefficients; K3 writes a quarter of K2's bytes, one byte per
// sample.
//
// What the design does about it: the Huffman tables live in shared memory,
// the bit window and DC predictors in registers, and the entropy phase does
// nothing but decode. A block keeps its segments' coefficients in shared
// memory, so nothing but the words goes in and nothing but pixels comes out;
// every IDCT writes its pixels over the coefficients it read. The float and
// scaled IDCTs are spread over all four warps of the block, one warp per data
// unit, with the operator read z-major so a warp's loads are contiguous, and
// they skip the zero coefficients, which are the same for every lane of the
// warp (the sum is the same FMA chain in the same order, minus terms that add
// 0). The integer IDCT gives each data unit 8 threads, one column each and
// then one row each, exchanging through shared memory (the reference's own
// IDCT shape, SURVEY.md 3.4-3.5).

#include <cuda_runtime.h>

#include "entropy.cuh"
#include "int_idct.cuh"

namespace {

constexpr int K1_THREADS = 128;
constexpr int K2_SEGS = 32;      // segments per block (one per lane of warp 0)
constexpr int K2_THREADS = 128;  // four warps share the IDCT and output

enum IdctMode { kIdctFloat, kIdctInt, kIdctScaled };
enum OutMode { kOutRgba, kOutPlanes };

// The fused kernels' outputs: the packed RGBA raster in [0], or one u8 plane
// per component (null past the frame's components).
struct Outputs {
  void* ptr[3];
};

__device__ __forceinline__ void load_tables(int* dst, const int* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
}

__global__ void __launch_bounds__(K1_THREADS)
entropy_kernel(const uint32_t* __restrict__ rows, const int* __restrict__ tables,
               int* __restrict__ out, const DecodeParams p) {
  __shared__ int tab[MAX_TABLE_INTS];
  load_tables(tab, tables, p.ncomp * 2 * TAB_INTS);
  __syncthreads();
  const int seg = blockIdx.x * K1_THREADS + threadIdx.x;
  if (seg >= p.nseg) return;
  const int per_mcu = p.dus * 64;
  int* seg_out = out + (size_t)seg * p.ri * per_mcu;
  // Zero the segment's block first: padding MCUs past a short final
  // interval stay zero, and decode_mcu stores only DC and nonzero AC.
  int4* z4 = reinterpret_cast<int4*>(seg_out);
  for (int i = 0; i < p.ri * per_mcu / 4; ++i) z4[i] = make_int4(0, 0, 0, 0);
  const int nm = segment_mcus(p, seg);
  BitReader br;
  br.init(rows + (size_t)seg * p.words, p.words);
  int dp[3] = {0, 0, 0};
  for (int m = 0; m < nm; ++m) {
    int* mcu_out = seg_out + m * per_mcu;
    decode_mcu(br, dp, tab, p,
               [&](int d, int pos, int v) { mcu_out[d * 64 + pos] = v; });
  }
}

// Phase 2, float and scaled: pixel q = sum_z op[d][z][q] * c[z] in f32 (FMA,
// z ascending), then +128.5, clamp to [0, 255], truncate; npx pixels per data
// unit (64, or k*k), lane q and q + 32. op is lq_t [DUS, 64, npx].
template <int IDCT>
__device__ __forceinline__ void idct_float(int* coef, const float* __restrict__ op,
                                           const DecodeParams& p, int m, int seg0) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int npx = IDCT == kIdctScaled ? p.blk * p.blk : 64;
  const int zlen = IDCT == kIdctScaled ? p.zlen : 64;
  for (int u = warp; u < K2_SEGS * p.dus; u += K2_THREADS / 32) {
    const int sl = u / p.dus;
    if (m >= segment_mcus(p, seg0 + sl)) continue;  // warp-uniform
    const int d = u - sl * p.dus;
    int* c = coef + u * 64;
    const float* opd = op + (size_t)d * 64 * npx;
    float acc0 = 0.f, acc1 = 0.f;
    for (int z = 0; z < zlen; ++z) {
      const int cz = c[z];
      if (cz != 0) {
        const float fz = (float)cz;
        if (lane < npx) acc0 = fmaf(__ldg(opd + z * npx + lane), fz, acc0);
        if (lane + 32 < npx) acc1 = fmaf(__ldg(opd + z * npx + lane + 32), fz, acc1);
      }
    }
    __syncwarp();
    if (lane < npx) c[lane] = (int)fminf(fmaxf(acc0 + 128.5f, 0.f), 255.f);
    if (lane + 32 < npx) c[lane + 32] = (int)fminf(fmaxf(acc1 + 128.5f, 0.f), 255.f);
  }
}

// Phase 2, integer: 8 threads per data unit, 16 data units per round. Thread
// c dequantizes and transforms column c (natural position 8r + c reads
// zigzag slot kZigzag[8r + c]), writes it back in natural order descaled by
// CONST_BITS - PASS1_BITS, then transforms row c, descales by CONST_BITS +
// PASS1_BITS + 3, adds 128 and clamps. Segments past their end transform
// zeroed coefficients, which nothing reads, so every thread of a warp takes
// every __syncwarp.
__device__ __forceinline__ void idct_int(int* coef, const int* qz_s, const int* zz_s,
                                         const DecodeParams& p) {
  using namespace int_idct;
  const int c = threadIdx.x & 7;
  for (int u = threadIdx.x >> 3; u < K2_SEGS * p.dus; u += K2_THREADS / 8) {
    int* blk = coef + u * 64;
    const int* q = qz_s + (u % p.dus) * 64;
    uint32_t s[8], o[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int z = zz_s[r * 8 + c];
      s[r] = dequant(blk[z], q[z]);
    }
    idct8(s, o);
    __syncwarp();  // every column is read before any is overwritten
#pragma unroll
    for (int r = 0; r < 8; ++r) blk[r * 8 + c] = descale(o[r], CONST_BITS - PASS1_BITS);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = (uint32_t)blk[c * 8 + k];
    idct8(s, o);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int v = descale(o[k], CONST_BITS + PASS1_BITS + 3) + 128;
      blk[c * 8 + k] = min(max(v, 0), 255);
    }
  }
}

// Phase 3, RGBA: neighbouring threads take neighbouring x of one pixel row
// across the block's MCUs (compeg_tpu/ops/fused.py rgba_at :290-326, with
// blk = pixels per data-unit side).
__device__ __forceinline__ void composite_rgba(const int* coef, uint32_t* out,
                                               const DecodeParams& p, int m,
                                               int seg0, int blk) {
  const int per_mcu = p.dus * 64;
  const int max_h = max(p.comp_h[0], max(p.comp_h[1], p.comp_h[2]));
  const int max_v = max(p.comp_v[0], max(p.comp_v[1], p.comp_v[2]));
  const int mh = blk * (p.ncomp == 1 ? 1 : max_v);
  const int mw = blk * (p.ncomp == 1 ? 1 : max_h);
  const int yh = p.comp_h[0], yv = p.comp_v[0];
  const int ch = p.comp_h[1], cv = p.comp_v[1];
  for (int i = threadIdx.x; i < K2_SEGS * mh * mw; i += K2_THREADS) {
    const int x = i % mw;
    const int t = i / mw;
    const int sl = t % K2_SEGS;
    const int r = t / K2_SEGS;
    const int seg = seg0 + sl;
    if (m >= segment_mcus(p, seg)) continue;
    const int mcu = seg * p.ri + m;
    const int my = mcu / p.width_mcus;
    const int mx = mcu - my * p.width_mcus;
    const int Y = my * mh + r;
    const int X = mx * mw + x;
    if (Y >= p.height || X >= p.width) continue;
    const int* px = coef + sl * per_mcu;
    const int yslot = (r * yv / mh) * yh + (x * yh / mw);
    const int yp = ((r * yv * blk / mh) % blk) * blk + ((x * yh * blk / mw) % blk);
    const int y = px[yslot * 64 + yp];
    int rr, gg, bb;
    if (p.ncomp == 1) {
      rr = gg = bb = y;
    } else {
      const int cp = (r * cv * blk / mh) * blk + (x * ch * blk / mw);
      const int c1 = px[p.comp_slot[1] * 64 + cp];
      const int c2 = px[p.comp_slot[2] * 64 + cp];
      if (p.rgb) {
        rr = y;
        gg = c1;
        bb = c2;
      } else {
        const int cb = c1 - 128, cr = c2 - 128;
        rr = y + ((45 * cr) >> 5);
        gg = y - ((11 * cb + 23 * cr) >> 5);
        bb = y + ((113 * cb) >> 6);
      }
    }
    rr = min(max(rr, 0), 255);
    gg = min(max(gg, 0), 255);
    bb = min(max(bb, 0), 255);
    out[(size_t)Y * p.width + X] =
        (uint32_t)rr | ((uint32_t)gg << 8) | ((uint32_t)bb << 16) | 0xFF000000u;
  }
}

// Phase 3, planes: every sample of the block's MCUs to its component plane,
// row (my * v + k / h) * 8 + py, column (mx * h + k % h) * 8 + px for the
// k-th data unit of a component sampled (h, v); 8 neighbouring threads write
// 8 neighbouring bytes of one plane row.
__device__ __forceinline__ void store_planes(const int* coef, const Outputs& o,
                                             const DecodeParams& p, int m,
                                             int seg0) {
  const int per_mcu = p.dus * 64;
  for (int i = threadIdx.x; i < K2_SEGS * per_mcu; i += K2_THREADS) {
    const int sl = i / per_mcu;
    const int seg = seg0 + sl;
    if (m >= segment_mcus(p, seg)) continue;
    const int d = (i - sl * per_mcu) >> 6;
    const int pix = i & 63;
    const int mcu = seg * p.ri + m;
    const int my = mcu / p.width_mcus;
    const int mx = mcu - my * p.width_mcus;
    const int comp = p.du_to_comp[d];
    const int h = p.comp_h[comp], v = p.comp_v[comp];
    const int k = d - p.comp_slot[comp];
    const int row = (my * v + k / h) * 8 + (pix >> 3);
    const int col = (mx * h + k % h) * 8 + (pix & 7);
    uint8_t* plane = static_cast<uint8_t*>(o.ptr[comp]);
    plane[(size_t)row * (p.width_mcus * 8 * h) + col] = (uint8_t)coef[i];
  }
}

template <int IDCT, int OUT>
__global__ void __launch_bounds__(K2_THREADS)
fused_decode_kernel(const uint32_t* __restrict__ rows,
                    const int* __restrict__ tables, const void* __restrict__ op,
                    const Outputs outs, const DecodeParams p) {
  extern __shared__ int smem[];
  int* tab = smem;
  int* coef = smem + MAX_TABLE_INTS;  // [K2_SEGS][dus][64], pixels after IDCT
  // Integer mode: the quantizers [dus][64] and the zigzag table.
  __shared__ int qz_s[IDCT == kIdctInt ? 6 * 64 : 1];
  __shared__ int zz_s[IDCT == kIdctInt ? 64 : 1];
  load_tables(tab, tables, p.ncomp * 2 * TAB_INTS);
  if (IDCT == kIdctInt) {
    load_tables(qz_s, static_cast<const int*>(op), p.dus * 64);
    for (int i = threadIdx.x; i < 64; i += K2_THREADS) zz_s[i] = int_idct::kZigzag[i];
  }

  const int tid = threadIdx.x;
  // A batch stacks its frames along blockIdx.y: segments, MCUs and output
  // coordinates below are the frame's own, and only the row and output
  // pointers move with the frame, so no block straddles two frames.
  const size_t frame = blockIdx.y;
  rows += frame * p.frame_rows * p.words;
  Outputs out = outs;
  if (OUT == kOutPlanes) {
    const size_t height_mcus = p.total_mcus / p.width_mcus;
    for (int c = 0; c < p.ncomp; ++c)
      out.ptr[c] = static_cast<uint8_t*>(out.ptr[c]) +
                   frame * (height_mcus * 8 * p.comp_v[c]) *
                       ((size_t)p.width_mcus * 8 * p.comp_h[c]);
  } else {
    out.ptr[0] = static_cast<uint32_t*>(out.ptr[0]) +
                 frame * p.height * (size_t)p.width;
  }
  const int seg0 = blockIdx.x * K2_SEGS;
  const int per_mcu = p.dus * 64;
  // Segment counts only shrink at the frame's end, so the block's first
  // segment has the most MCUs.
  const int m_end = segment_mcus(p, seg0);

  // Phase-1 state of this thread's segment (threads 0..K2_SEGS-1).
  const int my_seg = seg0 + tid;
  const int my_nm = tid < K2_SEGS ? segment_mcus(p, my_seg) : 0;
  BitReader br;
  if (my_nm > 0) br.init(rows + (size_t)my_seg * p.words, p.words);
  int dp[3] = {0, 0, 0};

  for (int m = 0; m < m_end; ++m) {
    for (int i = tid; i < K2_SEGS * per_mcu; i += K2_THREADS) coef[i] = 0;
    __syncthreads();  // also publishes the tables on the first pass

    // ---- phase 1: entropy decode of MCU m of each segment ----------------
    if (m < my_nm) {
      int* c = coef + tid * per_mcu;
      decode_mcu(br, dp, tab, p,
                 [&](int d, int pos, int v) { c[d * 64 + pos] = v; });
    }
    __syncthreads();

    // ---- phase 2: dequant + IDCT, pixels over the coefficients -----------
    if (IDCT == kIdctInt) {
      idct_int(coef, qz_s, zz_s, p);
    } else {
      idct_float<IDCT>(coef, static_cast<const float*>(op), p, m, seg0);
    }
    __syncthreads();

    // ---- phase 3: output --------------------------------------------------
    if (OUT == kOutPlanes) {
      store_planes(coef, out, p, m, seg0);
    } else {
      composite_rgba(coef, static_cast<uint32_t*>(out.ptr[0]), p, m, seg0,
                     IDCT == kIdctScaled ? p.blk : 8);
    }
    __syncthreads();  // the next MCU's zeroing overwrites these pixels
  }
}

template <int IDCT, int OUT>
int launch_fused(const void* rows, const void* tables, const void* op,
                 Outputs out, const DecodeParams* p, void* stream) {
  if (p->nseg > 0 && p->frames > 0) {
    auto kernel = fused_decode_kernel<IDCT, OUT>;
    const size_t smem = sizeof(int) * (MAX_TABLE_INTS + (size_t)K2_SEGS * p->dus * 64);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((p->nseg + K2_SEGS - 1) / K2_SEGS, p->frames);
    kernel<<<grid, K2_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)rows, (const int*)tables, op, out, *p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* compeg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int compeg_entropy_decode(const void* rows, const void* tables, void* out,
                          const DecodeParams* p, void* stream) {
  if (p->nseg > 0) {
    const int blocks = (p->nseg + K1_THREADS - 1) / K1_THREADS;
    entropy_kernel<<<blocks, K1_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)rows, (const int*)tables, (int*)out, *p);
  }
  return (int)cudaGetLastError();
}

// K2: op = lq_t [dus, 64, 64] f32.
int compeg_fused_decode(const void* rows, const void* tables, const void* op,
                        void* out, const DecodeParams* p, void* stream) {
  return launch_fused<kIdctFloat, kOutRgba>(rows, tables, op, {{out, 0, 0}}, p,
                                            stream);
}

// K2x: op = quantizers [dus, 64] int32.
int compeg_fused_decode_exact(const void* rows, const void* tables,
                              const void* op, void* out, const DecodeParams* p,
                              void* stream) {
  return launch_fused<kIdctInt, kOutRgba>(rows, tables, op, {{out, 0, 0}}, p,
                                          stream);
}

// K3, float IDCT: op as K2; planes y, cb, cr (null past the components).
int compeg_fused_decode_planes(const void* rows, const void* tables,
                               const void* op, void* y, void* cb, void* cr,
                               const DecodeParams* p, void* stream) {
  return launch_fused<kIdctFloat, kOutPlanes>(rows, tables, op, {{y, cb, cr}},
                                              p, stream);
}

// K3, integer IDCT: op as K2x.
int compeg_fused_decode_planes_exact(const void* rows, const void* tables,
                                     const void* op, void* y, void* cb,
                                     void* cr, const DecodeParams* p,
                                     void* stream) {
  return launch_fused<kIdctInt, kOutPlanes>(rows, tables, op, {{y, cb, cr}}, p,
                                            stream);
}

// K2s: op = scaled lq_t [dus, 64, k*k] f32; p->blk = k, p->width and
// p->height are the scaled frame's.
int compeg_fused_decode_scaled(const void* rows, const void* tables,
                               const void* op, void* out, const DecodeParams* p,
                               void* stream) {
  return launch_fused<kIdctScaled, kOutRgba>(rows, tables, op, {{out, 0, 0}},
                                             p, stream);
}

}  // extern "C"
