// The decode kernels of compeg_tpu_torch, for Hopper (sm_90a).
//
// entropy_kernel (K1) replaces the Pallas kernel entropy_decode
// (compeg_tpu/ops/entropy.py:440, body _make_kernel :365): it writes every
// restart segment's raw zigzag coefficients, [nseg, ri, dus, 64] int32.
//
// fused_decode_kernel (K2) replaces the Pallas kernel fused_decode_blocks
// (compeg_tpu/ops/fused.py:419, body _make_fused_kernel :63, default mode)
// and the XLA raster assembly after it (assemble_image*, fused.py:534-570):
// entropy decode -> dequant + f32 8x8 IDCT -> nearest upsampling, integer
// BT.601 and packed RGBA, written straight into the raster [H, W] image.
//
// What bounds them on the H100. K1 is bound by its bit-serial entropy
// decode: each thread decodes one segment symbol by symbol, a chain of
// dependent shifts, compares and table loads, and the threads of a warp
// diverge on code lengths and symbol counts. The 4K frame (Ri 1) has 64,800
// segments, about 2,025 warps over 132 SMs, barely one wave, so its time is
// close to that of the slowest warps on each SM. K2 runs the same entropy
// phase but is bound by its IDCT and composite phases: the IDCT's warp walks
// the 64 coefficients of a data unit one by one from shared memory, and the
// composite's integer index maths runs per pixel; both run far below the
// card's FMA and memory rates and are the first things to make fast
// (PERF.md has the measured split).
//
// What the design does about it: the Huffman tables live in shared memory,
// the bit window and DC predictors in registers, and the entropy phase does
// nothing but decode. K2 keeps a block's coefficients in shared memory, so
// nothing but the words goes in and nothing but pixels comes out; its IDCT
// is spread over all four warps of the block, one warp per data unit, with
// the operator read z-major so a warp's loads are contiguous, and it skips
// the zero coefficients, which are the same for every lane of the warp (the
// sum is the same FMA chain in the same order, minus terms that add 0).

#include <cuda_runtime.h>

#include "entropy.cuh"

namespace {

constexpr int K1_THREADS = 128;
constexpr int K2_SEGS = 32;      // segments per block (one per lane of warp 0)
constexpr int K2_THREADS = 128;  // four warps share the IDCT and composite

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

__global__ void __launch_bounds__(K2_THREADS)
fused_decode_kernel(const uint32_t* __restrict__ rows,
                    const int* __restrict__ tables,
                    const float* __restrict__ lq_t,
                    uint32_t* __restrict__ out, const DecodeParams p) {
  extern __shared__ int smem[];
  int* tab = smem;
  int* coef = smem + MAX_TABLE_INTS;  // [K2_SEGS][dus][64], pixels after IDCT
  load_tables(tab, tables, p.ncomp * 2 * TAB_INTS);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seg0 = blockIdx.x * K2_SEGS;
  const int per_mcu = p.dus * 64;
  const int max_h = max(p.comp_h[0], max(p.comp_h[1], p.comp_h[2]));
  const int max_v = max(p.comp_v[0], max(p.comp_v[1], p.comp_v[2]));
  const int mh = 8 * (p.ncomp == 1 ? 1 : max_v);
  const int mw = 8 * (p.ncomp == 1 ? 1 : max_h);
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

    // ---- phase 2: dequant + IDCT, one warp per data unit ------------------
    // pixel p = sum_z lq_t[d][z][p] * c[z] in f32 (FMA, z ascending), then
    // +128.5, clamp to [0, 255], truncate; written over the coefficients.
    for (int u = warp; u < K2_SEGS * p.dus; u += K2_THREADS / 32) {
      const int sl = u / p.dus;
      if (m >= segment_mcus(p, seg0 + sl)) continue;  // warp-uniform
      const int d = u - sl * p.dus;
      int* c = coef + u * 64;
      const float* op = lq_t + (size_t)d * 64 * 64;
      float acc0 = 0.f, acc1 = 0.f;
      for (int z = 0; z < 64; ++z) {
        const int cz = c[z];
        if (cz != 0) {
          const float fz = (float)cz;
          acc0 = fmaf(__ldg(op + z * 64 + lane), fz, acc0);
          acc1 = fmaf(__ldg(op + z * 64 + lane + 32), fz, acc1);
        }
      }
      __syncwarp();
      c[lane] = (int)fminf(fmaxf(acc0 + 128.5f, 0.f), 255.f);
      c[lane + 32] = (int)fminf(fmaxf(acc1 + 128.5f, 0.f), 255.f);
    }
    __syncthreads();

    // ---- phase 3: composite into the raster -------------------------------
    // Neighbouring threads take neighbouring x of one pixel row across the
    // block's MCUs (compeg_tpu/ops/fused.py rgba_at :290-326).
    const int yh = p.comp_h[0], yv = p.comp_v[0];
    const int ch = p.comp_h[1], cv = p.comp_v[1];
    for (int i = tid; i < K2_SEGS * mh * mw; i += K2_THREADS) {
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
      const int yp = ((r * yv * 8 / mh) % 8) * 8 + ((x * yh * 8 / mw) % 8);
      const int y = px[yslot * 64 + yp];
      int rr, gg, bb;
      if (p.ncomp == 1) {
        rr = gg = bb = y;
      } else {
        const int cp = (r * cv * 8 / mh) * 8 + (x * ch * 8 / mw);
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
    __syncthreads();  // the next MCU's zeroing overwrites these pixels
  }
}

size_t fused_smem_bytes(int dus) {
  return sizeof(int) * (MAX_TABLE_INTS + (size_t)K2_SEGS * dus * 64);
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

int compeg_fused_decode(const void* rows, const void* tables, const void* lq_t,
                        void* out, const DecodeParams* p, void* stream) {
  if (p->nseg > 0) {
    const size_t smem = fused_smem_bytes(p->dus);
    cudaError_t err = cudaFuncSetAttribute(
        fused_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (p->nseg + K2_SEGS - 1) / K2_SEGS;
    fused_decode_kernel<<<blocks, K2_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)rows, (const int*)tables, (const float*)lq_t,
        (uint32_t*)out, *p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
