// The decode kernels of compeg_tpu_torch, for Hopper (sm_90a).
//
// fused_decode_kernel<IDCT, OUT, BANDED, LANES> replaces the Pallas kernels
// built from _make_fused_kernel (compeg_tpu/ops/fused.py:63) and the XLA
// assembly after them, and the entropy kernel entropy_decode
// (compeg_tpu/ops/entropy.py:440, body _make_kernel :365). One launch
// decodes a batch of same-geometry frames (the JAX package concatenates
// their blocks along the grid, compeg_tpu/batch.py:71); here the frame is
// the grid's second dimension.
// Phase 1, the entropy decode, is the same in every mode; phase 2 (IDCT)
// and phase 3 (output) are chosen by the template arguments:
//
//   K1  <kIdctNone,   kOutCoefs>   entropy_decode: every restart segment's
//       raw zigzag coefficients, [nseg, ri, dus, 64] int32
//   K2  <kIdctFloat,  kOutRgba>    fused_decode_blocks (fused.py:419), default
//       mode: dequant + f32 8x8 IDCT -> nearest upsampling, integer BT.601,
//       packed RGBA written straight into the raster [H, W]
//   K2x <kIdctInt,    kOutRgba>    the same with exact_idct (fused.py:162-222):
//       the 13-bit integer Loeffler IDCT of csrc/int_idct.cuh, byte-identical
//       to golden.decode_rgb(idct="int")
//   K3  <kIdct*,      kOutPlanes>  fused_decode_planes (fused.py:580, phase 3
//       :328-365), float or integer IDCT: one u8 plane per component at its
//       own resolution, MCU-padded [height_mcus*8*v, width_mcus*8*h]; the
//       chroma upsampling and colour conversion run after it in the planes
//       epilogue (csrc/epilogue.cu), because the vertical triangle filter
//       spans MCU rows and so segments
//   K2s <kIdctScaled, kOutRgba>    fused_decode_blocks with scale=k
//       (fused.py:140-161): the k-point scaled IDCT, k in {1, 2, 4}, and the
//       composite of k x k blocks into the [ceil(H*k/8), ceil(W*k/8)] raster
//
// K2, K2x and K3 have a third argument BANDED: the banded decode
// (parallel/sharding.py) launches <IDCT, OUT, true, false>, whose frames are
// bands that decode only their MCUs inside the image (DecodeParams::bands),
// the JAX package's seg_mcus gate. A fourth, LANES: a frame whose restart
// segments are long (one segment, with no restart markers) is launched as
// lanes of a few MCUs each, <IDCT, OUT, false, true>, every lane starting
// from its entry of the table that the lane index (kernel L, at the end of
// this file) found; every other launch takes <IDCT, OUT, false, false>.
//
// What bounds them on the H100. None comes near the card's memory or FMA
// rate: a 4K frame is 2 MB in and 33 MB out, microseconds of traffic. The
// time is the entropy decode's: each thread decodes one restart segment
// symbol by symbol, a chain of dependent shifts, compares and table loads,
// and the 32 threads of a warp wait for the one with the most symbols in
// every data unit. K1 is that and the stores of its 64 words per data unit
// (66 MB at 4K). A block of 32 segments decodes with one warp while
// its other warps wait, so what counts is how many blocks a multiprocessor
// holds at once (their decoding warps run side by side), how short the
// phases around the decode are, and how few instructions they execute: the
// float IDCT is bound by its instruction count (a term of its sum is one FMA,
// and the frame has millions of nonzero coefficients), the composite by
// its index arithmetic and the width of its stores. PERF.md has the
// measured split.
//
// What the design does about it.
//  * Phase 1: the block's rows and the Huffman tables come into shared
//    memory by asynchronous copies started before anything else, so a bit
//    reader's refill waits on shared memory, not on device memory; the bit
//    window and DC predictors live in registers. A symbol costs one
//    first-level lookup unless its code is longer than LUT_BITS
//    (csrc/entropy.cuh decode_symbol); a frame's distinct tables are packed
//    once each, 1.3 KB a table. Spreading the 32 decoding
//    threads over several warps made it slower (every warp then runs the
//    whole instruction stream for a few lanes), so warp 0 decodes.
//  * The tile: a block keeps its segments' coefficients in shared memory,
//    so nothing but the words goes in and nothing but pixels comes out;
//    every IDCT writes its pixels over the coefficients it read. Its
//    elements are 16 bits wide in every mode (struct Tile; the DC, which may
//    wrap in 32 bits, lies beside it), which lets eight blocks share a
//    multiprocessor where a 32-bit tile let five; a segment's stride is odd
//    in words, so that the 32 segments' words of one sample lie in 32 banks.
//  * Phase 2, float: zero coefficients are skipped, found with ballots
//    and not by walking the 64 positions, and a lane takes eight pixels
//    of a data unit, so a nonzero costs it two 16-byte operator loads and
//    eight FMAs (idct_float). Each pixel's sum keeps its terms and their
//    order, so the result does not depend on how lanes and pixels are
//    paired. A dense product on the tensor cores would do several times
//    the arithmetic the nonzeros need, and in TF32 it would need a split
//    operator to stay inside PARITY.md's envelope and would no longer give
//    the plain sum bit for bit; it was not needed to get under the entropy
//    phase's time.
//  * Phase 2, integer: 8 threads per data unit, one column each and then
//    one row each (the reference's own IDCT shape, SURVEY.md 3.4-3.5); about
//    80 integer operations per column or row and no operator loads. The
//    eight lanes exchange columns for rows in registers, by warp shuffles
//    (transpose8), so the 32-bit values between the passes never touch the
//    tile.
//  * Phase 2, scaled: only the first 1, 5 or 25 zigzag coefficients are
//    read, so only those are zeroed; a thread per data unit at k = 1 and 2,
//    four lanes of four pixels at k = 4 (idct_scaled).
//  * Phase 3, RGBA: the sample offsets of an MCU's pixels come from the
//    host, a segment's place in the frame is worked out once per segment, a
//    thread composes four neighbouring pixels and stores 16 bytes where the
//    raster allows (composite_rgba).
//  * Phase 3, planes: a thread takes one sample row of one store unit (a
//    data unit, or two that lie side by side in their plane) of one segment,
//    packs its 8 or 16 samples and stores them at once; the 32 lanes of a
//    warp take the 32 segments' same row, which with restart interval 1 are
//    neighbouring MCUs, so a warp writes one run of a plane row. The units'
//    places come from the host (p.unit_*, ops/fused.plane_offsets)
//    (store_planes).
//  * Phase 3, coefficients (K1): the decoded MCU of the 32 segments goes out
//    from the tile in 16-byte stores, a warp writing one segment's run of
//    dus * 256 bytes at a time (with restart interval 1 the block's 32
//    segments are one run), and the tile is zeroed as it is read
//    (store_coefs). Padding MCUs past a short final interval come out zero.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <atomic>

#include "color.cuh"
#include "entropy.cuh"
#include "int_idct.cuh"

namespace {

constexpr int K2_SEG_BITS = 5;
constexpr int K2_SEGS = 1 << K2_SEG_BITS;  // segments per block: warp 0's lanes
constexpr int MAX_DEVICES = 64;
// A block's rows are copied to shared memory when they take no more words
// than this (rows of up to 64 words); longer rows are read where they lie.
constexpr int ROW_CACHE_WORDS = 2048;

__device__ __host__ __forceinline__ int row_cache_words(int words) {
  return K2_SEGS * words <= ROW_CACHE_WORDS ? K2_SEGS * words : 0;
}

// A segment's coefficients take dus * 64 elements of the tile and one word
// of padding: the odd stride in words puts the 32 segments' words of one
// sample, which the composite reads together, in different banks.
__device__ __host__ __forceinline__ int tile_stride(int dus, int elem_bytes) {
  return dus * 64 + 4 / elem_bytes;
}

// Where MCU m of the block's segments lies in the frame, filled by warp 0
// before each pass: MCU row and column, my < 0 for a segment that has no
// MCU m (past the frame's end, or a short last interval).
struct SegmentPos {
  int my[K2_SEGS];
  int mx[K2_SEGS];
};

enum IdctMode { kIdctFloat, kIdctInt, kIdctScaled, kIdctNone };
enum OutMode { kOutRgba, kOutPlanes, kOutCoefs };

// The tile's element. AC coefficients take 16 bits (an AC value has at most
// 15 magnitude bits) and the DC, whose predictor may wrap in 32 bits on
// garbage input, lies in a word of its own beside the tile: half the shared
// memory of a 32-bit tile, so more blocks on a multiprocessor. The tile only
// ever holds raw coefficients and final pixels 0..255; the integer IDCT's
// 32-bit values between its passes stay in registers.
//
// A block's threads and the blocks a multiprocessor is to hold (which caps
// the registers) follow the tile: at 4 data units per MCU eight blocks of
// the 16-bit tile fit, of four warps each, in every mode (the integer IDCT
// at eight warps and five blocks read a third slower, PERF.md).
template <int IDCT>
struct Tile {
  using T = short;
  static constexpr int THREADS = 128;
  static constexpr int BLOCKS = 8;
};

// The fused kernels' outputs: the packed RGBA raster or K1's coefficients in
// [0], or one u8 plane per component (null past the frame's components).
struct Outputs {
  void* ptr[3];
};

__device__ __forceinline__ void load_tables(int* dst, const int* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
}

// Start the copy of n words to shared memory (dst 16-byte aligned) without
// waiting for it: 16 bytes a request where src is aligned too, then the
// words left over. __pipeline_wait_prior(0) and a barrier publish it.
__device__ __forceinline__ void copy_async(int* dst, const int* src, int n) {
  const int n4 = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? n >> 2 : 0;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
  for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x)
    __pipeline_memcpy_async(dst + i, src + i, 4);
  __pipeline_commit();
}

// Phase 2, float: pixel q = sum_z op[d][z][q] * c[z] in f32 (FMA, z
// ascending), then +128.5, clamp to [0, 255], truncate. op is lq_t
// [DUS, 64, 64], 16-byte aligned.
//
// A warp takes four data units at a time, eight lanes each, a lane eight
// pixels (4l..4l+3 and 32+4l..32+4l+3): one nonzero coefficient then costs a
// lane two 16-byte operator loads and eight FMAs, where a lane with two
// pixels paid as many instructions around two FMAs. The nonzeros are found
// with the warp: for each of the four units every lane loads coefficients
// `lane` and `lane + 32`, and two ballots give the unit's 64-bit mask; each
// group of eight lanes then walks its own unit's set bits, z ascending,
// reading the coefficient's value from the tile. Every pixel's FMA chain
// holds the terms of the plain sum that are not zero, in the same order.
// The units go slot by slot, a slot's 32 segments spread over the warps, so
// every warp gets its share of the dense luma units and all warps read one
// operator's rows at a time.
__device__ __forceinline__ void idct_float(short* coef, const int* dc,
                                           const float* __restrict__ op,
                                           const DecodeParams& p,
                                           const SegmentPos& pos) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 3, l = lane & 7;
  const int stride = tile_stride(p.dus, 2);
  for (int t0 = warp * 4; t0 < K2_SEGS * p.dus; t0 += blockDim.x / 8) {
    const int d = t0 >> K2_SEG_BITS, sl0 = t0 & (K2_SEGS - 1);
    unsigned lo = 0, hi = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const short* ck = coef + (sl0 + k) * stride + d * 64;
      const int a = lane == 0 ? dc[(sl0 + k) * p.dus + d] : ck[lane];
      const unsigned ma = __ballot_sync(0xFFFFFFFFu, a != 0);
      const unsigned mb = __ballot_sync(0xFFFFFFFFu, ck[lane + 32] != 0);
      if (k == g) {
        lo = ma;
        hi = mb;
      }
    }
    const int sl = sl0 + g;
    const bool live = pos.my[sl] >= 0;  // else the tile holds no MCU of it
    if (!live) lo = hi = 0;
    short* c = coef + sl * stride + d * 64;
    const float4* opd = reinterpret_cast<const float4*>(op + (size_t)d * 4096) + l;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    auto term = [&](int z, float f) {
      const float4 w0 = __ldg(opd + z * 16), w1 = __ldg(opd + z * 16 + 8);
      acc[0] = fmaf(w0.x, f, acc[0]);
      acc[1] = fmaf(w0.y, f, acc[1]);
      acc[2] = fmaf(w0.z, f, acc[2]);
      acc[3] = fmaf(w0.w, f, acc[3]);
      acc[4] = fmaf(w1.x, f, acc[4]);
      acc[5] = fmaf(w1.y, f, acc[5]);
      acc[6] = fmaf(w1.z, f, acc[6]);
      acc[7] = fmaf(w1.w, f, acc[7]);
    };
    if (lo & 1u) {
      term(0, (float)dc[sl * p.dus + d]);
      lo &= ~1u;
    }
    while (lo) {
      const int z = __ffs(lo) - 1;
      lo &= lo - 1;
      term(z, (float)c[z]);
    }
    while (hi) {
      const int z = __ffs(hi) + 31;
      hi &= hi - 1;
      term(z, (float)c[z]);
    }
    __syncwarp();  // a unit's coefficients are read before its pixels land
    if (live) {
      short px[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        px[i] = (short)fminf(fmaxf(acc[i] + 128.5f, 0.f), 255.f);
      short2* lo2 = reinterpret_cast<short2*>(c + 4 * l);
      short2* hi2 = reinterpret_cast<short2*>(c + 32 + 4 * l);
      lo2[0] = make_short2(px[0], px[1]);
      lo2[1] = make_short2(px[2], px[3]);
      hi2[0] = make_short2(px[4], px[5]);
      hi2[1] = make_short2(px[6], px[7]);
    }
  }
}

// Phase 2, scaled: pixel q of a data unit is the same sum over the first
// zlen zigzag positions only (1, 5 or 25 for k = 1, 2, 4; the rest of the
// k-point operator is zero), npx = k * k pixels. op is lq_t [DUS, 64, npx].
// At k = 1 and 2 a thread takes a data unit (1 or 5 terms of 1 or 4
// pixels, the four as one 16-byte operator row), at k = 4 four lanes take
// one, four pixels each (25 terms, a 16-byte piece of the row each). The
// units go slot by slot as in idct_float, so a warp's lanes read one
// operator's rows. Zero coefficients are not skipped: fmaf(w, 0.f, acc) ==
// acc for finite w and acc, up to the sign of a zero, which + 128.5f
// erases, so each pixel's chain over z ascending gives the sparse chain's
// bits.
__device__ __forceinline__ short scaled_px(float acc) {
  return (short)fminf(fmaxf(acc + 128.5f, 0.f), 255.f);
}

template <int K>
__device__ __forceinline__ void idct_scaled(short* coef, const int* dc,
                                            const float* __restrict__ op,
                                            const DecodeParams& p,
                                            const SegmentPos& pos) {
  constexpr int NPX = K * K, ZLEN = K == 1 ? 1 : K == 2 ? 5 : 25;
  constexpr int LANES = K == 4 ? 4 : 1;  // lanes per data unit
  const int stride = tile_stride(p.dus, 2);
  const int l = threadIdx.x & (LANES - 1);
  // The trip count is the same for every thread (32 * dus units, a whole
  // number of passes), so the four lanes of a unit all reach __syncwarp.
  for (int u = threadIdx.x / LANES; u < K2_SEGS * p.dus;
       u += blockDim.x / LANES) {
    const int d = u >> K2_SEG_BITS, sl = u & (K2_SEGS - 1);
    const bool live = pos.my[sl] >= 0;  // else the tile holds no MCU of it
    short* c = coef + sl * stride + d * 64;
    const float f0 = (float)dc[sl * p.dus + d];
    if constexpr (K == 1) {
      if (live) c[0] = scaled_px(fmaf(__ldg(op + d * 64), f0, 0.f));
    } else {
      const float4* o =
          reinterpret_cast<const float4*>(op + (size_t)d * 64 * NPX) + l;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int z = 0; z < ZLEN; ++z) {
        const float f = z == 0 ? f0 : (float)c[z];
        const float4 w = __ldg(o + z * (NPX / 4));
        acc.x = fmaf(w.x, f, acc.x);
        acc.y = fmaf(w.y, f, acc.y);
        acc.z = fmaf(w.z, f, acc.z);
        acc.w = fmaf(w.w, f, acc.w);
      }
      if (LANES > 1) __syncwarp();  // the unit's coefficients are read
      if (live) {
        short2* px = reinterpret_cast<short2*>(c + 4 * l);
        px[0] = make_short2(scaled_px(acc.x), scaled_px(acc.y));
        px[1] = make_short2(scaled_px(acc.z), scaled_px(acc.w));
      }
    }
  }
}

// The 8 x 8 transposition between the integer IDCT's passes, in registers:
// lane c of a data unit's eight lanes holds a[r] = M[r][c] (column c) and
// leaves with a[k] = M[c][k] (row c). Three exchange stages, one per bit of
// the index: at the stage with mask m a lane whose number has bit m clear
// sends its register `hi` to lane ^ m and receives that lane's `lo` into
// `hi`; a lane with bit m set sends `lo` and receives into `lo`. The
// register indices are compile-time constants:
//   transpose8 stage mask 4: (0,4) (1,5) (2,6) (3,7)
//   transpose8 stage mask 2: (0,2) (1,3) (4,6) (5,7)
//   transpose8 stage mask 1: (0,1) (2,3) (4,5) (6,7)
// (tests/test_torch_plane_store.py follows this table in numpy). The masks
// are below 8, so every exchange stays inside the data unit's eight lanes;
// all 32 lanes of the warp must call it.
template <int M>
__device__ __forceinline__ void transpose8_stage(uint32_t a[8], bool set) {
#pragma unroll
  for (int lo = 0; lo < 8; ++lo) {
    if (lo & M) continue;
    const int hi = lo | M;
    const uint32_t got = __shfl_xor_sync(0xFFFFFFFFu, set ? a[lo] : a[hi], M);
    if (set)
      a[lo] = got;
    else
      a[hi] = got;
  }
}

__device__ __forceinline__ void transpose8(uint32_t a[8], int lane) {
  transpose8_stage<4>(a, lane & 4);
  transpose8_stage<2>(a, lane & 2);
  transpose8_stage<1>(a, lane & 1);
}

// Phase 2, integer: 8 threads per data unit, 16 data units per round of a
// 128-thread block, slot by slot like the float IDCT. Thread c dequantizes
// and transforms column c (natural position 8r + c reads zigzag slot
// kZigzag[8r + c], the DC from dc), descales it by CONST_BITS - PASS1_BITS,
// exchanges it for row c (transpose8; uint32 throughout, so garbage wraps
// like the reference's int32), transforms that, descales by CONST_BITS +
// PASS1_BITS + 3, adds 128, clamps and writes the row's eight pixels over
// the unit's coefficients. The exchange lies between the last read and the
// first write of a unit, and what a lane sends depends on all it read.
// Segments past their end transform zeroed coefficients, which nothing
// reads, so every thread of a warp takes every shuffle.
__device__ __forceinline__ void idct_int(short* coef, const int* dc,
                                         const int* qz_s, const int* zz_s,
                                         const DecodeParams& p) {
  using namespace int_idct;
  const int c = threadIdx.x & 7;
  const int stride = tile_stride(p.dus, 2);
  for (int u = threadIdx.x >> 3; u < K2_SEGS * p.dus; u += blockDim.x / 8) {
    const int d = u >> K2_SEG_BITS, sl = u & (K2_SEGS - 1);
    short* blk = coef + sl * stride + d * 64;
    const int* q = qz_s + d * 64;
    uint32_t s[8], o[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int z = zz_s[r * 8 + c];
      s[r] = dequant(z == 0 ? dc[sl * p.dus + d] : (int)blk[z], q[z]);
    }
    idct8(s, o);
#pragma unroll
    for (int r = 0; r < 8; ++r)
      s[r] = (uint32_t)descale(o[r], CONST_BITS - PASS1_BITS);
    transpose8(s, c);
    idct8(s, o);
    int px[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int v = descale(o[k], CONST_BITS + PASS1_BITS + 3) + 128;
      px[k] = min(max(v, 0), 255);
    }
    uint32_t* row = reinterpret_cast<uint32_t*>(blk + c * 8);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      row[k] = (uint32_t)px[2 * k] | ((uint32_t)px[2 * k + 1] << 16);
  }
}

// One RGBA word from a luma sample and its two other component samples
// (csrc/color.cuh rgba_pixel: integer BT.601, clamp, pack).
__device__ __forceinline__ uint32_t rgba_word(const DecodeParams& p, int y,
                                              int c1, int c2) {
  return rgba_pixel(p.ncomp == 1, p.rgb, y, c1, c2);
}

// Phase 3, RGBA (compeg_tpu/ops/fused.py rgba_at :290-326). A thread takes
// four neighbouring pixels of one pixel row of one MCU, neighbouring threads
// neighbouring quads along that row across the block's MCUs, and a quad is
// one 16-byte store where the raster allows it: rows of whole quads
// (width % 4 == 0, MCUs of whole quads) from a 16-byte aligned base. Else
// (17 x 37, the scaled sizes) the same quad goes out word by word with the
// right edge checked. The sample offsets come from the host (p.row_off,
// p.col_off): a thread's four columns never change, so their offsets sit in
// registers, and a pass's row is the same for a whole warp. MCU sides are
// powers of two (1..32), so the index split is shifts and masks.
template <class T>
__device__ __forceinline__ void composite_rgba(const T* coef, uint32_t* out,
                                               const DecodeParams& p,
                                               const SegmentPos& pos) {
  const int mw = p.mcu_w, mh = p.mcu_h;
  const int qw = (mw + 3) >> 2;  // quads per MCU row: 1, 2, 4 or 8
  const int lqw = 31 - __clz(qw);
  const int x0 = (threadIdx.x & (qw - 1)) * 4;
  const int stride = tile_stride(p.dus, sizeof(T));
  const int c2_off = (p.comp_slot[2] - p.comp_slot[1]) * 64;
  const bool vec = (mw & 3) == 0 && (p.width & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  int col_y[4], col_c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = p.col_off[min(x0 + j, mw - 1)];
    col_y[j] = e & 0xFFFF;
    col_c[j] = e >> 16;
  }
  for (int i = threadIdx.x; i < K2_SEGS * qw * mh; i += blockDim.x) {
    const int t = i >> lqw;
    const int sl = t & (K2_SEGS - 1);
    const int r = t >> K2_SEG_BITS;
    const int my = pos.my[sl];
    const int Y = my * mh + r;
    const int X = pos.mx[sl] * mw + x0;
    if (my < 0 || Y >= p.height || X >= p.width) continue;
    const T* px = coef + sl * stride;
    const int row_y = p.row_off[r] & 0xFFFF, row_c = p.row_off[r] >> 16;
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int y = px[row_y + col_y[j]];
      int c1 = 0, c2 = 0;
      if (p.ncomp != 1) {
        c1 = px[row_c + col_c[j]];
        c2 = px[row_c + col_c[j] + c2_off];
      }
      v[j] = rgba_word(p, y, c1, c2);
    }
    uint32_t* dst = out + (size_t)Y * p.width + X;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (x0 + j < mw && X + j < p.width) dst[j] = v[j];
    }
  }
}

// Eight neighbouring samples 0..255 of the tile as eight bytes. A row of a
// data unit starts on a word of the tile: strides and rows are even.
__device__ __forceinline__ uint2 pack_row(const short* c) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(c);
  return make_uint2(__byte_perm(w[0], w[1], 0x6420),
                    __byte_perm(w[2], w[3], 0x6420));
}

__device__ __forceinline__ void store_row(uint8_t* dst, uint2 v) {
  if ((reinterpret_cast<uintptr_t>(dst) & 7) == 0) {
    *reinterpret_cast<uint2*>(dst) = v;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dst[j] = (uint8_t)(v.x >> (8 * j));
      dst[4 + j] = (uint8_t)(v.y >> (8 * j));
    }
  }
}

// Phase 3, planes. The k-th data unit of a component sampled (h, v) lies at
// row (my * v + k / h) * 8, column (mx * h + k % h) * 8 of its plane. The
// host hands over the MCU's store units (p.plane_units of them,
// ops/fused.plane_offsets): unit u is data unit unit_du[u], with the next
// one to its right when unit_pair[u], at (unit_row[u], unit_col[u]) of the
// MCU's footprint in a plane of plane_pitch bytes a row. A thread keeps its
// segment (lane = segment, so its MCU's place is read once) and takes rows
// of units: 8 samples, or 16 of a pair, packed and stored at once: 16 bytes
// where the address is a multiple of 16, 8 where of 8, else byte by byte.
// The planes are MCU-padded with pitches and offsets that are multiples of
// 8 (16 for a pair), so the address is as aligned as the plane's base, and
// no store passes a plane's edge. The odd tile stride keeps the 32 lanes'
// reads in 32 banks.
__device__ __forceinline__ void store_planes(const short* coef,
                                             const Outputs& o,
                                             const DecodeParams& p,
                                             const SegmentPos& pos) {
  const int sl = threadIdx.x & (K2_SEGS - 1);
  const int my = pos.my[sl], mx = pos.mx[sl];
  if (my < 0) return;
  const short* px = coef + sl * tile_stride(p.dus, 2);
  const int step = blockDim.x >> K2_SEG_BITS;
  for (int t = threadIdx.x >> K2_SEG_BITS; t < p.plane_units * 8; t += step) {
    const int u = t >> 3, py = t & 7;
    const int d = p.unit_du[u];
    const int comp = p.du_to_comp[d];
    const int row = my * p.comp_v[comp] * 8 + p.unit_row[u] + py;
    const int col = mx * p.comp_h[comp] * 8 + p.unit_col[u];
    uint8_t* dst = static_cast<uint8_t*>(o.ptr[comp]) +
                   (size_t)row * p.plane_pitch[comp] + col;
    const short* c = px + d * 64 + py * 8;
    const uint2 a = pack_row(c);
    if (p.unit_pair[u]) {
      const uint2 b = pack_row(c + 64);
      if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(a.x, a.y, b.x, b.y);
      } else {
        store_row(dst, a);
        store_row(dst + 8, b);
      }
    } else {
      store_row(dst, a);
    }
  }
}

// Phase 3, coefficients (K1): MCU m of the block's segments, [dus][64]
// int32 each, to out[((seg * ri) + m) * dus * 64]. A warp takes a segment,
// a lane four neighbouring coefficients: two words of the tile, sign-
// extended, stored as 16 bytes, so the warp writes the segment's dus * 256
// bytes in one run; the DC comes from dc_s. The lane zeroes the two words
// as it reads them, which leaves the tile zeroed for the next MCU. A
// segment with no MCU m (past a short final interval) writes zeros.
__device__ __forceinline__ void store_coefs(short* coef, const int* dc,
                                            int* out, const DecodeParams& p,
                                            const SegmentPos& pos, int seg0,
                                            int m) {
  const int lane = threadIdx.x & 31;
  const int stride = tile_stride(p.dus, 2);
  const int segs = min(K2_SEGS, p.nseg - seg0);
  for (int sl = threadIdx.x >> 5; sl < segs; sl += blockDim.x >> 5) {
    const bool live = pos.my[sl] >= 0;
    uint32_t* c = reinterpret_cast<uint32_t*>(coef + sl * stride);
    int4* dst = reinterpret_cast<int4*>(
        out + ((size_t)(seg0 + sl) * p.ri + m) * p.dus * 64);
    for (int q = lane; q < p.dus * 16; q += 32) {
      const uint32_t a = c[2 * q], b = c[2 * q + 1];
      c[2 * q] = 0;
      c[2 * q + 1] = 0;
      int4 v = make_int4((short)(a & 0xFFFF), (short)(a >> 16),
                         (short)(b & 0xFFFF), (short)(b >> 16));
      if ((q & 15) == 0) v.x = live ? dc[sl * p.dus + (q >> 4)] : 0;
      dst[q] = v;
    }
  }
}

// Zero what the next MCU's IDCT reads of the tile and the decode does not
// write. Every mode but the scaled one reads whole data units: the whole
// tile, 16 bytes a store (its length, 32 strides, is a whole number of
// them). The scaled IDCT reads positions 1 .. zlen - 1 (position 0 is the
// DC, read from dc_s): the words that hold them, none at k = 1.
template <int IDCT>
__device__ __forceinline__ void zero_tile(short* coef, int tile_words,
                                          const DecodeParams& p) {
  if (IDCT == kIdctScaled) {
    const int nz = p.zlen > 1 ? (p.zlen + 1) / 2 : 0;
    const int half = tile_stride(p.dus, 2) / 2;  // a segment's words
    uint32_t* w = reinterpret_cast<uint32_t*>(coef);
    for (int u = threadIdx.x; u < K2_SEGS * p.dus; u += blockDim.x) {
      uint32_t* unit = w + (u & (K2_SEGS - 1)) * half + (u >> K2_SEG_BITS) * 32;
      for (int i = 0; i < nz; ++i) unit[i] = 0;
    }
  } else {
    uint4* tile4 = reinterpret_cast<uint4*>(coef);
    for (int i = threadIdx.x; i < tile_words / 4; i += blockDim.x)
      tile4[i] = make_uint4(0, 0, 0, 0);
  }
}

// BANDED: the launch's frames are bands, each gated to its MCUs inside the
// image (frame_mcus). A kernel of its own, so that the gate's code cannot
// change how the compiler schedules the non-banded launches: K2 took 3 %
// longer when one kernel served both (PERF.md, PR 11).
// LANES: the launch's segments are lanes of a longer restart segment
// (DecodeParams::seg_ri), each starting from its entry of the lane table
// `lanes`, {bit, dp[0], dp[1], dp[2]} (the lane index below); an
// instantiation of its own for the same reason. Other launches pass null.
template <int IDCT, int OUT, bool BANDED, bool LANES>
__global__ void __launch_bounds__(Tile<IDCT>::THREADS, Tile<IDCT>::BLOCKS)
fused_decode_kernel(const uint32_t* __restrict__ rows,
                    const int* __restrict__ tables, const void* __restrict__ op,
                    const Outputs outs, const DecodeParams p,
                    const int4* __restrict__ lanes) {
  extern __shared__ __align__(16) int smem[];
  using T = typename Tile<IDCT>::T;
  const uint16_t* tab = reinterpret_cast<const uint16_t*>(smem);
  const int tab_words = p.ntables * TAB_WORDS;  // a multiple of 4
  // [K2_SEGS][tile_stride]: a segment's [dus][64] coefficients, its pixels
  // after the IDCT; the DC values lie in dc_s.
  T* coef = reinterpret_cast<T*>(smem + tab_words);
  const int stride = tile_stride(p.dus, sizeof(T));
  const int tile_words = K2_SEGS * stride * (int)sizeof(T) / 4;
  __shared__ int dc_s[K2_SEGS * 6];
  // Integer mode: the quantizers [dus][64] and the zigzag table.
  __shared__ int qz_s[IDCT == kIdctInt ? 6 * 64 : 1];
  __shared__ int zz_s[IDCT == kIdctInt ? 64 : 1];
  __shared__ SegmentPos pos;
  const int tid = threadIdx.x;
  // A batch stacks its frames along blockIdx.y: segments, MCUs and output
  // coordinates below are the frame's own, and only the row and output
  // pointers move with the frame, so no block straddles two frames.
  const size_t frame = blockIdx.y;
  const int mcus = BANDED ? frame_mcus(p, (int)frame) : p.total_mcus;
  const int seg0 = blockIdx.x * K2_SEGS;
  // A block whose first segment holds no MCU of its band (the rows or the
  // band past the image) reads no bits and writes nothing.
  if (BANDED && segment_mcus(p, seg0, mcus) <= 0) return;
  rows += frame * p.frame_rows * p.words;
  // The block's rows lie one after the other: bring them, then the tables,
  // into shared memory while the block sets itself up, so that the bit
  // readers' refills do not wait on device memory.
  int* row_cache = smem + tab_words + tile_words;
  // A lane's row is its segment's, which the block's other lanes share.
  const bool cached = !LANES && row_cache_words(p.words) > 0;
  if (cached)
    copy_async(row_cache, reinterpret_cast<const int*>(rows) + (size_t)seg0 * p.words,
               min(K2_SEGS, p.nseg - seg0) * p.words);
  copy_async(smem, tables, tab_words);
  if (IDCT == kIdctInt) {
    load_tables(qz_s, static_cast<const int*>(op), p.dus * 64);
    for (int i = threadIdx.x; i < 64; i += blockDim.x) zz_s[i] = int_idct::kZigzag[i];
  }

  Outputs out = outs;
  if (OUT == kOutPlanes) {
    const size_t height_mcus = p.total_mcus / p.width_mcus;
    for (int c = 0; c < p.ncomp; ++c)
      out.ptr[c] = static_cast<uint8_t*>(out.ptr[c]) +
                   frame * (height_mcus * 8 * p.comp_v[c]) *
                       ((size_t)p.width_mcus * 8 * p.comp_h[c]);
  } else if (OUT == kOutRgba) {
    out.ptr[0] = static_cast<uint32_t*>(out.ptr[0]) +
                 frame * p.height * (size_t)p.width;
  }
  // Segment counts only shrink at the frame's end, so the block's first
  // segment has the most MCUs; K1 writes all ri MCUs of every segment, the
  // padding ones zero, even where a short segment is the block's first.
  const int m_end = OUT == kOutCoefs ? p.ri : segment_mcus(p, seg0, mcus);

  // Phase-1 state of the segment this thread decodes: the block's segment
  // `slot`, or none (slot < 0) past warp 0.
  const int slot = tid < K2_SEGS ? tid : -1;
  const int my_seg = seg0 + slot;
  const int my_nm = slot >= 0 ? segment_mcus(p, my_seg, mcus) : 0;
  BitReader br;
  if (!LANES && my_nm > 0)
    br.init(cached ? reinterpret_cast<const uint32_t*>(row_cache) + slot * p.words
                   : rows + (size_t)my_seg * p.words,
            p.words);
  int dp[3] = {0, 0, 0};
  if (LANES && my_nm > 0) {  // the lane's entry of the lane table
    const int4 e = lanes[frame * p.nseg + my_seg];
    const int seg = (int)((long long)my_seg * p.ri / p.seg_ri);
    br.init_at(rows + (size_t)seg * p.words, p.words, e.x);
    dp[0] = e.y;
    dp[1] = e.z;
    dp[2] = e.w;
  }

  // decode_mcu stores only DC and nonzero AC, so the tile is zeroed before
  // each MCU: here once for K1, whose store zeroes what it read, and at the
  // top of each pass for the others, whose IDCT writes pixels over it.
  if (OUT == kOutCoefs) zero_tile<IDCT>(coef, tile_words, p);
  for (int m = 0; m < m_end; ++m) {
    if (OUT != kOutCoefs) zero_tile<IDCT>(coef, tile_words, p);
    if (slot >= 0) {  // K1 needs only whether the segment has MCU m
      const int mcu = my_seg * p.ri + m;
      const int row = OUT == kOutCoefs ? 0 : mcu / p.width_mcus;
      pos.my[slot] = m < my_nm ? row : -1;
      pos.mx[slot] = mcu - row * p.width_mcus;
    }
    __pipeline_wait_prior(0);  // the rows and tables, on the first pass
    __syncthreads();

    // ---- phase 1: entropy decode of MCU m of each segment ----------------
    if (m < my_nm) {
      T* c = coef + slot * stride;
      int* dc = dc_s + slot * p.dus;
      decode_mcu(br, dp, tab, p, [&](int d, int z, int v) {
        if (z == 0)
          dc[d] = v;
        else
          c[d * 64 + z] = (T)v;
      });
    }
    __syncthreads();

    // ---- phase 2: dequant + IDCT, pixels over the coefficients -----------
    if constexpr (IDCT != kIdctNone) {
      const float* fop = static_cast<const float*>(op);
      if constexpr (IDCT == kIdctInt) {
        idct_int(coef, dc_s, qz_s, zz_s, p);
      } else if constexpr (IDCT == kIdctScaled) {
        if (p.blk == 1)
          idct_scaled<1>(coef, dc_s, fop, p, pos);
        else if (p.blk == 2)
          idct_scaled<2>(coef, dc_s, fop, p, pos);
        else
          idct_scaled<4>(coef, dc_s, fop, p, pos);
      } else {
        idct_float(coef, dc_s, fop, p, pos);
      }
      __syncthreads();
    }

    // ---- phase 3: output --------------------------------------------------
    if (OUT == kOutCoefs) {
      store_coefs(coef, dc_s, static_cast<int*>(out.ptr[0]), p, pos, seg0, m);
    } else if (OUT == kOutPlanes) {
      store_planes(coef, out, p, pos);
    } else {
      composite_rgba(coef, static_cast<uint32_t*>(out.ptr[0]), p, pos);
    }
    __syncthreads();  // the next MCU's zeroing and decode overwrite the tile
  }
}

// Bytes of dynamic shared memory a block takes: the tables, the tile of
// elem_bytes elements and the rows.
inline size_t fused_smem_bytes(const DecodeParams& p, int elem_bytes) {
  return sizeof(int) * (p.ntables * TAB_WORDS + row_cache_words(p.words)) +
         (size_t)K2_SEGS * tile_stride(p.dus, elem_bytes) * elem_bytes;
}

template <int IDCT, int OUT, bool BANDED, bool LANES = false>
int launch_kernel(const void* rows, const void* tables, const void* op,
                  Outputs out, const DecodeParams* p, void* stream,
                  const void* lanes = nullptr) {
  auto kernel = fused_decode_kernel<IDCT, OUT, BANDED, LANES>;
  const size_t smem = fused_smem_bytes(*p, sizeof(typename Tile<IDCT>::T));
  // More than 48 KB of dynamic shared memory has to be allowed, once for
  // each instantiation and device; the most allowed so far is kept.
  static std::atomic<size_t> allowed[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem > allowed[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev].store(smem, std::memory_order_release);
  }
  const dim3 grid((p->nseg + K2_SEGS - 1) / K2_SEGS, p->frames);
  kernel<<<grid, Tile<IDCT>::THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)rows, (const int*)tables, op, out, *p,
      (const int4*)lanes);
  return (int)cudaSuccess;
}

// A banded launch (p->bands > 0) takes the BANDED kernel; only the batched
// K2, K2x and K3 have one (parallel/sharding.py launches no other). A lane
// launch (a lane table, p->seg_ri > 0) takes the LANES kernel, K2, K2x and
// K3 alike.
template <int IDCT, int OUT>
int launch_fused(const void* rows, const void* tables, const void* op,
                 Outputs out, const DecodeParams* p, void* stream,
                 const void* lanes = nullptr) {
  if (p->ntables < 1 || p->ntables > MAX_TABLES) return (int)cudaErrorInvalidValue;
  if ((lanes != nullptr) != (p->seg_ri > 0) || (lanes && p->bands > 0))
    return (int)cudaErrorInvalidValue;
  if (p->nseg > 0 && p->frames > 0) {
    int err;
    if (lanes) {
      if constexpr (OUT == kOutCoefs || IDCT == kIdctScaled)
        return (int)cudaErrorInvalidValue;
      else
        err = launch_kernel<IDCT, OUT, false, true>(rows, tables, op, out, p,
                                                     stream, lanes);
    } else if (p->bands > 0) {
      if constexpr (OUT == kOutCoefs || IDCT == kIdctScaled)
        return (int)cudaErrorInvalidValue;
      else
        err = launch_kernel<IDCT, OUT, true>(rows, tables, op, out, p, stream);
    } else {
      err = launch_kernel<IDCT, OUT, false>(rows, tables, op, out, p, stream);
    }
    if (err != cudaSuccess) return err;
  }
  return (int)cudaGetLastError();
}

// ---- The lane index (kernel L) -------------------------------------------
//
// A restart segment of many MCUs (a frame with no restart markers is one)
// would be one lane of the fused kernels walking all its MCUs. The lane
// index finds where every lane of L MCUs starts, so that a LANES launch can
// decode the segment on many lanes: for lane v the bit of MCU v * L in its
// segment's row and the DC predictors before it, by Huffman
// self-synchronisation (Weissenberger and Schmidt, "Massively Parallel
// Huffman Decoding on GPUs", ICPP 2018, and "Accelerating JPEG Decompression
// on GPUs", HiPC 2021). It replaces no TPU kernel: the JAX package decodes
// one restart segment a lane and never splits one.
//
// A segment's row is cut into subsequences of SUB_BITS bits. Subsequence t
// is entered at the first symbol boundary at or after t * SUB_BITS and left
// at the first at or after (t + 1) * SUB_BITS, a boundary being the state of
// LaneWalk (csrc/entropy.cuh): the bit, the data unit and the zigzag
// position (LaneWalk::kind). Only a segment's active subsequences take part past the first pass: those
// up to the last that holds a word other than zero. A row is its segment's
// bits and then zero words up to the batch's widest segment, and a decode
// that starts at a guess inside zeros never meets the true path there (the
// zeros decode periodically, so the two stay out of step), which would
// leave every one of them to the serial repair. A segment whose MCUs run on
// into the zeros is still decoded whole: the last active subsequence goes
// on until the segment's last MCU (4 below).
//  1. lane_sync_kernel, a thread a subsequence: it starts LEAD_SUBS
//     subsequences back at a guess (an MCU start there; the segment's true
//     start for t <= LEAD_SUBS), decodes to t's entry and on to its exit,
//     counting the MCUs that start in between and summing each component's
//     DC differences, and marks its segment's last subsequence that holds a
//     word other than zero. A Huffman decode that starts at a wrong place falls
//     into step with the right one's symbols within a few dozen bits, but
//     into step with its place in the MCU (which data unit, so which
//     table) only by chance at a data unit of another table: at 1080p 4:2:0
//     q95 half the guesses have met the true path after about 800 bits, 99 %
//     after about 7,300 (PERF.md).
//  2. lane_round_kernel, ROUNDS times: every subsequence whose entry is not
//     its predecessor's exit takes that exit as its entry and is decoded
//     again; a round after one that changed nothing returns at once. A run
//     of k guesses that missed needs k rounds.
//  3. lane_fix_kernel, a block a segment: where an exit is still not its
//     successor's entry (a run longer than ROUNDS), the successor is decoded
//     again from that exit, and so on down the row until an exit meets the
//     next entry. Thread 0 does that alone; the block finds the mismatches.
//     Every entry is then the serial decode's, on any bits (subsequence 0
//     starts at the true start), garbage and short rows included. Then an
//     exclusive scan of the counts and sums gives each subsequence's first
//     MCU and predictors, and the lane table's entry at every MCU whose
//     index in the frame is a multiple of L follows from the first STARTS
//     MCU starts each subsequence's decode kept.
//  4. lane_index_kernel, a thread a subsequence that had more MCU starts
//     than it kept, and the last active one: it decodes t again from its
//     entry and writes those entries. The last goes on past its end until
//     the segment's last MCU (garbage can read past the row).
//
// What bounds it: like phase 1 of the fused kernels, the chain of dependent
// shifts, lookups and compares of each symbol, LEAD_SUBS + 1 times over the
// bits (the guess's lead-in, the subsequence) and again for the guesses that
// missed, which the rounds decode one subsequence a round (at 1080p q95, 0.020
// ms of a frame's 0.054 in the first pass, 0.028 in the rounds, PERF.md); the
// row is read from device memory a few times and the table written once,
// microseconds of traffic. What the design does about it: a thread for every
// SUB_BITS bits, so a frame of 6 Mbit gives thousands of independent chains
// and the card's schedulers always find one ready; the tables in shared
// memory and a data unit's tables and the DC sums in registers; the rounds
// decode only what changed; the serial repair only where the rounds did not
// reach; no second pass where a subsequence kept its MCU starts.
constexpr int SUB_BITS = 1024;     // bits of a subsequence
constexpr int LEAD_SUBS = 1;       // subsequences a guess starts back
constexpr int ROUNDS = 8;          // rounds after the guesses
constexpr int STARTS = 4;          // MCU starts a subsequence's decode keeps
constexpr int LANE_THREADS = 128;  // threads of a sync, round or index block
constexpr int FIX_THREADS = 256;   // most threads of a repair block
constexpr int FIX_SPAN = 8;        // subsequences a repair thread checks at once

// The scratch of a subsequence, SUB_INT4 int4: {entry bit, entry kind, exit
// bit, exit kind}; {MCUs started, the DC sums of components 0, 1, 2}, where
// the scan leaves the MCUs and sums before the subsequence; then the first
// STARTS MCUs that start in it, {bit, DC sums from its entry to there}. After
// every subsequence of the launch, ROUNDS ints, whether round r changed an
// entry, and an int a segment, its active subsequences; compeg_lane_index
// zeroes those first.
constexpr int SUB_INT4 = 2 + STARTS;

__device__ __host__ __forceinline__ int lane_subs(int words) {
  return (int)(((long long)words * 32 + SUB_BITS - 1) / SUB_BITS);
}

// Segments of the launch, every frame's.
__device__ __host__ __forceinline__ int lane_segs(const DecodeParams& p) {
  return p.frames * ((p.total_mcus + p.seg_ri - 1) / p.seg_ri);
}

// The ints after the subsequences: the rounds' flags, then the segments'
// active subsequence counts.
__device__ __forceinline__ int* lane_tail(int4* scratch, const DecodeParams& p,
                                          int nsub) {
  return reinterpret_cast<int*>(scratch + (size_t)SUB_INT4 * lane_segs(p) * nsub);
}

// Subsequence t from the walk's place and state, its entry, into its
// scratch: the exit, the MCU count and DC sums, the first MCU starts.
__device__ __forceinline__ void lane_sub(LaneWalk& w, int t,
                                         const uint16_t* tab,
                                         const DecodeParams& p, int4* sub) {
  const int entry_bit = w.br.bit(), entry_kind = w.kind();
  w.dc0 = w.dc1 = w.dc2 = 0;
  int mcus = 0;
  while (w.br.bit() < (t + 1) * SUB_BITS) {
    if (w.mcu_start()) {
      if (mcus < STARTS)
        sub[2 + mcus] =
            make_int4(w.br.bit(), (int)w.dc0, (int)w.dc1, (int)w.dc2);
      ++mcus;
    }
    w.step(tab, p);
  }
  sub[0] = make_int4(entry_bit, entry_kind, w.br.bit(), w.kind());
  sub[1] = make_int4(mcus, (int)w.dc0, (int)w.dc1, (int)w.dc2);
}

// The segment a subsequence lies in, and its row.
struct LaneSegment {
  int seg;    // segment of the launch, frame-major: frame * nsegr + s
  int s;      // segment of its frame
  int mcus;   // MCUs of that segment
  const uint32_t* row;
};

__device__ __forceinline__ LaneSegment lane_segment(const uint32_t* rows,
                                                    const DecodeParams& p,
                                                    int seg) {
  const int nsegr = (p.total_mcus + p.seg_ri - 1) / p.seg_ri;
  const int f = seg / nsegr, s = seg - f * nsegr;
  const int left = p.total_mcus - s * p.seg_ri;
  return {seg, s, left < p.seg_ri ? left : p.seg_ri,
          rows + ((size_t)f * p.frame_rows + s) * p.words};
}

// The sync, round and index kernels take a thread a subsequence, numbered
// over the launch's segments one after the other, so that short segments
// share a block. Each block brings the tables into shared memory first.
__device__ __forceinline__ int lane_thread(const int* tables, int* smem,
                                           const DecodeParams& p) {
  copy_async(smem, tables, p.ntables * TAB_WORDS);
  __pipeline_wait_prior(0);
  __syncthreads();
  return blockIdx.x * LANE_THREADS + threadIdx.x;
}

__global__ void __launch_bounds__(LANE_THREADS)
lane_sync_kernel(const uint32_t* __restrict__ rows,
                 const int* __restrict__ tables, int4* scratch,
                 const DecodeParams p) {
  extern __shared__ __align__(16) int smem[];
  const int nsub = lane_subs(p.words);
  const int g = lane_thread(tables, smem, p);
  if (g >= lane_segs(p) * nsub) return;
  const int t = g % nsub;
  const LaneSegment sg = lane_segment(rows, p, g / nsub);
  bool words = t == 0;  // the segment's first subsequence is always active
  for (int w = t * (SUB_BITS / 32); w < min((t + 1) * (SUB_BITS / 32), p.words);
       ++w)
    words |= sg.row[w] != 0;
  if (words) atomicMax(lane_tail(scratch, p, nsub) + ROUNDS + sg.seg, t + 1);
  const uint16_t* tab = reinterpret_cast<const uint16_t*>(smem);
  LaneWalk w;
  w.start(sg.row, p.words, t <= LEAD_SUBS ? 0 : (t - LEAD_SUBS) * SUB_BITS, 0,
          tab, p);
  while (w.br.bit() < t * SUB_BITS) w.step(tab, p);
  lane_sub(w, t, tab, p, scratch + (size_t)SUB_INT4 * g);
}

// Round r of the repair: a subsequence whose entry is not its predecessor's
// exit (as the predecessor's last decode left it, read past the L1, since
// it may change during the round) is decoded again from that exit.
__global__ void __launch_bounds__(LANE_THREADS)
lane_round_kernel(const uint32_t* __restrict__ rows,
                  const int* __restrict__ tables, int4* scratch,
                  const DecodeParams p, int r) {
  extern __shared__ __align__(16) int smem[];
  const int nsub = lane_subs(p.words);
  int* changed = lane_tail(scratch, p, nsub);
  if (r > 0 && __ldcg(changed + r - 1) == 0) return;  // a fixed point
  const int g = lane_thread(tables, smem, p);
  const int t = g % nsub;
  if (g >= lane_segs(p) * nsub || t == 0 ||
      t >= changed[ROUNDS + g / nsub])  // past the segment's active ones
    return;
  int4* sub = scratch + (size_t)SUB_INT4 * g;
  const int4 before = __ldcg(sub - SUB_INT4), mine = sub[0];
  if (before.z == mine.x && before.w == mine.y) return;
  const uint16_t* tab = reinterpret_cast<const uint16_t*>(smem);
  LaneWalk w;
  w.start(lane_segment(rows, p, g / nsub).row, p.words, before.z, before.w,
          tab, p);
  lane_sub(w, t, tab, p, sub);
  changed[r] = 1;
}

// A block a segment, of blockDim.x threads (a multiple of 32, at most
// FIX_THREADS): the serial repair, the scan, and the lane table's entries
// at the MCU starts the subsequences kept.
__global__ void __launch_bounds__(FIX_THREADS)
lane_fix_kernel(const uint32_t* __restrict__ rows,
                const int* __restrict__ tables, int4* scratch,
                int4* __restrict__ lanes, const DecodeParams p) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int first_s, next_s;
  __shared__ uint4 part_s[FIX_THREADS / 32];
  copy_async(smem, tables, p.ntables * TAB_WORDS);
  __pipeline_wait_prior(0);
  __syncthreads();
  const uint16_t* tab = reinterpret_cast<const uint16_t*>(smem);
  const int nrow = lane_subs(p.words);
  const LaneSegment sg = lane_segment(rows, p, blockIdx.x);
  int4* sub = scratch + (size_t)SUB_INT4 * sg.seg * nrow;
  const int nsub = lane_tail(scratch, p, nrow)[ROUNDS + sg.seg];  // active
  const int tid = threadIdx.x, nt = blockDim.x;
  // Repair: find the first subsequence whose exit is not its successor's
  // entry, decode from there on alone until an exit meets the next entry,
  // look again past it.
  for (int lo = 0; lo < nsub - 1;) {
    if (tid == 0) first_s = nsub;
    __syncthreads();
    int mine = nsub;
#pragma unroll
    for (int k = FIX_SPAN - 1; k >= 0; --k) {
      const int t = lo + k * nt + tid;
      if (t < nsub - 1) {
        const int4 a = sub[SUB_INT4 * t], b = sub[SUB_INT4 * (t + 1)];
        if (a.z != b.x || a.w != b.y) mine = t;
      }
    }
    if (mine < nsub) atomicMin(&first_s, mine);
    __syncthreads();
    const int first = first_s;
    if (first == nsub) {
      lo += FIX_SPAN * nt;
      __syncthreads();  // first_s is read before it is reset
      continue;
    }
    if (tid == 0) {
      int u = first;
      int4 now = sub[SUB_INT4 * u];
      for (;;) {
        ++u;
        LaneWalk w;
        w.start(sg.row, p.words, now.z, now.w, tab, p);
        lane_sub(w, u, tab, p, sub + SUB_INT4 * u);
        now = sub[SUB_INT4 * u];
        if (u == nsub - 1) break;
        const int4 nx = sub[SUB_INT4 * (u + 1)];
        if (nx.x == now.z && nx.y == now.w) break;
      }
      next_s = u;
    }
    __syncthreads();
    lo = next_s;
    __syncthreads();  // first_s and next_s are read before they change
  }
  // Exclusive scan of {MCUs, DC sums} over the subsequences, wrapping in 32
  // bits: a thread takes a run of `each`, the warps' and the block's totals
  // by shuffles and shared memory.
  const int each = (nsub + nt - 1) / nt;
  const int t0 = min(tid * each, nsub), t1 = min(t0 + each, nsub);
  uint4 sum = make_uint4(0, 0, 0, 0);
  for (int t = t0; t < t1; ++t) {
    const int4 c = sub[SUB_INT4 * t + 1];
    sum.x += c.x;
    sum.y += c.y;
    sum.z += c.z;
    sum.w += c.w;
  }
  const int lane = tid & 31, warp = tid >> 5;
  uint4 inc = sum;  // inclusive over the warp's lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned x = __shfl_up_sync(0xFFFFFFFFu, inc.x, o);
    const unsigned y = __shfl_up_sync(0xFFFFFFFFu, inc.y, o);
    const unsigned z = __shfl_up_sync(0xFFFFFFFFu, inc.z, o);
    const unsigned w = __shfl_up_sync(0xFFFFFFFFu, inc.w, o);
    if (lane >= o) {
      inc.x += x;
      inc.y += y;
      inc.z += z;
      inc.w += w;
    }
  }
  if (lane == 31) part_s[warp] = inc;
  __syncthreads();
  uint4 run = make_uint4(inc.x - sum.x, inc.y - sum.y, inc.z - sum.z,
                         inc.w - sum.w);
  for (int w = 0; w < warp; ++w) {
    run.x += part_s[w].x;
    run.y += part_s[w].y;
    run.z += part_s[w].z;
    run.w += part_s[w].w;
  }
  // The entries at the kept MCU starts; a subsequence with more starts than
  // it kept, and the last (which goes on past its end), are the index
  // kernel's.
  const int nsegr = (p.total_mcus + p.seg_ri - 1) / p.seg_ri;
  int4* out = lanes + (size_t)(sg.seg / nsegr) * p.nseg;
  const int first = sg.s * p.seg_ri;  // the segment's first MCU in the frame
  for (int t = t0; t < t1; ++t) {
    int4* st = sub + SUB_INT4 * t;
    const int4 c = st[1];
    st[1] = make_int4((int)run.x, (int)run.y, (int)run.z, (int)run.w);
    const int kept = min(c.x, STARTS);
    for (int k = 0; k < kept && (int)run.x + k < sg.mcus; ++k) {
      const int j = first + (int)run.x + k;
      if (j % p.ri == 0) {
        const int4 at = st[2 + k];
        out[j / p.ri] = make_int4(at.x, (int)(run.y + at.y),
                                  (int)(run.z + at.z), (int)(run.w + at.w));
      }
    }
    run.x += c.x;
    run.y += c.y;
    run.z += c.z;
    run.w += c.w;
  }
}

// The subsequences whose MCU starts the repair block did not keep: decoded
// again from their entries, writing the lane table's entry at every MCU
// whose index in the frame is a multiple of L; the last goes on past its
// end until the segment's last MCU (garbage can read past the row).
__global__ void __launch_bounds__(LANE_THREADS)
lane_index_kernel(const uint32_t* __restrict__ rows,
                  const int* __restrict__ tables,
                  const int4* __restrict__ scratch, int4* __restrict__ lanes,
                  const DecodeParams p) {
  extern __shared__ __align__(16) int smem[];
  const int nrow = lane_subs(p.words);
  const int g = lane_thread(tables, smem, p);
  if (g >= lane_segs(p) * nrow) return;
  const int t = g % nrow;
  const int nsub = reinterpret_cast<const int*>(
      scratch + (size_t)SUB_INT4 * lane_segs(p) * nrow)[ROUNDS + g / nrow];
  if (t >= nsub) return;  // past the segment's active subsequences
  const LaneSegment sg = lane_segment(rows, p, g / nrow);
  const int4* sub = scratch + (size_t)SUB_INT4 * g;
  const int4 state = sub[0], base = sub[1];
  int m = base.x;  // the segment's MCUs before t
  if (m >= sg.mcus) return;
  const bool last = t == nsub - 1;
  if (!last && sub[SUB_INT4 + 1].x - m <= STARTS) return;  // all kept
  const uint16_t* tab = reinterpret_cast<const uint16_t*>(smem);
  LaneWalk w;  // its sums are the predictors
  w.start(sg.row, p.words, state.x, state.y, tab, p);
  w.dc0 = base.y;
  w.dc1 = base.z;
  w.dc2 = base.w;
  const int nsegr = (p.total_mcus + p.seg_ri - 1) / p.seg_ri;
  int4* out = lanes + (size_t)(sg.seg / nsegr) * p.nseg;
  const int first = sg.s * p.seg_ri;  // the segment's first MCU in the frame
  const int end = (t + 1) * SUB_BITS;
  for (;;) {
    if (!last && w.br.bit() >= end) break;
    if (w.mcu_start()) {
      if (m >= sg.mcus) break;
      if ((first + m) % p.ri == 0)
        out[(first + m) / p.ri] =
            make_int4(w.br.bit(), (int)w.dc0, (int)w.dc1, (int)w.dc2);
      ++m;
    }
    w.step(tab, p);
  }
}

}  // namespace

extern "C" {

const char* compeg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K1: out = [nseg, ri, dus, 64] int32; one frame (p->frames == 1).
int compeg_entropy_decode(const void* rows, const void* tables, void* out,
                          const DecodeParams* p, void* stream) {
  return launch_fused<kIdctNone, kOutCoefs>(rows, tables, nullptr,
                                            {{out, 0, 0}}, p, stream);
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

// The lane index (kernel L) of a LANES launch with the same parameters
// (p->nseg lanes of p->ri MCUs, segments of p->seg_ri): lanes = [frames,
// p->nseg, 4] int32, scratch = [frames, segments, subsequences, SUB_INT4,
// 4] int32 and ROUNDS + frames * segments more, of any content.
int compeg_lane_index(const void* rows, const void* tables, void* scratch,
                      void* lanes, const DecodeParams* p, void* stream) {
  if (p->ntables < 1 || p->ntables > MAX_TABLES || p->seg_ri < 1 ||
      p->ri < 1 || (p->seg_ri % p->ri != 0 && p->seg_ri < p->total_mcus))
    return (int)cudaErrorInvalidValue;
  if (p->nseg > 0 && p->frames > 0 && p->words > 0) {
    const int nsegs = lane_segs(*p);
    const int nsub = lane_subs(p->words);
    const unsigned blocks =
        (unsigned)(((long long)nsegs * nsub + LANE_THREADS - 1) / LANE_THREADS);
    const int fix = min(FIX_THREADS, (nsub + 31) / 32 * 32);
    const size_t smem = sizeof(int) * p->ntables * TAB_WORDS;
    const cudaStream_t st = (cudaStream_t)stream;
    const uint32_t* r = (const uint32_t*)rows;
    const int* tab = (const int*)tables;
    int4* sc = (int4*)scratch;
    const cudaError_t err = cudaMemsetAsync(
        sc + (size_t)SUB_INT4 * nsegs * nsub, 0,
        sizeof(int) * (ROUNDS + nsegs), st);  // no round changed, no segment active
    if (err != cudaSuccess) return (int)err;
    lane_sync_kernel<<<blocks, LANE_THREADS, smem, st>>>(r, tab, sc, *p);
    for (int round = 0; round < ROUNDS; ++round)
      lane_round_kernel<<<blocks, LANE_THREADS, smem, st>>>(r, tab, sc, *p,
                                                            round);
    lane_fix_kernel<<<nsegs, fix, smem, st>>>(r, tab, sc, (int4*)lanes, *p);
    lane_index_kernel<<<blocks, LANE_THREADS, smem, st>>>(r, tab, sc,
                                                          (int4*)lanes, *p);
  }
  return (int)cudaGetLastError();
}

// K2, K2x and K3 (either IDCT) on lanes: the entry points above with the
// lane table of compeg_lane_index after op.
int compeg_fused_decode_lanes(const void* rows, const void* tables,
                              const void* op, const void* lanes, void* out,
                              const DecodeParams* p, void* stream) {
  return launch_fused<kIdctFloat, kOutRgba>(rows, tables, op, {{out, 0, 0}}, p,
                                            stream, lanes);
}

int compeg_fused_decode_exact_lanes(const void* rows, const void* tables,
                                    const void* op, const void* lanes,
                                    void* out, const DecodeParams* p,
                                    void* stream) {
  return launch_fused<kIdctInt, kOutRgba>(rows, tables, op, {{out, 0, 0}}, p,
                                          stream, lanes);
}

int compeg_fused_decode_planes_lanes(const void* rows, const void* tables,
                                     const void* op, const void* lanes,
                                     void* y, void* cb, void* cr,
                                     const DecodeParams* p, void* stream) {
  return launch_fused<kIdctFloat, kOutPlanes>(rows, tables, op, {{y, cb, cr}},
                                              p, stream, lanes);
}

int compeg_fused_decode_planes_exact_lanes(const void* rows,
                                           const void* tables, const void* op,
                                           const void* lanes, void* y,
                                           void* cb, void* cr,
                                           const DecodeParams* p,
                                           void* stream) {
  return launch_fused<kIdctInt, kOutPlanes>(rows, tables, op, {{y, cb, cr}}, p,
                                            stream, lanes);
}

}  // extern "C"
