// The relayout kernels of compeg_tpu_torch, for Hopper (sm_90a): what the
// four relayout probes of the JAX package's tools/ compute, one kernel per
// distinct function. All move u32 words and do no arithmetic.
//
//   relayout_interleave_kernel   replaces tools/exp_interleave.py:134-155
//       (pallas_call_raster, pallas_call_1; ref_interleave :158) and the
//       strided-store and full where-interleave constructs of
//       tools/exp_mosaic_bisect.py:80-100: the minor transpose
//       out[n, l, x] = in[n, x, l]. The raster form's row stacking
//       (out[g, s*R + r, l*X + x], stack_rows_kernel :104) is the same
//       memory, so it is the wrapper's choice of output shape.
//   relayout_swap_crop_kernel    replaces tools/exp_swap_pallas.py:35-66
//       (make_swap; pallas_call :51): the assembly's minor swap with the crop
//       to [H, W] in the same pass,
//       out[r*RT + t, c*L*X + l*X + x] = slab[r, t, c*X*L + x*L + l].
//   relayout_stack_kernel        replaces tools/exp_assembly2.py:50-59
//       (call_epi; stack_epilogue_kernel :38) and the sublane stack of
//       exp_mosaic_bisect.py:73: out[g, x, sr, l] = in[g, sr, x, l], whole
//       rows of L words changing places.
//   relayout_spread_merge_kernel replaces the lane spread and the two-way
//       where-merge of exp_mosaic_bisect.py:41-70 (run :21-33):
//       out[s, l*X + k] = (k == 0 ? a : b)[s, l]; with b = a it is the X-fold
//       spread, and with X = 1 the plain copy, the store-bandwidth floor of
//       the probes (copy_kernel, exp_interleave.py:56; copy_epilogue_kernel,
//       exp_assembly2.py:44).
//
// The Pallas probes asked which of many formulations of one permutation
// (repeat + mask, tree interleave, strided stores) the TPU's compiler could
// lower, because its vector lanes cannot gather. A GPU thread addresses any
// word, so each permutation is written once.
//
// What bounds them on the H100: bytes. Each kernel reads every input word
// once and writes every output word once (67 MB for the 4K raster's 33.5 MB,
// about 0.02 ms at 3.35 TB/s). What the design does about it: both sides of
// every copy are coalesced. The two transposes go through a 32 x 33 padded
// shared-memory tile: a warp reads 32 consecutive l of one x, and the block
// writes the tile's output range in memory order (runs of min(X, 32) words),
// the padding keeping the transposed shared-memory reads free of bank
// conflicts. The stack moves 16-byte vectors where the row length allows.

#include <cuda_runtime.h>

#include <cstdint>

// Mirror of compeg_tpu_torch.ops._build.RelayoutParams (all int64).
struct RelayoutParams {
  long long n;          // batches (interleave, swap_crop); rows (spread_merge)
  long long x;          // X: the minor dimension that moves outward or inward
  long long l;          // L: words per lane row
  long long in_stride;  // words between input batches, or input rows
  long long tiles;      // swap_crop: tile columns per slab row (n_tc)
  long long h;          // swap_crop: output rows kept
  long long w;          // swap_crop: output columns kept (the row pitch)
  long long sr;         // stack: S * R rows that change places with x
  long long g;          // stack: groups
};

namespace {

constexpr int TILE = 32;
constexpr int TILE_ROWS = 8;  // block is (TILE, TILE_ROWS) threads

// Transpose the [X, L] matrix at `in` tile by tile; word (l, x) goes to
// out_at(l, x), or nowhere when that is null. blockIdx.y numbers the tiles.
template <class OutAt>
__device__ __forceinline__ void transpose_tile(const uint32_t* __restrict__ in,
                                               int X, int L, OutAt out_at) {
  __shared__ uint32_t tile[TILE][TILE + 1];
  const int tiles_l = (L + TILE - 1) / TILE;
  const int x0 = (blockIdx.y / tiles_l) * TILE;
  const int l0 = (blockIdx.y % tiles_l) * TILE;
  for (int j = threadIdx.y; j < TILE; j += TILE_ROWS) {
    const int x = x0 + j, l = l0 + threadIdx.x;
    if (x < X && l < L) tile[j][threadIdx.x] = in[(size_t)x * L + l];
  }
  __syncthreads();
  // The tile's outputs in memory order: xw consecutive x for each l.
  const int xw = min(TILE, X - x0);
  const int tid = threadIdx.y * TILE + threadIdx.x;
  for (int k = tid; k < TILE * xw; k += TILE * TILE_ROWS) {
    const int dl = k / xw, dx = k - dl * xw;
    if (l0 + dl >= L) break;
    uint32_t* dst = out_at(l0 + dl, x0 + dx);
    if (dst) *dst = tile[dx][dl];
  }
}

__global__ void __launch_bounds__(TILE * TILE_ROWS)
relayout_interleave_kernel(const uint32_t* __restrict__ in,
                           uint32_t* __restrict__ out, const RelayoutParams p) {
  const size_t n = blockIdx.x;
  const int X = (int)p.x, L = (int)p.l;
  uint32_t* dst = out + n * (size_t)X * L;
  transpose_tile(in + n * (size_t)p.in_stride, X, L,
                 [&](int l, int x) { return dst + (size_t)l * X + x; });
}

__global__ void __launch_bounds__(TILE * TILE_ROWS)
relayout_swap_crop_kernel(const uint32_t* __restrict__ slab,
                          uint32_t* __restrict__ out, const RelayoutParams p) {
  const long long n = blockIdx.x;  // (slab row, tile column)
  const long long row = n / p.tiles;
  const long long c = n - row * p.tiles;
  if (row >= p.h) return;  // block-uniform: a cropped slab row
  const int X = (int)p.x, L = (int)p.l;
  uint32_t* dst = out + row * p.w;
  const long long col0 = c * L * X;
  transpose_tile(slab + (size_t)n * X * L, X, L, [&](int l, int x) {
    const long long col = col0 + (long long)l * X + x;
    return col < p.w ? dst + col : (uint32_t*)nullptr;
  });
}

// One thread per vector of T (uint4 where L % 4 == 0 and both pointers are
// 16-byte aligned, else a word).
template <class T>
__global__ void __launch_bounds__(256)
relayout_stack_kernel(const T* __restrict__ in, T* __restrict__ out,
                      const RelayoutParams p, long long lv) {
  const long long total = p.g * p.x * p.sr * lv;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long v = i % lv;
  long long row = i / lv;  // (g, x, sr)
  const long long sr = row % p.sr;
  row /= p.sr;
  const long long x = row % p.x;
  const long long g = row / p.x;
  out[i] = in[((g * p.sr + sr) * p.x + x) * lv + v];
}

__global__ void __launch_bounds__(256)
relayout_spread_merge_kernel(const uint32_t* __restrict__ a,
                             const uint32_t* __restrict__ b,
                             uint32_t* __restrict__ out, const RelayoutParams p) {
  const long long total = p.n * p.l * p.x;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long k = i % p.x;
  const long long sl = i / p.x;  // (s, l)
  const long long s = sl / p.l;
  const long long src = s * p.in_stride + (sl - s * p.l);
  out[i] = k == 0 ? a[src] : b[src];
}

inline unsigned blocks_of(long long total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}

inline unsigned tiles_of(const RelayoutParams* p) {
  return (unsigned)(((p->x + TILE - 1) / TILE) * ((p->l + TILE - 1) / TILE));
}

}  // namespace

extern "C" {

// out[n, l, x] = in[n * in_stride + x * L + l].
int compeg_relayout_interleave(const void* in, void* out,
                               const RelayoutParams* p, void* stream) {
  if (p->n > 0 && p->x > 0 && p->l > 0) {
    relayout_interleave_kernel<<<dim3((unsigned)p->n, tiles_of(p)),
                                 dim3(TILE, TILE_ROWS), 0,
                                 (cudaStream_t)stream>>>(
        (const uint32_t*)in, (uint32_t*)out, *p);
  }
  return (int)cudaGetLastError();
}

// slab [n / tiles, tiles * X * L] -> out [h, w]; n counts (row, tile column).
int compeg_relayout_swap_crop(const void* slab, void* out,
                              const RelayoutParams* p, void* stream) {
  if (p->n > 0 && p->x > 0 && p->l > 0 && p->h > 0 && p->w > 0) {
    relayout_swap_crop_kernel<<<dim3((unsigned)p->n, tiles_of(p)),
                                dim3(TILE, TILE_ROWS), 0,
                                (cudaStream_t)stream>>>(
        (const uint32_t*)slab, (uint32_t*)out, *p);
  }
  return (int)cudaGetLastError();
}

// in [g, sr, x, l] -> out [g, x, sr, l].
int compeg_relayout_stack(const void* in, void* out, const RelayoutParams* p,
                          void* stream) {
  const long long words = p->g * p->x * p->sr * p->l;
  if (words > 0) {
    const bool vec = p->l % 4 == 0 &&
                     ((uintptr_t)in | (uintptr_t)out) % sizeof(uint4) == 0;
    if (vec) {
      relayout_stack_kernel<uint4><<<blocks_of(words / 4, 256), 256, 0,
                                     (cudaStream_t)stream>>>(
          (const uint4*)in, (uint4*)out, *p, p->l / 4);
    } else {
      relayout_stack_kernel<uint32_t><<<blocks_of(words, 256), 256, 0,
                                        (cudaStream_t)stream>>>(
          (const uint32_t*)in, (uint32_t*)out, *p, p->l);
    }
  }
  return (int)cudaGetLastError();
}

// out[s, l * X + k] = (k == 0 ? a : b)[s * in_stride + l], s < n.
int compeg_relayout_spread_merge(const void* a, const void* b, void* out,
                                 const RelayoutParams* p, void* stream) {
  const long long total = p->n * p->l * p->x;
  if (total > 0) {
    relayout_spread_merge_kernel<<<blocks_of(total, 256), 256, 0,
                                   (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, *p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
