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
//       exp_assembly2.py:44). Its vector forms are relayout_copy_vec_kernel
//       and relayout_spread_merge_vec_kernel.
//
// The Pallas probes asked which of many formulations of one permutation
// (repeat + mask, tree interleave, strided stores) the TPU's compiler could
// lower, because its vector lanes cannot gather. A GPU thread addresses any
// word, so each permutation is written once.
//
// What bounds them on the H100: bytes. Each kernel reads every input word
// once and writes every output word once (67 MB for the 4K raster's 33.5 MB).
// What the design does about it: both sides of every copy are coalesced.
// The interleave's tile follows X: for X = 4, 8, 16 or 32 a thread takes a
// block of 4 x by 4 l, four 16-byte loads along l that are all in flight
// before its first store, and writes the four transposed 16-byte vectors;
// the lanes that share an l lie side by side, so a warp reads runs of 128
// bytes and more and writes runs of 4 * X bytes, whole sectors on both
// sides, with no shared memory and no barrier
// (relayout_interleave_vec_kernel). The swap, and the interleave where
// vectors do not fit, go through a 32 x 33 padded shared-memory tile: a warp
// reads 32 consecutive l of one x, and the block writes the tile's output
// range in memory order (runs of min(X, 32) words), the padding keeping the
// transposed shared-memory reads free of bank conflicts. The stack moves
// 16-byte vectors where the row length allows. The copy moves 16-byte
// vectors with several loads of each thread in flight before its first
// store, from a grid sized to the card, and the spread and merge write
// 16-byte vectors; all three index in 32 bits when the sizes fit and divide
// only where rows are strided or X is no power of two. The word-per-thread
// kernels remain for pointers and lengths that vectors do not fit; the
// wrapper picks by pointers, strides and lengths
// (ops/relayout.spread_merge_route, interleave_route).

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
  long long vec;        // spread_merge, interleave: the 16-byte kernels (the
                        // wrapper's choice)
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

// The interleave in 16-byte vectors, for X in {4, 8, 16, 32}, L % 4 == 0 and
// 16-byte aligned matrices (ops/relayout.interleave_route vouches for it).
// A thread owns the 4 x 4 block (x4 .. x4 + 3, l4 .. l4 + 3) of one matrix:
// it loads the four vectors in[x4 + i][l4 .. l4 + 3], all before the first
// store, and stores the four vectors out[l4 + k][x4 .. x4 + 3], whose words
// are the k-th words of the loaded ones. Threads are numbered with the X / 4
// blocks of one l4 side by side (lxq = log2(X / 4)), then along l, then
// over the matrices.
template <class Idx>
__global__ void __launch_bounds__(256)
relayout_interleave_vec_kernel(const uint32_t* __restrict__ in,
                               uint32_t* __restrict__ out, Idx n, int X,
                               int L, int lxq, Idx in_stride) {
  const Idx per = (Idx)(L >> 2) << lxq;  // blocks of one matrix
  const Idx w = (Idx)blockIdx.x * 256 + threadIdx.x;
  if (w >= n * per) return;
  const Idx m = w / per;
  const int r = (int)(w - m * per);
  const int x4 = (r & ((1 << lxq) - 1)) * 4, l4 = (r >> lxq) * 4;
  const uint32_t* src = in + m * in_stride + (Idx)x4 * L + l4;
  uint4 v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = *reinterpret_cast<const uint4*>(src + (Idx)i * L);
  uint32_t* dst = out + (m * L + l4) * X + x4;
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0].x, v[1].x, v[2].x, v[3].x);
  *reinterpret_cast<uint4*>(dst + X) =
      make_uint4(v[0].y, v[1].y, v[2].y, v[3].y);
  *reinterpret_cast<uint4*>(dst + 2 * X) =
      make_uint4(v[0].z, v[1].z, v[2].z, v[3].z);
  *reinterpret_cast<uint4*>(dst + 3 * X) =
      make_uint4(v[0].w, v[1].w, v[2].w, v[3].w);
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

// The spread, merge and copy, a word per thread: for pointers or lengths that
// 16-byte vectors do not fit. Idx is 32 bits wide whenever the word counts
// fit it.
template <class Idx>
__global__ void __launch_bounds__(256)
relayout_spread_merge_kernel(const uint32_t* __restrict__ a,
                             const uint32_t* __restrict__ b,
                             uint32_t* __restrict__ out, Idx n, Idx l, Idx x,
                             Idx in_stride) {
  const Idx total = n * l * x;
  const Idx i = (Idx)blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  const Idx k = i % x;
  const Idx sl = i / x;  // (s, l)
  const Idx s = sl / l;
  const Idx src = s * in_stride + (sl - s * l);
  out[i] = k == 0 ? a[src] : b[src];
}

inline unsigned blocks_of(long long total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}

constexpr int COPY_IN_FLIGHT = 4;

// The copy (X = 1) in 16-byte vectors: `rows` rows of `lv` vectors,
// `in_stride` vectors apart in the input (one row when the input is
// contiguous). A thread loads COPY_IN_FLIGHT vectors, a grid's width apart,
// before it stores the first, so that many loads of each thread are in
// flight; the grid is sized to the card and strides over the rest.
template <class Idx>
__global__ void __launch_bounds__(256)
relayout_copy_vec_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                         Idx rows, Idx lv, Idx in_stride) {
  const Idx total = rows * lv;
  const Idx step = (Idx)gridDim.x * 256;
  for (Idx v = (Idx)blockIdx.x * 256 + threadIdx.x; v < total;
       v += COPY_IN_FLIGHT * step) {
    uint4 r[COPY_IN_FLIGHT];
#pragma unroll
    for (int k = 0; k < COPY_IN_FLIGHT; ++k) {
      const Idx i = v + k * step;
      if (i < total) r[k] = in[rows == 1 ? i : (i / lv) * in_stride + i % lv];
    }
#pragma unroll
    for (int k = 0; k < COPY_IN_FLIGHT; ++k) {
      const Idx i = v + k * step;
      if (i < total) out[i] = r[k];
    }
  }
}

// The spread and merge (X > 1) from the store side: a thread owns 16 bytes
// of the output, `rows` rows of `qpr` such quads (one row when the input is
// contiguous), and reads the source word of each of its four words; a power
// of two X (shift >= 0) divides by a shift.
template <class Idx>
__global__ void __launch_bounds__(256)
relayout_spread_merge_vec_kernel(const uint32_t* __restrict__ a,
                                 const uint32_t* __restrict__ b,
                                 uint4* __restrict__ out, Idx rows, Idx qpr,
                                 Idx x, int shift, Idx in_stride) {
  const Idx total = rows * qpr;
  const Idx step = (Idx)gridDim.x * 256;
  for (Idx q = (Idx)blockIdx.x * 256 + threadIdx.x; q < total; q += step) {
    const Idx row = rows == 1 ? 0 : q / qpr;
    const Idx w0 = (q - row * qpr) * 4;
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const Idx w = w0 + j;
      const Idx sl = shift >= 0 ? w >> shift : w / x;
      const Idx src = row * in_stride + sl;
      v[j] = w == sl * x ? a[src] : b[src];
    }
    out[q] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// A grid for `items` work items of a grid-stride kernel: enough blocks for
// them, at most 16 for each multiprocessor of the current device.
inline cudaError_t card_grid(long long items, unsigned* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (items + 255) / 256;
  *blocks = (unsigned)(want < 16LL * sms ? want : 16LL * sms);
  return err;
}

template <class Idx>
cudaError_t launch_spread_merge(const void* a, const void* b, void* out,
                                const RelayoutParams* p, cudaStream_t stream) {
  const long long total = p->n * p->l * p->x;
  // Contiguous input rows are one long row.
  const bool flat = p->n == 1 || p->in_stride == p->l;
  const Idx rows = (Idx)(flat ? 1 : p->n);
  unsigned blocks = 0;
  if (!p->vec) {
    relayout_spread_merge_kernel<Idx><<<blocks_of(total, 256), 256, 0, stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, (Idx)p->n,
        (Idx)p->l, (Idx)p->x, (Idx)p->in_stride);
  } else if (p->x == 1) {
    const cudaError_t err = card_grid(
        (total / 4 + COPY_IN_FLIGHT - 1) / COPY_IN_FLIGHT, &blocks);
    if (err != cudaSuccess) return err;
    relayout_copy_vec_kernel<Idx><<<blocks, 256, 0, stream>>>(
        (const uint4*)a, (uint4*)out, rows, (Idx)(total / 4 / rows),
        (Idx)(p->in_stride / 4));
  } else {
    const cudaError_t err = card_grid(total / 4, &blocks);
    if (err != cudaSuccess) return err;
    int shift = -1;
    if ((p->x & (p->x - 1)) == 0)
      for (shift = 0; (1LL << shift) < p->x; ++shift) {}
    relayout_spread_merge_vec_kernel<Idx><<<blocks, 256, 0, stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint4*)out, rows,
        (Idx)(total / 4 / rows), (Idx)p->x, shift, (Idx)p->in_stride);
  }
  return cudaGetLastError();
}

inline unsigned tiles_of(const RelayoutParams* p) {
  return (unsigned)(((p->x + TILE - 1) / TILE) * ((p->l + TILE - 1) / TILE));
}

}  // namespace

extern "C" {

// out[n, l, x] = in[n * in_stride + x * L + l].
// With p->vec the caller vouches for what the 16-byte kernel needs
// (ops/relayout.interleave_route).
int compeg_relayout_interleave(const void* in, void* out,
                               const RelayoutParams* p, void* stream) {
  if (p->n > 0 && p->x > 0 && p->l > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const long long in_words = p->n * p->in_stride;
    const long long total = p->n * p->x * p->l;
    const bool narrow =
        (in_words > total ? in_words : total) < (1LL << 31) - (1LL << 24);
    if (p->vec) {
      int lx = 0;
      while ((1LL << lx) < p->x) ++lx;
      const unsigned blocks = blocks_of(total / 16, 256);
      if (narrow)
        relayout_interleave_vec_kernel<int><<<blocks, 256, 0, s>>>(
            (const uint32_t*)in, (uint32_t*)out, (int)p->n, (int)p->x,
            (int)p->l, lx - 2, (int)p->in_stride);
      else
        relayout_interleave_vec_kernel<long long><<<blocks, 256, 0, s>>>(
            (const uint32_t*)in, (uint32_t*)out, p->n, (int)p->x, (int)p->l,
            lx - 2, p->in_stride);
    } else {
      relayout_interleave_kernel<<<dim3((unsigned)p->n, tiles_of(p)),
                                   dim3(TILE, TILE_ROWS), 0, s>>>(
          (const uint32_t*)in, (uint32_t*)out, *p);
    }
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

// out[s, l * X + k] = (k == 0 ? a : b)[s * in_stride + l], s < n. With
// p->vec the caller vouches for what the 16-byte kernels need
// (ops/relayout.spread_merge_route).
int compeg_relayout_spread_merge(const void* a, const void* b, void* out,
                                 const RelayoutParams* p, void* stream) {
  const long long total = p->n * p->l * p->x;
  if (total <= 0) return (int)cudaGetLastError();
  // 32-bit indices when every word index fits them with room to spare: a
  // grid-stride index passes the end by up to a few grid widths.
  const long long in_words = p->n * p->in_stride;
  const long long reach = in_words > total ? in_words : total;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(reach < (1LL << 31) - (1LL << 24)
                   ? launch_spread_merge<int>(a, b, out, p, s)
                   : launch_spread_merge<long long>(a, b, out, p, s));
}

}  // extern "C"
