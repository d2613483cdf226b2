// The relayout kernels of compeg_tpu_torch, for Hopper (sm_90a): what the
// four relayout probes of the JAX package's tools/ compute, one kernel per
// distinct function. All move u32 words and do no arithmetic.
//
//   the interleave (relayout_interleave_vec_kernel<Idx, false> and
//       relayout_word_tile_kernel) replaces tools/exp_interleave.py:134-155
//       (pallas_call_raster, pallas_call_1; ref_interleave :158) and the
//       strided-store and full where-interleave constructs of
//       tools/exp_mosaic_bisect.py:80-100: the minor transpose
//       out[n, l, x] = in[n, x, l]. The raster form's row stacking
//       (out[g, s*R + r, l*X + x], stack_rows_kernel :104) is the same
//       memory, so it is the wrapper's choice of output shape.
//   the swap and crop (relayout_interleave_vec_kernel<Idx, true> and
//       relayout_word_tile_kernel) replaces tools/exp_swap_pallas.py:35-66
//       (make_swap; pallas_call :51): the assembly's minor swap with the crop
//       to [H, W] in the same pass,
//       out[r*RT + t, c*L*X + l*X + x] = slab[r, t, c*X*L + x*L + l], the
//       interleave of every [X, L] tile of the slab into a pitched raster.
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
//       and relayout_spread_merge_vec_kernel; the copy of views they do not
//       fit is relayout_copy_shift_kernel.
//
// The Pallas probes asked which of many formulations of one permutation
// (repeat + mask, tree interleave, strided stores) the TPU's compiler could
// lower, because its vector lanes cannot gather. A GPU thread addresses any
// word, so each permutation is written once.
//
// What bounds them on the H100: bytes. Each kernel reads every input word
// once and writes every output word once (67 MB for the 4K raster's 33.5 MB).
// What the design does about it: both sides of every copy are coalesced.
// The interleave and the swap share two kernels, picked by the wrapper from
// pointers, strides and lengths (ops/relayout.interleave_route,
// swap_crop_route). For X = 4, 8, 16 or 32 and 16-byte aligned rows a
// thread takes a block of 4 x by 4 l, four 16-byte loads along l that are
// all in flight before its first store, and writes the four transposed
// 16-byte vectors; the lanes that share an l lie side by side, so a warp
// reads runs of 128 bytes and more and writes runs of 4 * X bytes, whole
// sectors on both sides, with no shared memory and no barrier
// (relayout_interleave_vec_kernel; the swap's pitched rows and crop are
// whole vectors there). Everything else goes through the word tile
// (relayout_word_tile_kernel): about 8 KB of whole matrices or of all X rows
// of a run of lanes, so that the block is full whatever X is, its rows
// loaded as the 16-byte chunks of memory they touch (words only at a row's
// unaligned ends), several a thread in flight, each word put at its place in
// the output span in shared memory, and the span stored in aligned 16-byte
// vectors with words only at its ends, whatever the alignment of either
// side. The stack moves 16-byte vectors where the row length allows. The
// copy moves 16-byte vectors, several loads of each thread in flight before
// its first store on a large copy, from a grid sized to the card, whatever
// the alignment of its views (the shift route: aligned chunks of the input
// shifted by the row's word offset), and the spread and merge write 16-byte
// vectors; all index in 32 bits when the sizes fit and divide only where
// rows are strided or X is no power of two. The word-per-thread spread and
// merge remain for pointers and lengths that vectors do not fit
// (ops/relayout.spread_merge_route).

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
  long long vec;        // spread_merge, interleave, swap_crop: the 16-byte
                        // kernels (the wrapper's choice)
};

namespace {

inline unsigned blocks_of(long long total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}

// The word tile (P1's word route, P2's): for pointers, lengths and X that
// 16-byte vectors of 4 x 4 blocks do not fit. A tile is Mt whole matrices,
// or all X rows of a run of Lt lanes of one, or (X over WT_WORDS) a run of
// rows of one lane; either way its output is one contiguous span of about
// WT_WORDS words and at most WT_CAP. Blocks of WT_THREADS threads, a tile
// each.
constexpr int WT_THREADS = 128;
constexpr int WT_WORDS = 2048;    // about 8 KB in and 8 KB out a block
constexpr int WT_CAP = 2560;      // the most words a tile holds
constexpr int WT_IN_FLIGHT = 5;   // 16-byte loads of a thread before its stores

// Host-side plan of the word tile over a [rows, cols] grid of [X, L]
// matrices: matrix (r, c) starts at in + (r * cols + c) * in_stride and is
// written at out + r * pitch + c * L * X, columns at or past `keep` dropped.
struct WordTilePlan {
  long long rows, cols, in_stride, pitch, keep;
  int X, L, xt, lt, mt, tiles_x, tiles_l, tiles_m;
};

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i & 2 ? (i & 1 ? v.w : v.z) : (i & 1 ? v.y : v.x);
}

// out[c * L * X + l * X + x] = in[c * in_stride + x * L + l], a tile a
// block. Load: the tile's rows are cut into the 16-byte chunks of device
// memory they touch; a thread loads WT_IN_FLIGHT chunks (uint4 where the
// chunk lies wholly in the row, else its words) before it stores any, and
// writes each word to shared memory at its place in the output span, offset
// so that the span's 16-byte chunks are shared memory's. Chunks are dealt
// to threads g rows at a time (g = gcd(xc, 32)), their words written in an
// order rotated by lane / max(8, g): the scattered stores of a warp then
// fall in 32 banks wherever its chunks lie in one group of rows of one
// alignment (tests/test_torch_relayout.py counts them). Store: the
// span in order, a uint4 a thread from aligned shared memory to the aligned
// destination, single words at its head and tail.
__global__ void __launch_bounds__(WT_THREADS)
relayout_word_tile_kernel(const uint32_t* __restrict__ in,
                          uint32_t* __restrict__ out, const WordTilePlan q) {
  __shared__ __align__(16) uint32_t s[WT_CAP + 4];
  unsigned b = blockIdx.x;
  const int tx = (int)(b % q.tiles_x);
  b /= q.tiles_x;
  const int tl = (int)(b % q.tiles_l);
  b /= q.tiles_l;
  const int tm = (int)(b % q.tiles_m);
  const long long row = b / q.tiles_m;
  const int x0 = tx * q.xt, xc = min(q.xt, q.X - x0);
  const int l0 = tl * q.lt, lc = min(q.lt, q.L - l0);
  const long long c0 = (long long)tm * q.mt;
  const int mc = (int)min((long long)q.mt, q.cols - c0);
  const long long col0 = (c0 * q.L + l0) * q.X + x0;
  const int keep = (int)min((long long)mc * lc * xc, q.keep - col0);
  if (keep <= 0) return;  // block-uniform: cropped away
  uint32_t* const dst = out + row * q.pitch + col0;
  const int head = (int)(((uintptr_t)dst >> 2) & 3);
  const uint32_t* const src =
      in + (row * q.cols + c0) * q.in_stride + (long long)x0 * q.L + l0;
  // Chunks a row: exact where every row starts at src's alignment.
  const bool aligned =
      (mc == 1 || q.in_stride % 4 == 0) && (xc == 1 || q.L % 4 == 0);
  const int kc = aligned ? (int)((((uintptr_t)src >> 2) & 3) + lc + 3) >> 2
                         : (lc + 6) >> 2;
  const int g = min(32, xc & -xc), lg = __ffs(g) - 1, rows_g = xc >> lg;
  const int rot = ((threadIdx.x & 31) / max(8, g)) & 3;
  const int items = mc * xc * kc;
  for (int base = 0; base < items; base += WT_THREADS * WT_IN_FLIGHT) {
    uint4 v[WT_IN_FLIGHT];
    int first[WT_IN_FLIGHT], pos[WT_IN_FLIGHT];
#pragma unroll
    for (int r = 0; r < WT_IN_FLIGHT; ++r) {
      const int f = base + r * WT_THREADS + (int)threadIdx.x;
      first[r] = lc;  // nothing to store
      pos[r] = 0;
      if (f >= items) continue;
      const int rg = (f >> lg) / kc, k = (f >> lg) - rg * kc;
      const int m = rg / rows_g, x = (rg - m * rows_g) * g + (f & (g - 1));
      const uint32_t* piece = src + m * q.in_stride + (long long)x * q.L;
      const int lt = 4 * k - (int)(((uintptr_t)piece >> 2) & 3);
      const int p = (m * lc + lt) * xc + x;  // span place of word 0
      if (lt >= lc || p >= keep) continue;  // past the row, or cropped
      first[r] = lt;
      pos[r] = p + head;
      const uint32_t* chunk = piece + lt;
      if (lt >= 0 && lt + 4 <= lc) {
        v[r] = *reinterpret_cast<const uint4*>(chunk);
      } else {
        v[r].x = lt >= 0 ? chunk[0] : 0u;
        v[r].y = lt + 1 >= 0 && lt + 1 < lc ? chunk[1] : 0u;
        v[r].z = lt + 2 >= 0 && lt + 2 < lc ? chunk[2] : 0u;
        v[r].w = lt + 3 < lc ? chunk[3] : 0u;
      }
    }
#pragma unroll
    for (int r = 0; r < WT_IN_FLIGHT; ++r) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int w = (i + rot) & 3, lt = first[r] + w;
        const int p = pos[r] + w * xc;
        if (lt >= 0 && lt < lc && p - head < keep) s[p] = word_of(v[r], w);
      }
    }
  }
  __syncthreads();
  uint4* const vdst = reinterpret_cast<uint4*>(dst - head);
  const int chunks = (head + keep + 3) >> 2;
  for (int c = threadIdx.x; c < chunks; c += WT_THREADS) {
    const int p = 4 * c - head;  // span place of the chunk's first word
    if (p >= 0 && p + 4 <= keep) {
      vdst[c] = *reinterpret_cast<const uint4*>(s + 4 * c);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (p + i >= 0 && p + i < keep) dst[p + i] = s[4 * c + i];
    }
  }
}

WordTilePlan word_tile_plan(long long rows, long long cols, long long X,
                            long long L, long long in_stride,
                            long long pitch, long long keep) {
  WordTilePlan q{rows, cols, in_stride, pitch, keep, (int)X, (int)L,
                 (int)X, (int)L, 1, 1, 1, 1};
  // Whole matrices where one fits, else runs of lanes (or of rows) cut
  // into tiles of near equal size.
  if (X * L <= WT_CAP) {
    const long long mt = X * L <= WT_WORDS ? WT_WORDS / (X * L) : 1;
    q.mt = (int)(cols < mt ? cols : mt);
  } else if (X <= WT_CAP) {
    const long long parts = (X * L + WT_WORDS - 1) / WT_WORDS;
    const long long lt = (L + parts - 1) / parts;
    q.lt = (int)(lt < WT_CAP / X ? lt : WT_CAP / X);
  } else {
    const long long parts = (X + WT_WORDS - 1) / WT_WORDS;
    q.xt = (int)((X + parts - 1) / parts), q.lt = 1;
  }
  q.tiles_x = (int)((X + q.xt - 1) / q.xt);
  q.tiles_l = (int)((L + q.lt - 1) / q.lt);
  q.tiles_m = (int)((cols + q.mt - 1) / q.mt);
  return q;
}

cudaError_t launch_word_tile(const void* in, void* out, const WordTilePlan& q,
                             cudaStream_t stream) {
  const long long blocks =
      q.rows * q.tiles_m * (long long)q.tiles_l * q.tiles_x;
  relayout_word_tile_kernel<<<(unsigned)blocks, WT_THREADS, 0, stream>>>(
      (const uint32_t*)in, (uint32_t*)out, q);
  return cudaGetLastError();
}

// The interleave in 16-byte vectors, for X in {4, 8, 16, 32}, L % 4 == 0 and
// 16-byte aligned matrices (ops/relayout.interleave_route vouches for it;
// swap_crop_route likewise with a row pitch and crop of whole vectors).
// A thread owns the 4 x 4 block (x4 .. x4 + 3, l4 .. l4 + 3) of one matrix:
// it loads the four vectors in[x4 + i][l4 .. l4 + 3], all before the first
// store, and stores the four vectors out[l4 + k][x4 .. x4 + 3], whose words
// are the k-th words of the loaded ones. Threads are numbered with the X / 4
// blocks of one l4 side by side (lxq = log2(X / 4)), then along l, then
// over the matrices. With kCrop matrix m is (row, column) m / cols, m % cols
// of an output of row pitch `pitch`, and vectors at or past column `keep`
// are not stored (whole vectors: x4, X and keep are multiples of 4).
template <class Idx, bool kCrop>
__global__ void __launch_bounds__(256)
relayout_interleave_vec_kernel(const uint32_t* __restrict__ in,
                               uint32_t* __restrict__ out, Idx n, int X,
                               int L, int lxq, Idx in_stride, Idx cols,
                               Idx pitch, Idx keep) {
  const Idx per = (Idx)(L >> 2) << lxq;  // blocks of one matrix
  const Idx w = (Idx)blockIdx.x * 256 + threadIdx.x;
  if (w >= n * per) return;
  const Idx m = w / per;
  const int r = (int)(w - m * per);
  const int x4 = (r & ((1 << lxq) - 1)) * 4, l4 = (r >> lxq) * 4;
  Idx at = (m * L + l4) * X + x4, room = 4 * (Idx)X;
  if (kCrop) {
    const Idx row = m / cols;
    const Idx col = ((m - row * cols) * L + l4) * X + x4;
    if (col >= keep) return;
    at = row * pitch + col;
    room = keep - col;
  }
  const uint32_t* src = in + m * in_stride + (Idx)x4 * L + l4;
  uint4 v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = *reinterpret_cast<const uint4*>(src + (Idx)i * L);
  uint32_t* dst = out + at;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (!kCrop || (Idx)k * X < room)
      *reinterpret_cast<uint4*>(dst + k * X) = make_uint4(
          word_of(v[0], k), word_of(v[1], k), word_of(v[2], k),
          word_of(v[3], k));
}

template <bool kCrop>
cudaError_t launch_interleave_vec(const void* in, void* out, long long n,
                                  long long X, long long L,
                                  long long in_stride, long long cols,
                                  long long pitch, long long keep,
                                  long long out_words, cudaStream_t s) {
  int lx = 0;
  while ((1LL << lx) < X) ++lx;
  const long long total = n * X * L;
  const long long in_words = n * in_stride;
  const long long reach = in_words > out_words ? in_words : out_words;
  const unsigned blocks = blocks_of(total / 16, 256);
  if (reach < (1LL << 31) - (1LL << 24) && total < (1LL << 31))
    relayout_interleave_vec_kernel<int, kCrop><<<blocks, 256, 0, s>>>(
        (const uint32_t*)in, (uint32_t*)out, (int)n, (int)X, (int)L, lx - 2,
        (int)in_stride, (int)cols, (int)pitch, (int)keep);
  else
    relayout_interleave_vec_kernel<long long, kCrop><<<blocks, 256, 0, s>>>(
        (const uint32_t*)in, (uint32_t*)out, n, (int)X, (int)L, lx - 2,
        in_stride, cols, pitch, keep);
  return cudaGetLastError();
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

// The spread and merge (X > 1), a word per thread: for pointers or lengths
// that 16-byte vectors do not fit. Idx is 32 bits wide whenever the word
// counts fit it.
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

// Vectors a thread of a large copy has in flight, all loaded before the
// first is stored.
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

// The four words that start D words into chunk a and run on into chunk b.
template <int D>
__device__ __forceinline__ uint4 shift_words(const uint4& a, const uint4& b) {
  if (D == 0) return a;
  if (D == 1) return make_uint4(a.y, a.z, a.w, b.x);
  if (D == 2) return make_uint4(a.z, a.w, b.x, b.y);
  return make_uint4(a.w, b.x, b.y, b.z);
}

// One row of the shift route: the n words at src to dst, whose first `head`
// words lie before dst's first 16-byte boundary, the input D words further
// on than the output from a boundary. Output vector q holds the row's words
// 4q - head .. 4q - head + 3; where all four are the row's (q in [qa, qb))
// they are the last 4 - D words of aligned input chunk q (counted from
// src - head - D) and the first D of chunk q + 1. A lane loads its chunk q
// whole and takes the D words it needs of chunk q + 1 from the next lane,
// which loaded it as its own first (__shfl_down_sync); the warp's last lane,
// and a lane whose next vector is not the row's, loads chunk q + 1 itself.
// Every chunk loaded holds a word of the row. The row's first and last
// vectors (at most three words each) are read and written word by word. A
// lane takes F vectors `step` apart, all loaded before the first is stored;
// the loop is the warp's, for the shuffles.
template <int D, int F, class Idx>
__device__ __forceinline__ void shift_row(const uint32_t* __restrict__ src,
                                          uint32_t* __restrict__ dst, Idx n,
                                          int head, Idx v0, Idx step) {
  const uint4* in4 = reinterpret_cast<const uint4*>(src - head - D);
  uint4* out4 = reinterpret_cast<uint4*>(dst - head);
  const Idx nv = (n + head + 3) >> 2, qa = head != 0, qb = (n + head) >> 2;
  const int lane = threadIdx.x & 31;
  for (Idx v = v0 - lane; v < nv; v += F * step) {
    uint4 lo[F], hi[F];
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const Idx q = v + lane + k * step;
      lo[k] = hi[k] = make_uint4(0u, 0u, 0u, 0u);
      if (q >= qa && q < qb) {
        lo[k] = in4[q];
        if (D && (lane == 31 || q + 1 >= qb)) hi[k] = in4[q + 1];
      } else if (q < nv) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const Idx at = 4 * q - head + i;
          w[i] = at >= 0 && at < n ? src[at] : 0u;
        }
        lo[k] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const Idx q = v + lane + k * step;
      // The next lane's chunk: only its first D words are needed.
      const bool next = lane < 31 && q + 1 < qb;
      if (D >= 1) {
        const uint32_t t = __shfl_down_sync(0xffffffffu, lo[k].x, 1);
        if (next) hi[k].x = t;
      }
      if (D >= 2) {
        const uint32_t t = __shfl_down_sync(0xffffffffu, lo[k].y, 1);
        if (next) hi[k].y = t;
      }
      if (D >= 3) {
        const uint32_t t = __shfl_down_sync(0xffffffffu, lo[k].z, 1);
        if (next) hi[k].z = t;
      }
      if (q >= qa && q < qb) {
        out4[q] = shift_words<D>(lo[k], hi[k]);
      } else if (q < nv) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const Idx at = 4 * q - head + i;
          if (at >= 0 && at < n) dst[at] = word_of(lo[k], i);
        }
      }
    }
  }
}

// The copy (X = 1) where relayout_copy_vec_kernel does not fit: the shift
// route, for an input or an output off a 16-byte boundary, rows of no whole
// vectors, or rows a stride of no whole vectors apart. It stands for the
// probes' copy (copy_kernel, tools/exp_interleave.py:56; run,
// tools/exp_mosaic_bisect.py:23) on such views.
//
// What bounds it: bytes, each input word read once and each output word
// written once (two 33.2 MB passes at 4K, 0.020 ms at 3.35 TB/s). What the
// design does about it: every load and store is an aligned 16-byte vector,
// whatever the alignment of either side, but for at most three words at
// each end of a row. A row of output (`rows` rows of `l` words, each
// `in_stride` words after the last in the input; one long row when the input
// is contiguous) is blockIdx.y's, and within it every output vector is the
// input's aligned chunks shifted by the row's relative word offset d, which
// is the same for the whole row: shift_row<d> has no division, no per-word
// test and no runtime word select on its way, and loads each chunk once (the
// next lane's by a shuffle). Rows past the grid's height are walked by
// gridDim.y. F vectors a thread: COPY_IN_FLIGHT on a large copy, 1 on a
// small one, whose time is the launch's and the code's first fetch.
template <int F, class Idx>
__global__ void __launch_bounds__(256)
relayout_copy_shift_kernel(const uint32_t* __restrict__ in,
                           uint32_t* __restrict__ out, Idx rows, Idx l,
                           Idx in_stride) {
  const Idx v0 = (Idx)blockIdx.x * 256 + threadIdx.x;
  const Idx step = (Idx)gridDim.x * 256;
  for (Idx r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint32_t* src = in + r * in_stride;
    uint32_t* dst = out + r * l;
    const int head = (int)(((uintptr_t)dst >> 2) & 3);
    switch ((int)(((uintptr_t)src >> 2) - head) & 3) {
      case 0: shift_row<0, F, Idx>(src, dst, l, head, v0, step); break;
      case 1: shift_row<1, F, Idx>(src, dst, l, head, v0, step); break;
      case 2: shift_row<2, F, Idx>(src, dst, l, head, v0, step); break;
      default: shift_row<3, F, Idx>(src, dst, l, head, v0, step); break;
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

// The most blocks a grid-stride kernel is given: 16 for each multiprocessor
// of the current device.
inline cudaError_t card_width(long long* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = 16LL * sms;
  return err;
}

// A grid for `items` work items of a grid-stride kernel: enough blocks for
// them, at most the card's width.
inline cudaError_t card_grid(long long items, unsigned* blocks) {
  long long width = 0;
  const cudaError_t err = card_width(&width);
  const long long want = (items + 255) / 256;
  *blocks = (unsigned)(want < width ? want : width);
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
  if (!p->vec && p->x == 1) {
    // A row's vectors (its head's included) across the grid's width, a row
    // a blockIdx.y: one vector a thread while the card's width holds the
    // whole copy that way, COPY_IN_FLIGHT a thread past it.
    const long long l = flat ? total : p->l, nv = (l + 6) / 4;
    long long width = 0;
    const cudaError_t err = card_width(&width);
    if (err != cudaSuccess) return err;
    const bool large = nv * rows > width * 256;
    const long long per = large ? COPY_IN_FLIGHT : 1;
    const long long want = (nv + per * 256 - 1) / (per * 256);
    const dim3 grid((unsigned)(want < width ? want : width),
                    (unsigned)(rows < 65535 ? rows : 65535));
    if (large)
      relayout_copy_shift_kernel<COPY_IN_FLIGHT, Idx><<<grid, 256, 0, stream>>>(
          (const uint32_t*)a, (uint32_t*)out, rows, (Idx)l, (Idx)p->in_stride);
    else
      relayout_copy_shift_kernel<1, Idx><<<grid, 256, 0, stream>>>(
          (const uint32_t*)a, (uint32_t*)out, rows, (Idx)l, (Idx)p->in_stride);
  } else if (!p->vec) {
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

}  // namespace

extern "C" {

// out[n, l, x] = in[n * in_stride + x * L + l].
// With p->vec the caller vouches for what the 16-byte kernel needs
// (ops/relayout.interleave_route).
int compeg_relayout_interleave(const void* in, void* out,
                               const RelayoutParams* p, void* stream) {
  if (p->n > 0 && p->x > 0 && p->l > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const long long words = p->n * p->x * p->l;
    if (p->vec)
      return (int)launch_interleave_vec<false>(in, out, p->n, p->x, p->l,
                                               p->in_stride, p->n, words,
                                               words, words, s);
    return (int)launch_word_tile(
        in, out, word_tile_plan(1, p->n, p->x, p->l, p->in_stride, words,
                                words), s);
  }
  return (int)cudaGetLastError();
}

// slab [n / tiles, tiles * X * L] -> out [h, w]; n counts (row, tile column).
// Slab rows at or past h are not read. With p->vec the caller vouches for
// what the 16-byte kernel needs (ops/relayout.swap_crop_route).
int compeg_relayout_swap_crop(const void* slab, void* out,
                              const RelayoutParams* p, void* stream) {
  if (p->n > 0 && p->x > 0 && p->l > 0 && p->h > 0 && p->w > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (p->vec)
      return (int)launch_interleave_vec<true>(
          slab, out, p->h * p->tiles, p->x, p->l, p->x * p->l, p->tiles,
          p->w, p->w, p->h * p->w, s);
    return (int)launch_word_tile(
        slab, out, word_tile_plan(p->h, p->tiles, p->x, p->l, p->x * p->l,
                                  p->w, p->w), s);
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
// (ops/relayout.spread_merge_route); without it a copy (X = 1) takes the
// shift kernel and a spread or merge the word kernel.
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
