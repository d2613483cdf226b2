// compeg_tpu native host library.
//
// C++ implementations of the host-side hot paths, exposed through a C ABI
// for the ctypes loader in __init__.py:
//
//  * scan preprocessing (destuff + restart split + TPU block packing) — the
//    CPU hot loop the reference spends ~2ms/4K-frame on in Rust
//    (reference: src/scan.rs:33-128, README.md:4-5). Ours packs straight
//    into the [G, W, 8, 128] MSB-first word layout the Pallas entropy
//    kernel consumes, so Python never touches the scan bytes.
//
// Build: `make` in this directory (or the ctypes loader builds it lazily).

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <type_traits>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

// 0xFF bytes can be classified independently: the byte after an 0xFF of a
// stuffing pair (0x00) or an RST marker (0xD0-0xD7) is never itself 0xFF,
// so "look at scan[p+1]" gives the exact same answer whether or not the
// previous pair was consumed. That independence is what lets every scanner
// below iterate a SIMD movemask of FF positions instead of walking bytes.
//
// visit_ff calls fn(p) for every p in [lo, hi) with base[p] == 0xFF, in
// ascending order. fn may read base[p + 1] when p + 1 < buffer end.
template <typename Fn>
static inline void visit_ff(const uint8_t* base, int64_t lo, int64_t hi,
                            Fn&& fn) {
  int64_t i = lo;
#if defined(__AVX2__)
  const __m256i ff = _mm256_set1_epi8(static_cast<char>(0xFF));
  for (; i + 32 <= hi; i += 32) {
    __m256i v =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(base + i));
    uint32_t m = static_cast<uint32_t>(
        _mm256_movemask_epi8(_mm256_cmpeq_epi8(v, ff)));
    while (m) {
      int b = __builtin_ctz(m);
      m &= m - 1;
      fn(i + b);
    }
  }
#endif
  for (; i < hi; i++)
    if (base[i] == 0xFF) fn(i);
}

// True if any byte of the 8-byte word is 0xFF.
static inline bool has_ff_u64(uint64_t v) {
  uint64_t x = ~v;  // FF bytes -> 0x00
  return ((x - 0x0101010101010101ull) & ~x & 0x8080808080808080ull) != 0;
}

// SIMD-classified RST walk over [lo, hi): classifies every FF's follower
// in-register (RST D0-D7 / stuffing 00 / fill FF / real marker) so the
// scalar per-FF loop only runs for RST markers — on typical 4K scans ~90%
// of FFs are RSTs and the classify branches were the walk's hot path.
//
// Calls on_rst(pos, pend) for each RST marker FF at `pos`, where `pend` is
// true iff the segment ENDING at pos contained any FF byte (stuffing pair
// or fill); on_rst returns false to stop. On return: *term_out is the
// offset of the first real-marker FF (scan terminator) or -1, and
// *tail_pend reports an FF sighted after the last delivered RST (the final
// segment's has-FF flag). Matches visit_ff's classification exactly (the
// follower of a consumed pair is never itself FF, so per-position
// classification is context-free).
template <typename OnRst>
static inline void rst_walk(const uint8_t* scan, int64_t lo, int64_t hi,
                            int64_t len, OnRst&& on_rst, int64_t* term_out,
                            bool* tail_pend) {
  int64_t term = -1;
  bool stopped = false;
  bool pend = false;       // FF inside the currently-open segment
  int64_t i = lo;
#if defined(__AVX2__)
  const __m256i ff = _mm256_set1_epi8(static_cast<char>(0xFF));
  const __m256i d0 = _mm256_set1_epi8(static_cast<char>(0xD0));
  const __m256i f8 = _mm256_set1_epi8(static_cast<char>(0xF8));
  const __m256i zero = _mm256_setzero_si256();
  for (; i + 32 <= hi && i + 33 <= len && !stopped && term < 0; i += 32) {
    const __m256i v =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(scan + i));
    uint32_t mff =
        static_cast<uint32_t>(_mm256_movemask_epi8(_mm256_cmpeq_epi8(v, ff)));
    if (!mff) continue;
    const __m256i vn =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(scan + i + 1));
    const uint32_t mrst =
        static_cast<uint32_t>(_mm256_movemask_epi8(
            _mm256_cmpeq_epi8(_mm256_and_si256(vn, f8), d0))) &
        mff;
    const uint32_t mstuff =
        (static_cast<uint32_t>(_mm256_movemask_epi8(_mm256_cmpeq_epi8(vn, zero))) |
         static_cast<uint32_t>(_mm256_movemask_epi8(_mm256_cmpeq_epi8(vn, ff)))) &
        mff;
    const uint32_t mterm = mff & ~mrst & ~mstuff;
    if (__builtin_expect(mterm != 0, 0)) {
      // A real marker inside this window: ordered scalar processing.
      bool prior = pend;
      pend = false;
      uint32_t seen = 0;  // stuffing positions inside this window
      uint32_t m = mff;
      while (m) {
        int b = __builtin_ctz(m);
        m &= m - 1;
        const int64_t p = i + b;
        const uint8_t nxt = scan[p + 1];
        if (nxt >= 0xD0 && nxt <= 0xD7) {
          const bool pf =
              pend || prior || (seen & (b ? ((1u << b) - 1) : 0)) != 0;
          pend = false;
          prior = false;
          seen &= ~(b ? ((1u << b) - 1) : 0);
          if (!on_rst(p, pf)) {
            stopped = true;
            break;
          }
        } else if (nxt == 0x00 || nxt == 0xFF) {
          seen |= 1u << b;
        } else {
          term = p;
          break;
        }
      }
      pend = pend || prior || seen != 0;
      continue;
    }
    uint32_t m = mrst;
    uint32_t pmask = mstuff;
    while (m) {
      int b = __builtin_ctz(m);
      m &= m - 1;
      const bool pf =
          pend || (pmask & (b ? ((1u << b) - 1) : 0)) != 0;
      pend = false;
      pmask &= ~(b ? ((1u << b) - 1) : 0);
      if (!on_rst(i + b, pf)) {
        stopped = true;
        break;
      }
    }
    if (stopped) break;
    if (pmask) pend = true;
  }
#endif
  // Scalar tail (and the whole walk without AVX2).
  for (; i < hi && !stopped && term < 0; i++) {
    if (scan[i] != 0xFF) continue;
    if (i + 1 >= len) {
      pend = true;
      break;
    }
    const uint8_t nxt = scan[i + 1];
    if (nxt >= 0xD0 && nxt <= 0xD7) {
      const bool pf = pend;
      pend = false;
      if (!on_rst(i, pf)) stopped = true;
    } else if (nxt == 0x00 || nxt == 0xFF) {
      pend = true;
    } else {
      term = i;
    }
  }
  *term_out = term;
  *tail_pend = pend;
}

#if defined(__AVX2__)
// 8x8 u32 transpose: dst[k*dstride + r] = src[r*sstride + k].
static inline void transpose8x8_u32(const uint32_t* src, int64_t sstride,
                                    uint32_t* dst, int64_t dstride) {
  auto ld = [&](int r) {
    return _mm256_loadu_si256(
        reinterpret_cast<const __m256i*>(src + r * sstride));
  };
  __m256i r0 = ld(0), r1 = ld(1), r2 = ld(2), r3 = ld(3);
  __m256i r4 = ld(4), r5 = ld(5), r6 = ld(6), r7 = ld(7);
  __m256i t0 = _mm256_unpacklo_epi32(r0, r1), t1 = _mm256_unpackhi_epi32(r0, r1);
  __m256i t2 = _mm256_unpacklo_epi32(r2, r3), t3 = _mm256_unpackhi_epi32(r2, r3);
  __m256i t4 = _mm256_unpacklo_epi32(r4, r5), t5 = _mm256_unpackhi_epi32(r4, r5);
  __m256i t6 = _mm256_unpacklo_epi32(r6, r7), t7 = _mm256_unpackhi_epi32(r6, r7);
  __m256i u0 = _mm256_unpacklo_epi64(t0, t2), u1 = _mm256_unpackhi_epi64(t0, t2);
  __m256i u2 = _mm256_unpacklo_epi64(t1, t3), u3 = _mm256_unpackhi_epi64(t1, t3);
  __m256i u4 = _mm256_unpacklo_epi64(t4, t6), u5 = _mm256_unpackhi_epi64(t4, t6);
  __m256i u6 = _mm256_unpacklo_epi64(t5, t7), u7 = _mm256_unpackhi_epi64(t5, t7);
  auto st = [&](int k, __m256i v) {
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(dst + k * dstride), v);
  };
  st(0, _mm256_permute2x128_si256(u0, u4, 0x20));
  st(1, _mm256_permute2x128_si256(u1, u5, 0x20));
  st(2, _mm256_permute2x128_si256(u2, u6, 0x20));
  st(3, _mm256_permute2x128_si256(u3, u7, 0x20));
  st(4, _mm256_permute2x128_si256(u0, u4, 0x31));
  st(5, _mm256_permute2x128_si256(u1, u5, 0x31));
  st(6, _mm256_permute2x128_si256(u2, u6, 0x31));
  st(7, _mm256_permute2x128_si256(u3, u7, 0x31));
}
#endif

// Transpose buf [rows, W] -> out [W, rows]. The scalar fallback is blocked
// over rows so the strided source stays in L1 across the k passes; with
// AVX2 the body is 8x8 register transposes (both sides fully vectorized).
static inline void transpose_rows_to_cols(const uint32_t* buf, int64_t rows,
                                          int64_t W, uint32_t* out) {
  int64_t k8 = 0;
#if defined(__AVX2__)
  k8 = W & ~int64_t{7};
  for (int64_t r0 = 0; r0 < rows; r0 += 8)
    for (int64_t k0 = 0; k0 < k8; k0 += 8)
      transpose8x8_u32(buf + r0 * W + k0, W, out + k0 * rows + r0, rows);
#endif
  if (k8 == W) return;
  constexpr int64_t kRB = 128;  // row tile: kRB*W*4 bytes stays L1-resident
  for (int64_t r0 = 0; r0 < rows; r0 += kRB)
    for (int64_t k = k8; k < W; k++) {
      uint32_t* dst = out + k * rows + r0;
      const uint32_t* src = buf + r0 * W + k;
      for (int64_t r = 0; r < kRB; r++) dst[r] = src[r * W];
    }
}

}  // namespace

namespace {

// Persistent worker pool: spawning std::threads per call costs ~0.5 ms on
// this VM, dwarfing the work itself for per-frame packing.
class Pool {
 public:
  static Pool& instance() {
    // Intentionally leaked; workers are detached so they never block
    // process exit and no destructor races them. Sized to the machine
    // (callers participate too, so a stream's prepare threads can keep
    // every core packing); COMPEG_POOL_WORKERS overrides.
    static Pool* p = new Pool(default_workers());
    return *p;
  }

  static int default_workers() {
    if (const char* env = std::getenv("COMPEG_POOL_WORKERS")) {
      int n = std::atoi(env);
      if (n >= 0) return n;
    }
    unsigned hw = std::thread::hardware_concurrency();
    return hw ? static_cast<int>(hw) : 4;
  }

  // Run f(0..n-1) across the workers; blocks until all complete.
  // Serialized: callers from multiple host threads queue here (the decoder
  // pipelines frame preparation across Python worker threads).
  //
  // The CALLER claims tasks too: on this virtualized host an idle vCPU can
  // take milliseconds to wake, so a run that merely notifies the workers
  // and blocks is often SLOWER than single-threaded (measured 2x). With
  // caller participation the run degrades gracefully to inline execution
  // when workers wake late — they just find less work left.
  void run(int n, const std::function<void(int)>& f) {
    if (n <= 1) {
      f(0);
      return;
    }
    std::lock_guard<std::mutex> outer(run_m_);
    {
      std::lock_guard<std::mutex> lk(m_);
      task_ = &f;
      ntask_ = n;
      next_ = 0;
      pending_ = n;
      gen_++;
    }
    cv_.notify_all();
    for (;;) {
      int idx;
      {
        std::lock_guard<std::mutex> lk(m_);
        if (next_ >= ntask_) break;
        idx = next_++;
      }
      f(idx);
      {
        std::lock_guard<std::mutex> lk(m_);
        if (--pending_ == 0) done_cv_.notify_all();
      }
    }
    std::unique_lock<std::mutex> lk(m_);
    done_cv_.wait(lk, [&] { return pending_ == 0; });
    task_ = nullptr;
  }

  int size() const { return static_cast<int>(ws_.size()); }

 private:
  explicit Pool(int nworkers) {
    for (int i = 0; i < nworkers; i++) {
      ws_.emplace_back([this] { worker(); });
      ws_.back().detach();
    }
  }

  void worker() {
    uint64_t seen = 0;
    for (;;) {
      const std::function<void(int)>* f;
      int idx;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait(lk, [&] { return gen_ != seen && task_ != nullptr; });
        seen = gen_;
        f = task_;
      }
      for (;;) {
        {
          std::lock_guard<std::mutex> lk(m_);
          // Claim work only from the generation this worker signed up for —
          // a stale worker must not pick up a newer run's tasks with its
          // old function pointer.
          if (gen_ != seen || next_ >= ntask_) break;
          idx = next_++;
        }
        (*f)(idx);
        {
          std::lock_guard<std::mutex> lk(m_);
          if (--pending_ == 0) done_cv_.notify_all();
        }
      }
    }
  }

  std::vector<std::thread> ws_;
  std::mutex run_m_;
  std::mutex m_;
  std::condition_variable cv_, done_cv_;
  const std::function<void(int)>* task_ = nullptr;
  int ntask_ = 0, next_ = 0, pending_ = 0;
  uint64_t gen_ = 0;
};

}  // namespace

extern "C" {

// Scan the entropy-coded data once: count restart intervals and measure the
// longest destuffed segment. Uses memchr to hop between 0xFF bytes (scan
// data is overwhelmingly non-FF). The buffer may extend past the scan's
// terminating marker (EOI + trailers): the first FF followed by a real
// marker (not 00/RST/FF) ends the scan, so callers can pass "rest of file"
// without a separate find_scan_end pass. Returns 0 on success.
int compeg_scan_info(const uint8_t* scan, int64_t len, int64_t* n_intervals,
                     int64_t* max_seg_bytes) {
  if (len <= 0) return -1;
  int64_t count = 1;
  int64_t seg_start = 0;  // raw offset of current segment
  int64_t stuffed = 0;    // stuffing bytes removed so far in this segment
  int64_t mx = 0;
  int64_t term = -1;  // offset of the scan-terminating marker FF
  visit_ff(scan, 0, len, [&](int64_t i) {
    if (term >= 0) return;     // past the scan's end
    if (i + 1 >= len) return;  // trailing lone FF is plain data
    uint8_t nxt = scan[i + 1];
    if (nxt == 0x00) {
      stuffed++;
    } else if (nxt >= 0xD0 && nxt <= 0xD7) {
      int64_t cur = i - seg_start - stuffed;
      if (cur > mx) mx = cur;
      count++;
      seg_start = i + 2;
      stuffed = 0;
    } else if (nxt != 0xFF) {
      term = i;  // real marker: scan ends here
    }
  });
  int64_t end = term >= 0 ? term : len;
  int64_t cur = end - seg_start - stuffed;
  if (cur > mx) mx = cur;
  *n_intervals = count;
  *max_seg_bytes = mx;
  return 0;
}

// Find the end of the entropy-coded scan data starting at `scan`: the offset
// of the first 0xFF followed by a real marker (not 00, not RST0-7, not FF).
// Returns len if no terminating marker is found.
int64_t compeg_find_scan_end(const uint8_t* scan, int64_t len,
                             int64_t offset) {
  int64_t i = offset;
#if defined(__AVX2__)
  const __m256i ff = _mm256_set1_epi8(static_cast<char>(0xFF));
  for (; i + 32 <= len; i += 32) {
    __m256i v = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(scan + i));
    uint32_t m = static_cast<uint32_t>(
        _mm256_movemask_epi8(_mm256_cmpeq_epi8(v, ff)));
    while (m) {
      int b = __builtin_ctz(m);
      m &= m - 1;
      int64_t p = i + b;
      if (p + 1 >= len) return len;
      uint8_t nxt = scan[p + 1];
      if (nxt != 0x00 && nxt != 0xFF && !(nxt >= 0xD0 && nxt <= 0xD7))
        return p;
    }
  }
#endif
  for (; i < len; i++) {
    if (scan[i] != 0xFF) continue;
    if (i + 1 >= len) return len;
    uint8_t nxt = scan[i + 1];
    if (nxt != 0x00 && nxt != 0xFF && !(nxt >= 0xD0 && nxt <= 0xD7)) return i;
  }
  return len;
}

namespace {

constexpr int kSublanes = 8;
constexpr int kLanes = 128;
constexpr int kSegsPerBlock = kSublanes * kLanes;

struct SegSpan {
  int64_t begin;  // raw scan offset of first byte
  int64_t end;    // raw scan offset past the segment (before the RST)
};

// Find RST markers and per-segment FF presence, fully parallel.
//
//   marks[s] = raw offset one past segment s's data: the RST marker's FF
//              for s < expected-1, the scan terminator (or len) for the
//              last segment. Segment s spans [s ? marks[s-1]+2 : 0, marks[s]).
//   hasff[s] = 1 iff segment s's data contains any 0xFF byte (a stuffing
//              pair or an FF fill byte) — the packer takes a test-free fast
//              path on the overwhelmingly FF-free segments, and the marks
//              array (8 B/segment) replaces the old 16 B spans array plus
//              its separate parallel fill pass (~0.2 ms/4K frame serial).
//
// Detection is context-free — the second byte of a stuffed/RST pair is
// never 0xFF, so "scan[i]==FF && scan[i+1] in D0..D7" is exact regardless
// of chunking. The buffer may extend past the scan's end (EOI + trailers):
// the first FF followed by a real marker (not 00/RST/FF) terminates the
// scan, and marks found past it (RST lookalikes in trailing garbage) are
// dropped. Returns false on interval-count mismatch.
bool build_marks(const uint8_t* scan, int64_t len, int64_t expected, int nt,
                 std::vector<int64_t>& marks, std::vector<uint8_t>& hasff) {
  struct Chunk {
    std::vector<int64_t> m;  // RST FF positions (ascending)
    std::vector<uint8_t> f;  // FF seen in the segment ending at m[i]
    uint8_t tail = 0;        // FF seen after the last local mark
    int64_t term = -1;       // first real-marker FF in this chunk
  };
  std::vector<Chunk> cs(nt);
  auto find_markers = [&](int t) {
    int64_t lo = len * t / nt, hi = len * (t + 1) / nt;
    Chunk& c = cs[t];
    c.m.reserve(static_cast<size_t>(expected) / nt + 8);
    c.f.reserve(static_cast<size_t>(expected) / nt + 8);
    int64_t term = -1;
    bool tail = false;
    rst_walk(
        scan, lo, hi, len,
        [&](int64_t i, bool pend) -> bool {
          c.m.push_back(i);
          c.f.push_back(pend ? 1 : 0);
          return true;
        },
        &term, &tail);
    c.tail = tail ? 1 : 0;
    c.term = term;
  };
  Pool::instance().run(nt, find_markers);

  int64_t term = len;
  int tterm = nt - 1;  // last chunk whose marks/flags are real
  for (int t = 0; t < nt; t++)
    if (cs[t].term >= 0) {
      term = cs[t].term;
      tterm = t;
      break;
    }
  // Count kept marks (drop RST lookalikes at/past the terminator).
  std::vector<int64_t> kept(nt, 0);
  int64_t total = 0;
  for (int t = 0; t <= tterm; t++) {
    size_t k = cs[t].m.size();
    while (k > 0 && cs[t].m[k - 1] >= term) k--;
    kept[t] = static_cast<int64_t>(k);
    total += kept[t];
  }
  if (total + 1 != expected) return false;
  marks.resize(static_cast<size_t>(expected));
  hasff.resize(static_cast<size_t>(expected));
  int64_t base = 0;
  uint8_t pend = 0;  // FF flag carried across chunks with no kept marks
  for (int t = 0; t <= tterm; t++) {
    int64_t k = kept[t];
    if (k > 0) {
      std::memcpy(marks.data() + base, cs[t].m.data(), sizeof(int64_t) * k);
      std::memcpy(hasff.data() + base, cs[t].f.data(), k);
      hasff[base] |= pend;
      pend = cs[t].tail;
      base += k;
    } else {
      pend |= cs[t].tail;
    }
  }
  marks[static_cast<size_t>(expected - 1)] = term;
  hasff[static_cast<size_t>(expected - 1)] = pend;
  return true;
}

// Pack the raw bytes [begin, end) of segment `seg` (destuffing inline).
// Returns destuffed byte count, or -1 if it overflows W*4 - guard bytes.
// Fast path: segments with no 0xFF at all (the common case) are copied four
// bytes at a time straight into the strided column.
int64_t pack_segment(const uint8_t* scan, SegSpan span, uint32_t* words,
                     int32_t W, int64_t seg, int64_t max_bytes) {
  const int64_t raw = span.end - span.begin;
  const int64_t g = seg / kSegsPerBlock;
  const int64_t s = (seg % kSegsPerBlock) / kLanes;
  const int64_t l = seg % kLanes;
  uint32_t* col = words + (g * W * kSublanes + s) * kLanes + l;
  constexpr int64_t kStride = kSublanes * kLanes;  // u32s between words

  if (std::memchr(scan + span.begin, 0xFF, static_cast<size_t>(raw)) == nullptr) {
    if (raw > max_bytes) return -1;
    const uint8_t* src = scan + span.begin;
    int64_t w = 0, i = 0;
    for (; i + 4 <= raw; i += 4, w++) {
      uint32_t v;
      std::memcpy(&v, src + i, 4);
      col[w * kStride] = __builtin_bswap32(v);  // MSB-first
    }
    if (i < raw) {
      uint32_t v = 0;
      for (int64_t k = i; k < raw; k++)
        v |= static_cast<uint32_t>(src[k]) << (24 - 8 * (k - i));
      col[w * kStride] = v;
    }
    return raw;
  }

  // Slow path: destuff byte by byte, accumulating words.
  int64_t off = 0;
  uint32_t acc = 0;
  for (int64_t i = span.begin; i < span.end;) {
    uint8_t b = scan[i];
    if (b == 0xFF && i + 1 < span.end && scan[i + 1] == 0x00) {
      i += 2;
    } else {
      i += 1;
    }
    if (off >= max_bytes) return -1;
    acc |= static_cast<uint32_t>(b) << (24 - 8 * (off & 3));
    if ((off & 3) == 3) {
      col[(off >> 2) * kStride] = acc;
      acc = 0;
    }
    off++;
  }
  if (off & 3) col[(off >> 2) * kStride] = acc;
  return off;
}

}  // namespace

namespace {

#if defined(__AVX2__)
// kLenTab + (32 - n) loads a byte mask whose first n bytes are 0xFF.
alignas(32) static const uint8_t kLenTab[64] = {
    0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF,
    0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF,
    0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF,
    0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF,
    0,    0,    0,    0,    0,    0,    0,    0,
    0,    0,    0,    0,    0,    0,    0,    0,
    0,    0,    0,    0,    0,    0,    0,    0,
    0,    0,    0,    0,    0,    0,    0,    0};

// FF-free short-segment pack: one masked 32-byte load + per-u32 byte
// reverse into a W-word row, zeroing the pad tail. The ONE source of truth
// for the fast path shared by pack_segment_row, the serial packer's emit,
// and the pooled per-block worker. Preconditions: raw <= 32, raw <= W*4,
// src + 32 readable, span known FF-free.
extern "C++" {
// ``bswap`` is the per-u32 byte-reverse shuffle control
// (kBswap32(), hoisted by loop callers so it stays in a register).
template <bool kWide>  // compile-time W >= 8 (callers hoist the width class)
__attribute__((always_inline)) inline void pack_short_row(
    const uint8_t* src, int64_t raw, uint32_t* row, int64_t W,
    const __m256i bswap) {
  const __m256i v =
      _mm256_loadu_si256(reinterpret_cast<const __m256i*>(src));
  const __m256i keep = _mm256_loadu_si256(
      reinterpret_cast<const __m256i*>(kLenTab + 32 - raw));
  const __m256i out0 = _mm256_shuffle_epi8(_mm256_and_si256(v, keep), bswap);
  if (kWide) {
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(row), out0);
    for (int64_t k = 8; k < W; k++) row[k] = 0;
  } else {
    // W < 8: masked store of exactly W words (zero tail included).
    const __m256i wm = _mm256_loadu_si256(
        reinterpret_cast<const __m256i*>(kLenTab + 32 - 4 * W));
    _mm256_maskstore_epi32(reinterpret_cast<int*>(row), wm, out0);
  }
}
}  // extern "C++"

static inline __m256i kBswap32() {
  return _mm256_setr_epi8(
      3, 2, 1, 0, 7, 6, 5, 4, 11, 10, 9, 8, 15, 14, 13, 12,
      3, 2, 1, 0, 7, 6, 5, 4, 11, 10, 9, 8, 15, 14, 13, 12);
}

static inline void pack_short_row_dispatch(const uint8_t* src, int64_t raw,
                                           uint32_t* row, int64_t W) {
  if (W >= 8)
    pack_short_row<true>(src, raw, row, W, kBswap32());
  else
    pack_short_row<false>(src, raw, row, W, kBswap32());
}
#endif

// Pack one segment into a contiguous row of W MSB-first words, zeroing the
// row's padding tail (so callers need no bulk memset of the words buffer).
// `safe_end` is the number of bytes readable from `scan` (the fast path
// overreads up to 31 bytes past the span, never past safe_end).
// `has_ff` comes from build_marks: false means the span is guaranteed
// FF-free, so the fast paths skip their in-range FF movemask test.
// Returns destuffed byte count or -1 on overflow.
//
// Fast path: segments average a few dozen bytes and are overwhelmingly
// FF-free, so one 32-byte masked load + per-u32 byte-reverse shuffle + one
// store covers the whole segment; the 8-byte word loop below handles longer
// segments, and the byte loop destuffs when an FF appears.
int64_t pack_segment_row(const uint8_t* scan, SegSpan span, uint32_t* row,
                         int64_t W, int64_t safe_end, bool has_ff = true) {
  const int64_t max_bytes = W * 4;
  const int64_t raw = span.end - span.begin;
  const uint8_t* src = scan + span.begin;
#if defined(__AVX2__)
  if (raw <= 32 && raw <= max_bytes && span.begin + 32 <= safe_end) {
    const __m256i v =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(src));
    uint32_t ffm = 0;
    if (has_ff) {
      ffm = static_cast<uint32_t>(_mm256_movemask_epi8(
          _mm256_cmpeq_epi8(v, _mm256_set1_epi8(static_cast<char>(0xFF)))));
    }
    const uint32_t lenm =
        raw >= 32 ? 0xFFFFFFFFu : ((1u << raw) - 1u);
    if ((ffm & lenm) == 0) {
      pack_short_row_dispatch(src, raw, row, W);
      return raw;
    }
  }
  // Two-load variant for 33-64 byte segments (the common case right above
  // the 32-byte path at typical restart-interval sizes).
  if (raw > 32 && raw <= 64 && raw <= max_bytes &&
      span.begin + 64 <= safe_end) {
    const __m256i v0 =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(src));
    const __m256i v1 =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(src + 32));
    uint64_t ffm = 0;
    if (has_ff) {
      const __m256i ff = _mm256_set1_epi8(static_cast<char>(0xFF));
      ffm = static_cast<uint32_t>(
                _mm256_movemask_epi8(_mm256_cmpeq_epi8(v0, ff))) |
            (static_cast<uint64_t>(static_cast<uint32_t>(
                 _mm256_movemask_epi8(_mm256_cmpeq_epi8(v1, ff))))
             << 32);
    }
    const uint64_t lenm =
        raw >= 64 ? ~0ull : ((1ull << raw) - 1ull);
    if ((ffm & lenm) == 0) {
      const __m256i bswap = _mm256_setr_epi8(
          3, 2, 1, 0, 7, 6, 5, 4, 11, 10, 9, 8, 15, 14, 13, 12,
          3, 2, 1, 0, 7, 6, 5, 4, 11, 10, 9, 8, 15, 14, 13, 12);
      _mm256_storeu_si256(reinterpret_cast<__m256i*>(row),
                          _mm256_shuffle_epi8(v0, bswap));
      const __m256i keep = _mm256_loadu_si256(
          reinterpret_cast<const __m256i*>(kLenTab + 32 - (raw - 32)));
      const __m256i out1 =
          _mm256_shuffle_epi8(_mm256_and_si256(v1, keep), bswap);
      if (W >= 16) {
        _mm256_storeu_si256(reinterpret_cast<__m256i*>(row + 8), out1);
        for (int64_t k = 16; k < W; k++) row[k] = 0;
      } else {
        // W in [9, 16): masked store of the W-8 valid words.
        const __m256i wm = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(
            kLenTab + 32 - 4 * (W - 8)));
        _mm256_maskstore_epi32(reinterpret_cast<int*>(row + 8), wm, out1);
      }
      return raw;
    }
  }
#else
  (void)safe_end;
#endif
  int64_t i = 0, w = 0;
  while (i + 8 <= raw) {
    uint64_t v;
    std::memcpy(&v, src + i, 8);
    if (has_ff_u64(v)) break;
    if (i + 8 > max_bytes) break;  // tail may still fit; byte loop decides
    uint64_t b = __builtin_bswap64(v);
    row[w] = static_cast<uint32_t>(b >> 32);
    row[w + 1] = static_cast<uint32_t>(b);
    w += 2;
    i += 8;
  }
  // Byte loop for the remainder (tail < 8 bytes, or an 0xFF was sighted).
  int64_t off = i;
  uint32_t acc = 0;
  for (; i < raw;) {
    uint8_t b = src[i];
    if (b == 0xFF && i + 1 < raw && src[i + 1] == 0x00) {
      i += 2;
    } else {
      i += 1;
    }
    if (off >= max_bytes) return -1;
    acc |= static_cast<uint32_t>(b) << (24 - 8 * (off & 3));
    if ((off & 3) == 3) {
      row[off >> 2] = acc;
      acc = 0;
    }
    off++;
  }
  if (off & 3) row[off >> 2] = acc;
  for (int64_t k = (off + 3) >> 2; k < W; k++) row[k] = 0;
  return off;
}

// Single-pass serial pack into the block layout: walk the scan's FF bytes
// ONCE, emitting each segment into an L1-resident 8-row strip as its
// terminating RST marker is found — no marks array, no second byte walk.
// This is the steady-state streaming configuration (n_threads == 1: stream
// callers run several single-threaded prepares concurrently), where the
// two-phase build_marks+pack costs ~40% more wall time per frame.
//
// Position bookkeeping is incremental (segment -> (MCU row, column) ->
// tiled slot with shifts only; no divisions in the loop). Padding slots are
// zeroed afterwards from the active mask (scattered under the tiled
// permutation, but only ~7% of rows on typical geometry).
// Returns 0, or -2 segment overflow, -3 interval count mismatch.
// Templated on bandedness so the common unbanded emit path carries no
// division/branch for the sharded band layout.
extern "C++" {
// flatten: the emit/pack lambdas MUST inline into the walk loop — an
// outlined per-segment call costs ~0.2 ms/frame (measured when the
// inliner declined after a refactor).
template <bool kBanded, bool kWide>
__attribute__((flatten, noinline)) int pack_blocks_fused_serial_impl(const uint8_t* scan, int64_t len,
                                    int64_t expected, int32_t W, int32_t G,
                                    uint32_t* words, int32_t* active,
                                    int64_t safe, int32_t tile_spr,
                                    int32_t tile_ntc, int32_t tile_band_rows) {
  const int64_t total = static_cast<int64_t>(G) * kSegsPerBlock;
  std::memset(active, 0, sizeof(int32_t) * total);
  const bool tiled = tile_spr > 0 && tile_ntc > 0;

  thread_local std::vector<uint32_t> strip;
  strip.resize(8 * static_cast<size_t>(W));
  // Hoisted raw pointer: thread_local access from a dlopen'd shared
  // library is a __tls_get_addr CALL per use — per-segment that cost
  // ~0.4 ms/4K frame (measured .so vs static link).
  uint32_t* const stripp = strip.data();
  int64_t k8 = 0;
#if defined(__AVX2__)
  k8 = W & ~int64_t{7};
#endif
  uint32_t present = 0;         // bitmask of packed strip rows
  int64_t cur_block = -1, cur_r0 = 0;

  auto flush = [&]() {
    if (cur_block < 0 || !present) {
      present = 0;
      return;
    }
    uint32_t* out = words + cur_block * static_cast<int64_t>(W) * kSegsPerBlock;
    if (present == 0xFF) {
#if defined(__AVX2__)
      for (int64_t k0 = 0; k0 < k8; k0 += 8)
        transpose8x8_u32(stripp + k0, W,
                         out + k0 * kSegsPerBlock + cur_r0, kSegsPerBlock);
#endif
      for (int64_t k = k8; k < W; k++) {
        uint32_t* dst = out + k * kSegsPerBlock + cur_r0;
        const uint32_t* src = stripp + k;
        for (int64_t dr = 0; dr < 8; dr++) dst[dr] = src[dr * W];
      }
    } else {
      for (int64_t dr = 0; dr < 8; dr++) {
        if (!((present >> dr) & 1)) continue;
        for (int64_t k = 0; k < W; k++)
          out[k * kSegsPerBlock + cur_r0 + dr] = stripp[dr * W + k];
      }
    }
    present = 0;
  };

  // Incremental segment position: (mr, sc) with shift-only slot math.
  int64_t seg = 0, seg_start = 0, mr = 0, sc = 0;
  bool overflow = false;
  const int64_t ntrb = tile_band_rows > 0 ? (tile_band_rows + 7) >> 3 : 0;
  const int64_t max_bytes = static_cast<int64_t>(W) * 4;
  // Fast-path eligibility cap, hoisted: raw <= fast_cap implies both the
  // 32-byte-load bound and the no-overflow bound.
  const int64_t fast_cap = max_bytes < 32 ? max_bytes : 32;
#if defined(__AVX2__)
  const __m256i bswap32 = kBswap32();
#endif

  auto emit = [&](int64_t end, bool pend) -> bool {
    int64_t row;
    if (tiled) {
      int64_t bt, lmr;
      if (kBanded) {
        lmr = mr % tile_band_rows;
        bt = (mr / tile_band_rows) * ntrb + (lmr >> 3);
      } else {
        lmr = mr;
        bt = mr >> 3;
      }
      row = ((bt * tile_ntc + (sc >> 7)) * kSublanes + (lmr & 7)) * kLanes +
            (sc & 127);
      sc++;
      if (sc == tile_spr) {
        sc = 0;
        mr++;
      }
    } else {
      row = seg;
    }
    seg++;
    if (row < 0 || row >= total) return false;
    const int64_t block = row >> 10;
    const int64_t r = row & 1023;
    if (block != cur_block || (r & ~int64_t{7}) != cur_r0) {
      flush();
      cur_block = block;
      cur_r0 = r & ~int64_t{7};
    }
    const int64_t dr = r & 7;
    uint32_t* rowp = stripp + dr * W;
    const int64_t raw = end - seg_start;
#if defined(__AVX2__)
    // Inlined fast path: FF-free segment of <= 32 bytes (the overwhelming
    // majority at typical restart intervals) — one masked load + byte
    // reverse + store, no call.
    if (!pend && raw <= fast_cap && seg_start + 32 <= safe) {
      pack_short_row<kWide>(scan + seg_start, raw, rowp, W, bswap32);
    } else
#endif
    if (pack_segment_row(scan, {seg_start, end}, rowp, W, safe, pend) < 0)
      return false;
    present |= 1u << dr;
    active[row] = 1;
    seg_start = end + 2;
    return true;
  };

  int64_t term = -1;
  bool tail_pend = false;
  bool miscount = false;
  rst_walk(
      scan, 0, len, len,
      [&](int64_t i, bool pend) -> bool {
        if (seg >= expected - 1) {
          miscount = true;  // more markers than expected
          return false;
        }
        if (!emit(i, pend)) {
          overflow = true;
          return false;
        }
        return true;
      },
      &term, &tail_pend);
  if (overflow) return -2;
  if (miscount || seg != expected - 1) return -3;
  if (!emit(term >= 0 ? term : len, tail_pend)) return -2;
  flush();

  // Zero the padding slots (active == 0). Scattered under the tiled
  // permutation; strided column stores, ~7% of rows on typical geometry.
  for (int64_t g = 0; g < G; g++) {
    const int32_t* act = active + g * kSegsPerBlock;
    uint32_t* out = words + g * static_cast<int64_t>(W) * kSegsPerBlock;
    for (int64_t r = 0; r < kSegsPerBlock; r++) {
      if (act[r]) continue;
      for (int64_t k = 0; k < W; k++) out[k * kSegsPerBlock + r] = 0;
    }
  }
  return 0;
}
}  // extern "C++"

}  // namespace

// Destuff + split + pack into contiguous per-segment rows [G*1024, W]
// (the device transposes into its vector block layout — sequential writes
// here are ~3x faster than packing the strided device layout on the host).
//   words:  buffer of G*1024*W u32 (caller allocates; zero-filled here)
//   active: buffer of G*1024 i32
//   tile_spr/tile_ntc: raster-tiled slot assignment (scan.py TileMap) —
//     segment s goes to row ((tr*ntc + tc)*8 + su)*128 + lane with
//     mr = s/spr, sc = s%spr, tr = mr/8, su = mr%8, tc = sc/128,
//     lane = sc%128. Zero means linear (row = s).
//   tile_band_rows: banded tiled layout (scan.py TileMap band_rows) — MCU
//     rows split into bands of tile_band_rows rows, each band owning a
//     contiguous run of ceil(band_rows/8)*ntc blocks (the sharded layout).
//     Zero means unbanded.
// Returns 0, or -2 segment overflow, -3 interval count mismatch.
int compeg_pack_rows(const uint8_t* data, int64_t data_len, int64_t offset,
                     int64_t len, int64_t expected, int32_t W, int32_t G,
                     uint32_t* words, int32_t* active, int32_t n_threads,
                     int32_t tile_spr, int32_t tile_ntc,
                     int32_t tile_band_rows) {
  if (len <= 0 || offset < 0 || offset + len > data_len) return -1;
  const uint8_t* scan = data + offset;

  int nt = n_threads > 0 ? n_threads : 1;
  std::vector<int64_t> marks;
  std::vector<uint8_t> hasff;
  if (!build_marks(scan, len, expected, nt, marks, hasff)) return -3;
  auto seg_span = [&](int64_t s) -> SegSpan {
    return {s ? marks[s - 1] + 2 : 0, marks[s]};
  };

  const int64_t nseg = expected;
  const int64_t total = static_cast<int64_t>(G) * kSegsPerBlock;
  std::memset(active, 0, sizeof(int32_t) * total);

  const bool tiled = tile_spr > 0 && tile_ntc > 0;
  if (tiled) {
    // Padding rows are scattered through the buffer under the tiled
    // permutation; zero everything up front (rows overwrite their span).
    std::memset(words, 0, sizeof(uint32_t) * total * W);
  }

  int rc = 0;
  const int64_t safe = data_len - offset;
  // Tasks are finer than the executor count so late-waking pool workers
  // (vCPU wakeup here is ms-scale) still load-balance with the caller.
  const int ntasks = nt > 1 ? nt * 4 : 1;
  std::vector<int> rcs(ntasks, 0);
  int64_t chunk = (nseg + ntasks - 1) / ntasks;
  auto work = [&](int t) {
    // pack_segment_row zeroes each row's padding tail, so no bulk memset.
    int64_t lo = t * chunk, hi = std::min<int64_t>(nseg, lo + chunk);
    for (int64_t s = lo; s < hi; s++) {
      int64_t row = s;
      if (tiled) {
        const int64_t mr = s / tile_spr, sc = s % tile_spr;
        int64_t bt, lmr = mr;
        if (tile_band_rows > 0) {
          const int64_t ntrb = (tile_band_rows + 7) >> 3;
          lmr = mr % tile_band_rows;
          bt = (mr / tile_band_rows) * ntrb + (lmr >> 3);
        } else {
          bt = mr >> 3;
        }
        row = ((bt * tile_ntc + (sc >> 7)) * kSublanes + (lmr & 7)) * kLanes +
              (sc & 127);
      }
      if (row >= total ||
          pack_segment_row(scan, seg_span(s), words + row * W, W, safe,
                           hasff[s] != 0) < 0) {
        rcs[t] = -2;
        return;
      }
      active[row] = 1;
    }
  };
  Pool::instance().run(ntasks, work);
  for (int r : rcs)
    if (r) rc = r;
  // Zero padding rows (contiguous tail in the linear layout).
  if (!tiled && nseg < total)
    std::memset(words + nseg * W, 0, sizeof(uint32_t) * (total - nseg) * W);
  return rc;
}

// Destuff + split + pack straight into the kernel's vector block layout
// [G, W, 8, 128] — the rows layout plus a per-block cache-blocked transpose
// (1024 x W rows fit L1), parallelized over blocks. Emitting blocks on the
// host removes the per-frame rows->blocks device transpose (~0.06 ms/4K
// frame) at ~0.1 ms of pooled host time.
//   words:  buffer of G*W*8*128 u32 (caller allocates; fully written here)
//   active: buffer of G*8*128 i32
//   tile_spr/tile_ntc/tile_band_rows: raster-tiled (optionally banded) slot
//     assignment as in compeg_pack_rows; zero means linear (segment s ->
//     slot s).
// Returns 0, or -2 segment overflow, -3 interval count mismatch.
int compeg_pack_blocks(const uint8_t* data, int64_t data_len, int64_t offset,
                       int64_t len, int64_t expected, int32_t W, int32_t G,
                       uint32_t* words, int32_t* active, int32_t n_threads,
                       int32_t tile_spr, int32_t tile_ntc,
                       int32_t tile_band_rows) {
  if (len <= 0 || offset < 0 || offset + len > data_len) return -1;
  const uint8_t* scan = data + offset;

  int nt = n_threads > 0 ? n_threads : 1;
  if (nt == 1) {
    auto run = [&](auto banded, auto wide) {
      return pack_blocks_fused_serial_impl<decltype(banded)::value,
                                           decltype(wide)::value>(
          scan, len, expected, W, G, words, active, data_len - offset,
          tile_spr, tile_ntc, tile_band_rows);
    };
    using T = std::true_type;
    using F = std::false_type;
    const bool banded = tile_band_rows > 0, wide = W >= 8;
    return banded ? (wide ? run(T{}, T{}) : run(T{}, F{}))
                  : (wide ? run(F{}, T{}) : run(F{}, F{}));
  }
  std::vector<int64_t> marks;
  std::vector<uint8_t> hasff;
  if (!build_marks(scan, len, expected, nt, marks, hasff)) return -3;
  auto seg_span = [&](int64_t s) -> SegSpan {
    return {s ? marks[s - 1] + 2 : 0, marks[s]};
  };
  const int64_t nseg = expected;

  // Phase B (parallel over blocks): pack 8 segments at a time into an
  // L1-resident [8, W] strip, then 8x8-transpose the strip straight into
  // the block's [W, 8, 128] layout (a whole-block [1024, W] staging buffer
  // is ~36 KB at typical W — it spills L1 and re-reads from L2 during the
  // transpose; the strip stays in L1 end to end).
  const bool tiled = tile_spr > 0 && tile_ntc > 0;
  const int64_t safe = data_len - offset;
  const int64_t max_bytes = static_cast<int64_t>(W) * 4;
  // One task per block: fine-grained tasks let the caller and late-waking
  // pool workers (vCPU wakeup here is ms-scale) load-balance naturally.
  std::vector<int> rcs(static_cast<size_t>(G), 0);
  auto work = [&](int g64) {
    const int64_t g = g64;
    // Per-OS-thread strip buffer, reused across tasks and calls. The raw
    // pointer is hoisted: thread_local access from a dlopen'd .so is a
    // __tls_get_addr call per use.
    thread_local std::vector<uint32_t> strip;
    strip.resize(8 * static_cast<size_t>(W));
    uint32_t* const stripp = strip.data();
    int32_t* act = active + g * kSegsPerBlock;
    uint32_t* out = words + g * static_cast<int64_t>(W) * kSegsPerBlock;
    int64_t k8 = 0;
#if defined(__AVX2__)
    k8 = W & ~int64_t{7};
#endif
    for (int64_t r0 = 0; r0 < kSegsPerBlock; r0 += 8) {
      for (int64_t dr = 0; dr < 8; dr++) {
        const int64_t r = r0 + dr;
        int64_t seg;
        if (tiled) {
          // Inverse of the tiled slot map: block g = (bt, tc); slot (s, l)
          // -> MCU row band*band_rows + ltr*8 + s, segment col tc*128+l.
          const int64_t ntc = tile_ntc;
          const int64_t bt = g / ntc;
          const int64_t sc = (g % ntc) * kLanes + (r & 127);
          int64_t mr;
          bool row_ok = true;
          if (tile_band_rows > 0) {
            const int64_t ntrb = (tile_band_rows + 7) >> 3;
            const int64_t lmr = (bt % ntrb) * kSublanes + (r >> 7);
            mr = (bt / ntrb) * tile_band_rows + lmr;
            row_ok = lmr < tile_band_rows;  // band-internal padding rows
          } else {
            mr = bt * kSublanes + (r >> 7);
          }
          seg = (row_ok && sc < tile_spr) ? mr * tile_spr + sc : -1;
        } else {
          seg = g * kSegsPerBlock + r;
        }
        if (seg < 0 || seg >= nseg) {
          std::memset(stripp + dr * W, 0, sizeof(uint32_t) * W);
          act[r] = 0;
          continue;
        }
        const SegSpan sp = seg_span(seg);
        uint32_t* rowp = stripp + dr * W;
#if defined(__AVX2__)
        // Inlined FF-free <=32-byte fast path (see the serial packer).
        const int64_t raw = sp.end - sp.begin;
        if (hasff[seg] == 0 && raw <= 32 && raw <= max_bytes &&
            sp.begin + 32 <= safe) {
          pack_short_row_dispatch(scan + sp.begin, raw, rowp, W);
          act[r] = 1;
          continue;
        }
#endif
        if (pack_segment_row(scan, sp, rowp, W, safe, hasff[seg] != 0) < 0) {
          rcs[g] = -2;
          return;
        }
        act[r] = 1;
      }
#if defined(__AVX2__)
      for (int64_t k0 = 0; k0 < k8; k0 += 8)
        transpose8x8_u32(stripp + k0, W, out + k0 * kSegsPerBlock + r0,
                         kSegsPerBlock);
#endif
      for (int64_t k = k8; k < W; k++) {
        uint32_t* dst = out + k * kSegsPerBlock + r0;
        const uint32_t* src = stripp + k;
        for (int64_t dr = 0; dr < 8; dr++) dst[dr] = src[dr * W];
      }
    }
  };
  if (nt <= 1) {
    for (int64_t g = 0; g < G; g++) work(static_cast<int>(g));
  } else {
    Pool::instance().run(static_cast<int>(G), work);
  }
  for (int r : rcs)
    if (r) return r;
  return 0;
}

// Destuff + split + pack into the TPU block layout.
//   words:  zeroed buffer of G*W*8*128 u32 (caller allocates)
//   active: buffer of G*8*128 i32 (caller allocates)
// Returns 0, or -2 segment overflow, -3 interval count mismatch.
int compeg_pack(const uint8_t* scan, int64_t len, int64_t expected, int32_t W,
                int32_t G, uint32_t* words, int32_t* active, int32_t n_threads) {
  if (len <= 0) return -1;
  // Pass 1: find segment spans (RST boundaries) on the raw bytes,
  // memchr-hopping between FF bytes.
  std::vector<SegSpan> spans;
  spans.reserve(static_cast<size_t>(expected));
  int64_t start = 0;
  int64_t i = 0;
  while (i < len) {
    const void* p = std::memchr(scan + i, 0xFF, static_cast<size_t>(len - i));
    if (p == nullptr) break;
    i = static_cast<const uint8_t*>(p) - scan;
    if (i + 1 >= len) break;
    uint8_t nxt = scan[i + 1];
    if (nxt == 0x00) {
      i += 2;
    } else if (nxt >= 0xD0 && nxt <= 0xD7) {
      spans.push_back({start, i});
      i += 2;
      start = i;
    } else {
      i++;
    }
  }
  spans.push_back({start, len});
  if (static_cast<int64_t>(spans.size()) != expected) return -3;

  const int64_t max_bytes = static_cast<int64_t>(W) * 4;
  const int64_t nseg = spans.size();

  std::memset(words, 0,
              sizeof(uint32_t) * static_cast<size_t>(G) * W * kSegsPerBlock);
  std::memset(active, 0, sizeof(int32_t) * static_cast<size_t>(G) * kSegsPerBlock);

  int rc = 0;
  int nt = n_threads > 0 ? n_threads : 1;
  if (nt > 1) {
    std::vector<std::thread> ts;
    std::vector<int> rcs(nt, 0);
    int64_t chunk = (nseg + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
      ts.emplace_back([&, t]() {
        int64_t lo = t * chunk, hi = std::min<int64_t>(nseg, lo + chunk);
        for (int64_t s = lo; s < hi; s++) {
          if (pack_segment(scan, spans[s], words, W, s, max_bytes) < 0) {
            rcs[t] = -2;
            return;
          }
          active[s] = 1;
        }
      });
    }
    for (auto& th : ts) th.join();
    for (int r : rcs)
      if (r) rc = r;
  } else {
    for (int64_t s = 0; s < nseg; s++) {
      if (pack_segment(scan, spans[s], words, W, s, max_bytes) < 0) return -2;
      active[s] = 1;
    }
  }
  return rc;
}

}  // extern "C"
