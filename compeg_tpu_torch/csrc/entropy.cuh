// Shared device code of the decode kernels (csrc/decode.cu): the
// per-thread bit reader, canonical Huffman symbol decode and the MCU
// coefficient loop.
//
// Replaces compeg_tpu/ops/entropy.py decode_mcu_coefficients (:268) with
// make_symbol_decoder (:229), decode_dc (:253) and _refill / _consume /
// _decode_code / _extend (:113-219). The Pallas code runs 1024 segments in
// lockstep lanes and so needs select trees for the word and value fetch and
// a symbol-synchronous masked commit loop. Here one thread owns one restart
// segment and walks its MCUs in order, carrying its bit window and its DC
// predictors in registers; words, tables and values are plain loads.
//
// Semantics kept from the reference kernel (each is checked by the tests):
//  * words are MSB-first; the word index is clamped to the row's last word,
//    so lookahead past the end re-reads it and never leaves the row;
//  * code length = 1 + #{j in 1..max_len-1 : c16 >= limits[j]}, ordinal
//    k = clip((c16 >> (16 - ln)) + delta[ln], 0, num_values - 1): an invalid
//    code decodes to a clipped symbol and never faults;
//  * DC magnitude bits s = min(value, 15), AC s = value & 15; code and
//    magnitude bits (ln + s <= 31) are consumed together;
//  * AC: newpos = pos + rrrr + 1, the coefficient is written only when
//    s != 0 and newpos <= 63; only EOB (s == 0, rrrr == 0) ends the block
//    early, ZRL and reserved (run, 0) symbols advance and write nothing; the
//    block also ends at pos >= 63, so every thread terminates on any bits;
//  * under zrl17 (Decoder(zrl_compat=True), the reference's semantics) a ZRL
//    advances one position more, 17 instead of 16 (entropy.py:317-320).
//
// The symbol lookup. The compare loop above costs a load and a compare per
// length, 15 of them for an AC table (max_len 16 on any real stream), and
// the whole decode is bound by the instructions it issues. So a table
// starts with a first-level lookup on the top LUT_BITS bits of the window,
// one 16-bit entry (ln << 8 | value) per prefix, built on the host
// (ops/entropy.py lookup_entries) exactly: limits[L] has zero low 16 - L
// bits, so for L <= LUT_BITS the compare at level L, and with it ln and the
// ordinal, is the same for every window with the prefix. Entry 0 is kept
// for the prefixes whose codes are longer (or invalid, past the last code
// of a table with max_len > LUT_BITS): every window there has
// ln > LUT_BITS, so decode_long runs the compare loop from level
// LUT_BITS + 1 only. The loop's limits and delta are 16 bits (delta mod
// 2^16: the ordinal before the clip is never negative nor above 65535, so
// its low 16 bits are the ordinal), the values 8 bits.
#pragma once

#include <cstdint>

// Mirror of compeg_tpu_torch.ops._build.DecodeParams (all int32).
struct DecodeParams {
  int nseg;        // restart segments (rows) to decode, per frame
  int words;       // u32 words per row (W >= 1)
  int ri;          // MCUs per restart interval
  int total_mcus;  // MCUs in the frame; the last segment may be short
  int dus;         // data units per MCU (1..6)
  int ncomp;       // components (1 or 3)
  int du_to_comp[6];
  int width;       // frame size in pixels (fused kernel only)
  int height;
  int width_mcus;
  int rgb;         // samples are already RGB (component IDs R, G, B)
  int comp_h[3];
  int comp_v[3];
  int comp_slot[3];  // first DU slot of each component in the MCU
  int zrl17;       // ZRL advances 17 positions (compat), not 16
  int blk;         // output pixels per DU side: 8, or k of the scaled decode
  int zlen;        // zigzag positions the scaled IDCT reads (its nonzero prefix)
  int frames;      // frames in the launch (fused kernels; the grid's y)
  int frame_rows;  // rows between two frames' first rows (>= nseg)
  // The RGBA composite's sample offsets, from ops/fused.composite_offsets:
  // pixel (r, x) of an MCU reads luma element (row_off[r] & 0xFFFF) +
  // (col_off[x] & 0xFFFF) of its segment's tile and chroma element
  // (row_off[r] >> 16) + (col_off[x] >> 16), data unit d at d * 64.
  int mcu_w;       // output pixels per MCU: blk * max h by blk * max v
  int mcu_h;
  int row_off[16];
  int col_off[32];
  // The planes kernels' store units, from ops/fused.plane_offsets: unit u of
  // an MCU is data unit unit_du[u], together with the next one to its right
  // when unit_pair[u], at sample (unit_row[u], unit_col[u]) of the MCU's
  // footprint in its component's plane.
  int plane_units;     // store units per MCU (1..6)
  int unit_du[6];
  int unit_pair[6];
  int unit_row[6];
  int unit_col[6];
  int plane_pitch[3];  // bytes per row of each component's plane
  // The packed tables (pack_tables): ntables of them, the DC table of
  // component c is table_of[2 * c], its AC table table_of[2 * c + 1].
  int ntables;
  int table_of[6];
  // A banded launch (parallel/sharding.py): frame f is band band0 + f % bands
  // of an image of image_mcus MCUs, cut into bands of total_mcus MCUs, and
  // holds only its band's MCUs inside the image (frame_mcus). bands = 0:
  // every frame holds total_mcus.
  int bands;
  int band0;
  int image_mcus;
  // A lane launch (ops/lanes.py): the frame's restart segments are cut into
  // lanes of ri MCUs, p.nseg of them, and lane v reads the row of segment
  // v * ri / seg_ri from its entry of the lane table (the lane index,
  // decode.cu lane_*_kernel). 0 on every other launch.
  int seg_ri;
};

// One Huffman table as ops/entropy.py pack_tables lays it out, in 16-bit
// halves: the first-level lookup lut[1 << LUT_BITS], limits[16] (levels
// LUT_BITS + 1 .. 15 are read; clipped to 0xFFFF), delta[17]
// (mod 2^16), max_len, num_values, then values[256] as bytes. A table is a
// whole number of 16-byte pieces, so the next one and the tile after the
// last stay aligned. A frame's tables are packed once each, however many
// components share them (DecodeParams::table_of).
constexpr int LUT_BITS = 9;
constexpr int TAB_LUT = 0;
constexpr int TAB_LIMITS = 1 << LUT_BITS;
constexpr int TAB_DELTA = TAB_LIMITS + 16;
constexpr int TAB_MAX_LEN = TAB_DELTA + 17;
constexpr int TAB_NUM_VALUES = TAB_MAX_LEN + 1;
constexpr int TAB_VALUES = TAB_NUM_VALUES + 2;  // in halves; 256 bytes
constexpr int TAB_HALVES = (TAB_VALUES + 128 + 7) / 8 * 8;
constexpr int TAB_WORDS = TAB_HALVES / 2;
constexpr int MAX_TABLES = 6;  // a DC and an AC table for each of 3 components

// MCUs frame `frame` of a banded launch (bands > 0) holds of its band:
// clip(image_mcus - band * total_mcus, 0, total_mcus), the sum over the band
// of the JAX package's seg_mcus (compeg_tpu/parallel/sharding.py
// prepare_banded). A band past the image holds none.
__device__ __forceinline__ int frame_mcus(const DecodeParams& p, int frame) {
  const long long left = (long long)p.image_mcus -
                         (long long)(p.band0 + frame % p.bands) * p.total_mcus;
  return left <= 0 ? 0 : (left < p.total_mcus ? (int)left : p.total_mcus);
}

// MCUs segment `seg` of a frame of `mcus` MCUs holds:
// min(ri, mcus - seg * ri), none (<= 0) past the end.
__device__ __forceinline__ int segment_mcus(const DecodeParams& p, int seg,
                                            int mcus) {
  if (seg >= p.nseg) return 0;
  long long left = (long long)mcus - (long long)seg * p.ri;
  return left < p.ri ? (int)left : p.ri;
}

// `row` points into shared memory (the block's row cache) or, for rows too
// long for it, into device memory.
struct BitReader {
  const uint32_t* row;
  int last;       // index of the row's last word
  int widx;       // next word to fetch (unclamped)
  int nbits;      // valid bits at the top of `win`, 0..63
  uint64_t win;   // MSB-aligned window; bits below `nbits` are zero

  __device__ __forceinline__ void init(const uint32_t* r, int words) {
    row = r;
    last = words - 1;
    widx = 0;
    nbits = 0;
    win = 0;
  }

  // Start at bit `bit` of the row: the window then holds what the serial
  // reader's holds there, since a word is fetched by its absolute index,
  // clamped alike, and every read lies inside the valid bits.
  __device__ __forceinline__ void init_at(const uint32_t* r, int words,
                                          int bit) {
    init(r, words);
    widx = bit >> 5;
    refill();
    win <<= bit & 31;
    nbits -= bit & 31;
  }

  // The position of the next unread bit in the row.
  __device__ __forceinline__ int bit() const { return widx * 32 - nbits; }

  // Top the window up to >= 32 valid bits. nbits < 32 here, so the shift
  // is 1..32 and never reaches 64.
  __device__ __forceinline__ void refill() {
    if (nbits < 32) {
      const uint32_t* at = row + (widx < last ? widx : last);
      const uint32_t w = *at;
      win |= (uint64_t)w << (32 - nbits);
      ++widx;
      nbits += 32;
    }
  }
};

// T.81 EXTEND: an s-bit magnitude to its signed value; s == 0 gives 0.
__device__ __forceinline__ int extend(int v, int s) {
  int vt = (1 << s) >> 1;
  return v < vt ? v - (1 << s) + 1 : v;
}

// The code length and value (ln << 8 | value) of a window whose prefix has
// no first-level entry: ln > LUT_BITS, found by the compare loop from level
// LUT_BITS + 1. The reference loop stops below max_len; counting the levels
// from max_len on too (the last code's end, then 0xFFFF) adds to ln only
// where the window is at max_len already, hence the min.
__device__ __forceinline__ int decode_long(int c16, const uint16_t* tab) {
  int ln = LUT_BITS + 1;
#pragma unroll
  for (int j = LUT_BITS + 1; j < 16; ++j) ln += c16 >= (int)tab[TAB_LIMITS + j];
  ln = min(ln, (int)tab[TAB_MAX_LEN]);
  const int k = min(((c16 >> (16 - ln)) + tab[TAB_DELTA + ln]) & 0xFFFF,
                    (int)tab[TAB_NUM_VALUES] - 1);
  return ln << 8 | reinterpret_cast<const uint8_t*>(tab + TAB_VALUES)[k];
}

// Decode one symbol with table `tab`; returns the symbol value and sets the
// magnitude width `s` (DC: min(value, 15), AC: value & 15) and its raw bits.
template <class Reader>
__device__ __forceinline__ int decode_symbol(Reader& br, const uint16_t* tab,
                                             bool dc, int& s, int& mag) {
  br.refill();
  const int c16 = (int)(br.win >> 48);
  int e = tab[TAB_LUT + (c16 >> (16 - LUT_BITS))];
  if (e == 0) e = decode_long(c16, tab);
  const int ln = e >> 8, value = e & 0xFF;
  s = dc ? min(value, 15) : (value & 15);
  const int n = ln + s;  // 1..31 <= nbits - 1
  mag = s ? (int)((br.win >> (64 - n)) & ((1u << s) - 1u)) : 0;
  br.win <<= n;
  br.nbits -= n;
  return value;
}

// Decode one MCU's coefficients. `put(du, pos, value)` stores one raw
// (still quantized) coefficient at zigzag position `pos`; the target must be
// zeroed beforehand, since only DC and nonzero AC values are stored.
// `dp` holds the DC predictors, reset by the caller at segment start.
template <class Reader, class Put>
__device__ __forceinline__ void decode_mcu(Reader& br, int* dp,
                                           const uint16_t* tables,
                                           const DecodeParams& p, Put put) {
  for (int d = 0; d < p.dus; ++d) {
    const int comp = p.du_to_comp[d];
    const uint16_t* dctab = tables + p.table_of[2 * comp] * TAB_HALVES;
    const uint16_t* actab = tables + p.table_of[2 * comp + 1] * TAB_HALVES;
    int s, mag;
    decode_symbol(br, dctab, true, s, mag);
    // int32 predictor that wraps like the reference's on garbage input.
    dp[comp] = (int)((unsigned)dp[comp] + (unsigned)extend(mag, s));
    put(d, 0, dp[comp]);
    int pos = 0;
    while (pos < 63) {
      const int value = decode_symbol(br, actab, false, s, mag);
      const int rrrr = value >> 4;
      const int newpos = pos + rrrr + 1 + (p.zrl17 && s == 0 && rrrr == 15);
      if (s != 0 && newpos <= 63) put(d, newpos, extend(mag, s));
      pos = (s == 0 && rrrr == 0) ? 64 : newpos;
    }
  }
}

// The entropy decode symbol by symbol from any place, as the lane index
// (decode.cu lane_*_kernel) walks it: data unit d of the MCU is next, with
// pos = -1 for its DC symbol, else the zigzag position its block has reached
// (0..62); kind() folds the two into one int, 0 at an MCU's start. step()
// decodes one symbol with decode_mcu's reads and semantics: a DC symbol adds
// its difference to its component's sum (dc0, dc1, dc2, wrapping) and opens
// the block's AC run; an AC symbol moves pos as decode_mcu does, and the
// block ends at EOB or pos >= 63, where the next data unit's DC follows (d
// back to 0 after the MCU's last). The data unit's two tables are looked up
// once a block and the sums are registers, so the chain of one symbol holds
// only the window, a table entry and the shifts.
struct LaneWalk {
  BitReader br;
  int d, pos, comp;
  const uint16_t* dctab;
  const uint16_t* actab;
  unsigned dc0, dc1, dc2;

  __device__ __forceinline__ void unit(int du, const uint16_t* tables,
                                       const DecodeParams& p) {
    d = du;
    comp = p.du_to_comp[du];
    dctab = tables + p.table_of[2 * comp] * TAB_HALVES;
    actab = tables + p.table_of[2 * comp + 1] * TAB_HALVES;
  }

  // At bit `bit` of a row in state `kind`, the sums zero.
  __device__ __forceinline__ void start(const uint32_t* row, int words,
                                        int bit, int kind,
                                        const uint16_t* tables,
                                        const DecodeParams& p) {
    br.init_at(row, words, bit);
    unit(kind >> 6, tables, p);
    pos = (kind & 63) - 1;
    dc0 = dc1 = dc2 = 0;
  }

  __device__ __forceinline__ int kind() const { return d * 64 + pos + 1; }
  __device__ __forceinline__ bool mcu_start() const {
    return d == 0 && pos < 0;
  }

  __device__ __forceinline__ void step(const uint16_t* tables,
                                       const DecodeParams& p) {
    int s, mag;
    if (pos < 0) {
      decode_symbol(br, dctab, true, s, mag);
      const unsigned v = (unsigned)extend(mag, s);
      dc0 += comp == 0 ? v : 0u;
      dc1 += comp == 1 ? v : 0u;
      dc2 += comp == 2 ? v : 0u;
      pos = 0;
      return;
    }
    const int value = decode_symbol(br, actab, false, s, mag);
    const int rrrr = value >> 4;
    pos = (s == 0 && rrrr == 0)
              ? 64
              : pos + rrrr + 1 + (p.zrl17 && s == 0 && rrrr == 15);
    if (pos >= 63) {
      pos = -1;
      unit(d + 1 == p.dus ? 0 : d + 1, tables, p);
    }
  }
};
