// Native JPEG container parser + image analyzer.
//
// The C++ twin of parser.py/metadata.py's per-frame hot path: walks the
// marker-segment structure, collects quantization/Huffman table data, frame
// and scan headers, and locates the entropy-coded scan — everything the
// decoder needs, in one pass over the container bytes (the reference does
// this host-side in Rust: src/file.rs + src/lib.rs:576-851).
//
// Only extraction and structural validation happens here; envelope
// validation (supported samplings, baseline-ness) stays in Python where the
// error messages are produced. Returns 0 on success or a negative status.

#include <cstdint>
#include <cstring>

namespace {

struct Cursor {
  const uint8_t* p;
  int64_t len;
  int64_t pos = 0;

  bool u8(uint8_t* out) {
    if (pos >= len) return false;
    *out = p[pos++];
    return true;
  }
  bool u16(uint16_t* out) {
    if (pos + 2 > len) return false;
    *out = (static_cast<uint16_t>(p[pos]) << 8) | p[pos + 1];
    pos += 2;
    return true;
  }
};

}  // namespace

extern "C" {

// Flat, fixed-size parse result consumed via ctypes.
struct CompegImageInfo {
  int32_t status;  // 0 ok; <0 error (see codes below)
  int32_t width, height, precision, sof_marker;
  int32_t ncomp;
  int32_t comp_id[4], comp_h[4], comp_v[4], comp_q[4];
  int32_t comp_dc[4], comp_ac[4];
  int32_t has_dri, restart_interval;
  int64_t scan_offset, scan_len;
  int32_t ss, se, ah, al;
  int32_t qtab_present[4];
  int32_t qtab[4][64];  // zigzag order, widened to i32
  int32_t n_huff;
  int32_t ht_class[8], ht_dest[8], ht_nvalues[8];
  uint8_t ht_counts[8][16];
  uint8_t ht_values[8][256];
  // Scan header components as written (for frame-order validation, the
  // reference errors when scan order differs: src/lib.rs:742-745).
  int32_t scan_ncomp;
  int32_t scan_comp_id[4];
};

// Error codes.
enum {
  kOk = 0,
  kErrSoi = -1,
  kErrTruncated = -2,
  kErrBadLength = -3,
  kErrBadSegment = -4,
  kErrMultiSof = -5,
  kErrMultiSos = -6,
  kErrNoSof = -7,
  kErrNoSos = -8,
  kErrTooManyComponents = -9,
  kErrTooManyHuffman = -10,
};

int64_t compeg_find_scan_end(const uint8_t* scan, int64_t len, int64_t offset);

int compeg_parse(const uint8_t* data, int64_t len, CompegImageInfo* out) {
  std::memset(out, 0, sizeof(*out));
  Cursor c{data, len};
  uint8_t b0, b1;
  if (!c.u8(&b0) || !c.u8(&b1) || b0 != 0xFF || b1 != 0xD8)
    return out->status = kErrSoi;

  bool have_sof = false, have_sos = false;
  while (c.pos < len) {
    uint8_t b;
    if (!c.u8(&b)) break;
    if (b != 0xFF) return out->status = kErrBadSegment;
    uint8_t marker;
    if (!c.u8(&marker)) return out->status = kErrTruncated;
    while (marker == 0xFF) {  // fill bytes
      if (!c.u8(&marker)) return out->status = kErrTruncated;
    }
    if (marker == 0xD9) break;                      // EOI
    if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;

    uint16_t seglen;
    if (!c.u16(&seglen)) return out->status = kErrTruncated;
    if (seglen < 2) return out->status = kErrBadLength;
    int64_t seg_end = c.pos + seglen - 2;
    if (seg_end > len) return out->status = kErrTruncated;

    switch (marker) {
      case 0xDB: {  // DQT
        while (c.pos < seg_end) {
          uint8_t pqtq;
          if (!c.u8(&pqtq)) return out->status = kErrTruncated;
          int pq = pqtq >> 4, tq = pqtq & 0xF;
          if (pq > 1 || tq > 3) return out->status = kErrBadSegment;
          if (c.pos + (pq ? 128 : 64) > seg_end)
            return out->status = kErrTruncated;
          for (int k = 0; k < 64; k++) {
            int32_t v;
            if (pq) {
              v = (static_cast<int32_t>(data[c.pos]) << 8) | data[c.pos + 1];
              c.pos += 2;
            } else {
              v = data[c.pos++];
            }
            out->qtab[tq][k] = v;
          }
          out->qtab_present[tq] = 1;
        }
        break;
      }
      case 0xC4: {  // DHT
        while (c.pos < seg_end) {
          uint8_t tcth;
          if (!c.u8(&tcth)) return out->status = kErrTruncated;
          int tc = tcth >> 4, th = tcth & 0xF;
          if (tc > 1 || th > 3) return out->status = kErrBadSegment;
          if (out->n_huff >= 8) return out->status = kErrTooManyHuffman;
          if (c.pos + 16 > seg_end) return out->status = kErrTruncated;
          int total = 0;
          int i = out->n_huff;
          for (int k = 0; k < 16; k++) {
            out->ht_counts[i][k] = data[c.pos + k];
            total += data[c.pos + k];
          }
          c.pos += 16;
          if (total > 256 || c.pos + total > seg_end)
            return out->status = kErrBadSegment;
          std::memcpy(out->ht_values[i], data + c.pos, total);
          c.pos += total;
          out->ht_class[i] = tc;
          out->ht_dest[i] = th;
          out->ht_nvalues[i] = total;
          out->n_huff++;
        }
        break;
      }
      case 0xDD: {  // DRI
        uint16_t ri;
        if (!c.u16(&ri)) return out->status = kErrTruncated;
        out->has_dri = 1;
        out->restart_interval = ri;
        c.pos = seg_end;
        break;
      }
      case 0xDA: {  // SOS
        if (have_sos) return out->status = kErrMultiSos;
        have_sos = true;
        uint8_t ns;
        if (!c.u8(&ns)) return out->status = kErrTruncated;
        if (ns > 4) return out->status = kErrTooManyComponents;
        out->scan_ncomp = ns;
        for (int k = 0; k < ns; k++) {
          uint8_t cs, tdta;
          if (!c.u8(&cs) || !c.u8(&tdta)) return out->status = kErrTruncated;
          out->scan_comp_id[k] = cs;
          // Match scan component to frame component by id; order/count
          // validation happens in Python (_finish_analysis) so the error
          // text matches the pure-Python analyzer.
          for (int j = 0; j < out->ncomp; j++) {
            if (out->comp_id[j] == cs) {
              out->comp_dc[j] = tdta >> 4;
              out->comp_ac[j] = tdta & 0xF;
            }
          }
        }
        uint8_t ssv, sev, ahal;
        if (!c.u8(&ssv) || !c.u8(&sev) || !c.u8(&ahal))
          return out->status = kErrTruncated;
        out->ss = ssv;
        out->se = sev;
        out->ah = ahal >> 4;
        out->al = ahal & 0xF;
        c.pos = seg_end;
        out->scan_offset = c.pos;
        c.pos = compeg_find_scan_end(data, len, c.pos);
        out->scan_len = c.pos - out->scan_offset;
        break;
      }
      default: {
        if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 &&
            marker != 0xC8 && marker != 0xCC) {  // SOFn
          if (have_sof) return out->status = kErrMultiSof;
          have_sof = true;
          out->sof_marker = marker;
          uint8_t prec, nc;
          uint16_t h, w;
          if (!c.u8(&prec) || !c.u16(&h) || !c.u16(&w) || !c.u8(&nc))
            return out->status = kErrTruncated;
          if (nc > 4) return out->status = kErrTooManyComponents;
          out->precision = prec;
          out->height = h;
          out->width = w;
          out->ncomp = nc;
          for (int k = 0; k < nc; k++) {
            uint8_t cid, hv, tq;
            if (!c.u8(&cid) || !c.u8(&hv) || !c.u8(&tq))
              return out->status = kErrTruncated;
            out->comp_id[k] = cid;
            out->comp_h[k] = hv >> 4;
            out->comp_v[k] = hv & 0xF;
            out->comp_q[k] = tq;
          }
        }
        c.pos = seg_end;  // APPn/COM/unknown: skip
        break;
      }
    }
  }
  if (!have_sof) return out->status = kErrNoSof;
  if (!have_sos) return out->status = kErrNoSos;
  return out->status = kOk;
}

}  // extern "C"
