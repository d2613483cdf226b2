"""The benchmark's plain reference decoder: baseline JPEG bytes to RGB, in
numpy and plain PyTorch on the CPU.

It imports nothing of the program under test and takes nothing that the
program made: it parses the frame's bytes itself, destuffs and splits the
scan at its restart markers, and entropy-decodes every restart segment in
lockstep (one numpy lane a segment: each segment restarts the DC
predictors, so segments are independent). A scan with no restart markers
is one DC chain; given :class:`Lanes`, the hints of the frame's maker, it
is decoded in lanes all the same, each lane from a bit and the DC
predictors the hints name, and each lane has to stop exactly where the
next starts, with the predictors that lane assumed, or the decode fails.
Then, by the configuration's ``idct``:

* ``float``: dequantize and inverse-DCT as one ``[64, 64]`` float32
  operator a data unit (the DCT basis times the quantizer), ``+ 128.5``,
  clamp to [0, 255], truncate: the program's stated float mode;
* ``islow``: the 13-bit fixed-point integer IDCT after Loeffler et al.
  (libjpeg's ``jidctint``): dequantize in int64, clamp to the int16 range,
  two descaled passes, ``+ 128``, clamp;

then the component planes at their own resolution, chroma upsampled by
sample replication (``nearest``) or libjpeg's triangle filter (``fancy``:
vertical first, then horizontal, clamped at the MCU-padded plane's edge; a
4x ratio replicates), and integer full-range BT.601 with the constants
45/32, 11/32 + 23/32 and 113/64 and arithmetic shifts, clamped.

The same functions at a lower precision are the controls that a sound
comparison has to fail: ``float`` computed in bfloat16 (``precision=
"bf16"``), and ``islow`` with 8-bit constants (``precision="int8"``, the
precision of libjpeg's ``jidctfst``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .annex_k import DEFAULT_TABLES, NATURAL, canonical_codes


class JpegError(ValueError):
    """The bytes are not a baseline JPEG this reference decodes."""


@dataclass
class Lanes:
    """How to decode a restart-less scan in lanes: lane ``i`` decodes
    ``mcus[i]`` MCUs from bit ``bits[i]`` of the destuffed scan with the DC
    predictors ``preds[i]`` (one a component), and has to stop at bit
    ``bits[i + 1]`` with the predictors ``preds[i + 1]``; ``bits[-1]`` is
    the end of the last MCU, where only the padding is left."""

    bits: np.ndarray  # [lanes + 1] int64
    mcus: np.ndarray  # [lanes] int64
    preds: np.ndarray  # [lanes + 1, components] int64


@dataclass
class Frame:
    width: int
    height: int
    # (h, v, quantization table, DC table, AC table) per component, in frame
    # order
    comps: List[Tuple[int, int, int, int, int]]
    qtables: Dict[int, np.ndarray]  # id -> zigzag-order quantizers
    htables: Dict[Tuple[int, int], Tuple[tuple, tuple]]
    ri: int  # restart interval in MCUs, 0 for none
    scan: bytes  # entropy-coded data up to the EOI

    @property
    def max_h(self) -> int:
        return max(c[0] for c in self.comps)

    @property
    def max_v(self) -> int:
        return max(c[1] for c in self.comps)

    @property
    def width_mcus(self) -> int:
        return -(-self.width // (8 * self.max_h))

    @property
    def height_mcus(self) -> int:
        return -(-self.height // (8 * self.max_v))

    @property
    def du_comps(self) -> List[int]:
        """The component of each data unit of an MCU, in scan order."""
        return [i for i, (h, v, *_) in enumerate(self.comps)
                for _ in range(h * v)]


def _u16(b: bytes, i: int) -> int:
    return (b[i] << 8) | b[i + 1]


def parse(data: bytes) -> Frame:
    """The header of a baseline, single-scan, 3-component JPEG and its scan;
    frames without a DHT segment take the Annex K tables."""
    if data[:2] != b"\xff\xd8":
        raise JpegError("no SOI")
    i = 2
    qtables: Dict[int, np.ndarray] = {}
    htables = dict(DEFAULT_TABLES)
    ri = 0
    sof = None
    while i < len(data):
        if data[i] != 0xFF:
            raise JpegError(f"no marker at byte {i}")
        marker = data[i + 1]
        if marker == 0xFF:  # fill byte
            i += 1
            continue
        length = _u16(data, i + 2)
        body = data[i + 4:i + 2 + length]
        if marker == 0xDB:  # DQT
            j = 0
            while j < len(body):
                if body[j] >> 4:
                    raise JpegError("16-bit quantization table")
                qtables[body[j] & 15] = np.frombuffer(
                    body, np.uint8, 64, j + 1).astype(np.int64)
                j += 65
        elif marker == 0xC4:  # DHT
            j = 0
            while j < len(body):
                counts = tuple(body[j + 1:j + 17])
                n = sum(counts)
                htables[(body[j] >> 4, body[j] & 15)] = (
                    counts, tuple(body[j + 17:j + 17 + n]))
                j += 17 + n
        elif marker == 0xDD:  # DRI
            ri = _u16(body, 0)
        elif marker == 0xC0:  # SOF0
            if body[0] != 8:
                raise JpegError("not 8-bit")
            sof = (_u16(body, 1), _u16(body, 3),
                   [(body[6 + 3 * k], body[7 + 3 * k] >> 4,
                     body[7 + 3 * k] & 15, body[8 + 3 * k])
                    for k in range(body[5])])
        elif 0xC1 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise JpegError(f"not baseline (SOF{marker - 0xC0})")
        elif marker == 0xDA:  # SOS
            if sof is None:
                raise JpegError("SOS before SOF")
            height, width, fcomps = sof
            if len(fcomps) != 3 or body[0] != 3:
                raise JpegError("not a 3-component single scan")
            sel = {body[1 + 2 * k]: body[2 + 2 * k] for k in range(3)}
            comps = [(h, v, tq, sel[cid] >> 4, sel[cid] & 15)
                     for cid, h, v, tq in fcomps]
            scan_start = i + 2 + length
            end = _scan_end(data, scan_start)
            return Frame(width, height, comps, qtables, htables, ri,
                         data[scan_start:end])
        elif marker in (0xD8, 0xD9):
            raise JpegError("no scan")
        i += 2 + length
    raise JpegError("no SOS")


def _scan_end(data: bytes, start: int) -> int:
    """The offset of the marker that ends the scan: the first 0xFF not
    followed by a stuffed 0x00 or a restart marker."""
    s = np.frombuffer(data, np.uint8, len(data) - start, start)
    nxt = s[1:]
    ends = np.flatnonzero((s[:-1] == 0xFF) & (nxt != 0)
                          & ((nxt < 0xD0) | (nxt > 0xD7)) & (nxt != 0xFF))
    if not len(ends):
        raise JpegError("scan without an end marker")
    return start + int(ends[0])


def split_segments(scan: bytes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The destuffed scan (zero-padded), each restart segment's first byte
    in it, and each segment's length in bytes. Restart markers must count
    RST0..RST7 in order."""
    s = np.frombuffer(scan, np.uint8)
    ff = np.flatnonzero(s[:-1] == 0xFF)
    nxt = s[ff + 1]
    rst = ff[(nxt >= 0xD0) & (nxt <= 0xD7)]
    stuff = ff[nxt == 0]
    if len(rst):
        expect = np.arange(len(rst)) % 8 + 0xD0
        if not np.array_equal(s[rst + 1], expect):
            raise JpegError("restart markers out of sequence")
    drop = np.zeros(len(s), bool)
    drop[stuff + 1] = True
    drop[rst] = True
    drop[rst + 1] = True
    kept_before = np.cumsum(~drop) - (~drop)  # kept bytes before each byte
    starts = np.concatenate([[0], kept_before[rst]]).astype(np.int64)
    d = s[~drop]
    lens = np.diff(np.concatenate([starts, [len(d)]]))
    return np.concatenate([d, np.zeros(8, np.uint8)]), starts, lens


def _lookup(counts, values) -> Tuple[np.ndarray, np.ndarray]:
    """Symbol and code length for every 16-bit window; length 0 marks a
    window that starts with no code of the table."""
    sym = np.zeros(1 << 16, np.int64)
    ln = np.zeros(1 << 16, np.int64)
    for code, length, value in canonical_codes(counts, values):
        lo = code << (16 - length)
        hi = (code + 1) << (16 - length)
        sym[lo:hi] = value
        ln[lo:hi] = length
    return sym, ln


def _extend(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """T.81 EXTEND: an s-bit magnitude field to its signed value."""
    neg = (s > 0) & (v < (np.int64(1) << np.maximum(s - 1, 0)))
    return np.where(neg, v - (np.int64(1) << s) + 1, v)


def entropy_decode(f: Frame, lanes: Optional[Lanes] = None) -> np.ndarray:
    """Quantized coefficients ``[total_mcus, data units, 64]`` int64 in
    zigzag order, MCUs in raster order; a restart-less scan in the
    ``lanes`` given, if any."""
    total = f.width_mcus * f.height_mcus
    buf, starts, lens = split_segments(f.scan)
    ncomp = len(f.comps)
    if lanes is None:
        ri = f.ri or total
        nseg = -(-total // ri)
        if len(starts) != nseg:
            raise JpegError(f"{len(starts)} restart segments, expected "
                            f"{nseg}")
        mcus = np.full(nseg, ri, np.int64)
        mcus[-1] = total - ri * (nseg - 1)
        pos = 8 * starts  # each lane's next bit in the destuffed scan
        pred = np.zeros((ncomp, nseg), np.int64)
    else:
        mcus = np.asarray(lanes.mcus, np.int64)
        hint_bits = np.asarray(lanes.bits, np.int64)
        hint_preds = np.asarray(lanes.preds, np.int64)
        if f.ri or len(starts) != 1:
            raise JpegError("lanes given for a scan with restart markers")
        if (len(hint_bits) != len(mcus) + 1
                or hint_preds.shape != (len(mcus) + 1, ncomp)
                or mcus.sum() != total or (mcus < 1).any()
                or hint_bits[0] != 0 or hint_preds[0].any()):
            raise JpegError("the lanes do not cover the scan from its start")
        pos = hint_bits[:-1].copy()
        pred = hint_preds[:-1].T.copy()
    nlane = len(mcus)
    du = f.du_comps
    ndu = len(du)
    tables = {}
    for c, (_, _, _, td, ta) in enumerate(f.comps):
        tables[c] = (_lookup(*f.htables[(0, td)]), _lookup(*f.htables[(1, ta)]))
    longest = int(mcus.max())
    coef = np.zeros((nlane, longest * ndu, 64), np.int64)
    bufi = buf.astype(np.int64)

    def window(sel):
        """The next 32 bits of each lane, MSB first (at least 25 valid)."""
        byte = pos[sel] >> 3
        if len(byte) and byte.max() + 3 >= len(bufi):
            raise JpegError("a lane reads past the end of the scan")
        w = ((bufi[byte] << 24) | (bufi[byte + 1] << 16)
             | (bufi[byte + 2] << 8) | bufi[byte + 3])
        return (w << (pos[sel] & 7)) & 0xFFFFFFFF

    def code(sel, table):
        sym_t, len_t = table
        w = window(sel) >> 16
        length = len_t[w]
        if not length.all():
            raise JpegError("invalid Huffman code")
        pos[sel] += length
        return sym_t[w]

    def bits(sel, s):
        v = window(sel) >> (32 - s)
        v = np.where(s > 0, v, 0)
        pos[sel] += s
        return _extend(v, s)

    for m in range(longest):
        lanes_m = np.flatnonzero(mcus > m)
        for b, c in enumerate(du):
            dc_t, ac_t = tables[c]
            k = m * ndu + b
            s = code(lanes_m, dc_t)
            pred[c, lanes_m] += bits(lanes_m, s)
            coef[lanes_m, k, 0] = pred[c, lanes_m]
            live = lanes_m
            at0 = np.ones(len(live), np.int64)
            while len(live):
                rs = code(live, ac_t)
                r, s = rs >> 4, rs & 15
                val = bits(live, s)
                at = at0 + r
                put = s > 0
                if (at[put] > 63).any():
                    raise JpegError("AC run past the end of a block")
                coef[live[put], k, at[put]] = val[put]
                if ((s == 0) & (r != 0) & (r != 15)).any():
                    raise JpegError("invalid AC symbol")
                at0 = at + 1
                go = (rs != 0) & (at0 < 64)
                live, at0 = live[go], at0[go]
    if lanes is None:
        if (pos > 8 * (starts + lens)).any():
            raise JpegError("a segment reads past its end")
    else:
        _check_lanes(pos, pred, hint_bits, hint_preds, buf[:lens[0]])
    return coef.reshape(nlane, longest, ndu, 64)[
        np.arange(longest)[None] < mcus[:, None]]


def _check_lanes(pos, pred, bits, preds, scan) -> None:
    """Each lane stopped where the next starts, leaving the predictors the
    next assumed, and after the last only 1-bits pad the scan's last
    byte."""
    if (pos != bits[1:]).any():
        raise JpegError(f"lane {int(np.argmax(pos != bits[1:]))} did not "
                        "stop where the next starts")
    if (pred.T != preds[1:]).any():
        raise JpegError("a lane left other DC predictors than the next "
                        "assumed")
    rest = np.unpackbits(scan)[bits[-1]:]
    if bits[-1] > 8 * len(scan) or len(rest) >= 8 or not rest.all():
        raise JpegError("the scan goes on past its last MCU")


def _dct_basis() -> np.ndarray:
    """C[k, n] = c(k)/2 cos((2n+1) k pi / 16), float64."""
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    c = np.where(k == 0, 1.0 / np.sqrt(2.0), 1.0)
    return 0.5 * c * np.cos((2 * n + 1) * k * np.pi / 16.0)


def float_operators(quant: np.ndarray) -> np.ndarray:
    """``[data units, 64 zigzag, 64 pixels]`` float32: dequantize and
    inverse-DCT in one product (``quant`` is ``[data units, 64]`` zigzag)."""
    c = _dct_basis()
    # pixel (y, x) from frequency (v, u): C[v, y] C[u, x]
    full = np.einsum("vy,ux->vuyx", c, c).reshape(64, 64)  # natural, pixel
    zig = full[NATURAL]  # zigzag, pixel
    return (zig[None] * quant[:, :, None].astype(np.float64)).astype(
        np.float32)


def idct_float(coef: np.ndarray, quant: np.ndarray,
               precision: str = "f32", block: int = 1 << 16) -> np.ndarray:
    """Quantized zigzag coefficients ``[N, data units, 64]`` to u8 pixels
    ``[N, data units, 64]`` (raster order) through the float operators, in
    float32 or, for the control, bfloat16; in blocks of ``block`` MCUs."""
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
    op = torch.from_numpy(float_operators(quant)).to(dtype)
    out = np.empty(coef.shape, np.uint8)
    for lo in range(0, len(coef), block):
        x = torch.from_numpy(coef[lo:lo + block]).to(dtype)
        pix = torch.einsum("ndz,dzp->ndp", x, op).to(torch.float32)
        pix = torch.clamp(pix + 128.5, 0.0, 255.0)
        out[lo:lo + block] = pix.to(torch.uint8).numpy()
    return out


# 13-bit constants of jidctint (FIX(x) = round(x * 2**13)).
_ISLOW = {
    "0_298631336": 0.298631336, "0_390180644": 0.390180644,
    "0_541196100": 0.541196100, "0_765366865": 0.765366865,
    "0_899976223": 0.899976223, "1_175875602": 1.175875602,
    "1_501321110": 1.501321110, "1_847759065": 1.847759065,
    "1_961570560": 1.961570560, "2_053119869": 2.053119869,
    "2_562915447": 2.562915447, "3_072711026": 3.072711026,
}
PASS1_BITS = 2


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(s, k, bits, shift):
    """One 8-point pass of jidctint on a list of 8 int32 arrays, with
    constants ``k`` of ``bits`` fraction bits, descaled by ``shift``."""
    z2, z3 = s[2], s[6]
    z1 = (z2 + z3) * k["0_541196100"]
    tmp2 = z1 - z3 * k["1_847759065"]
    tmp3 = z1 + z2 * k["0_765366865"]
    tmp0 = (s[0] + s[4]) << bits
    tmp1 = (s[0] - s[4]) << bits
    t10, t13 = tmp0 + tmp3, tmp0 - tmp3
    t11, t12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = s[7], s[5], s[3], s[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * k["1_175875602"]
    t0 = t0 * k["0_298631336"]
    t1 = t1 * k["2_053119869"]
    t2 = t2 * k["3_072711026"]
    t3 = t3 * k["1_501321110"]
    z1 = z1 * -k["0_899976223"]
    z2 = z2 * -k["2_562915447"]
    z3 = z3 * -k["1_961570560"] + z5
    z4 = z4 * -k["0_390180644"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [_descale(v, shift) for v in (
        t10 + t3, t11 + t2, t12 + t1, t13 + t0,
        t13 - t0, t12 - t1, t11 - t2, t10 - t3)]


def idct_int(coef: np.ndarray, quant: np.ndarray,
             precision: str = "int32") -> np.ndarray:
    """Quantized zigzag coefficients ``[N, data units, 64]`` to u8 pixels
    through jidctint in int32 arithmetic (13-bit constants); the control
    ``int8`` takes 8-bit constants."""
    bits = {"int32": 13, "int8": 8}[precision]
    k = {name: np.int32(round(v * (1 << bits))) for name, v in _ISLOW.items()}
    deq = np.clip(coef * quant[None], -32768, 32767).astype(np.int32)
    nat = deq[..., np.argsort(NATURAL)]  # zigzag -> natural order
    blk = [[nat[..., r * 8 + c] for c in range(8)] for r in range(8)]
    p1 = [[None] * 8 for _ in range(8)]
    for c in range(8):
        col = _idct_1d([blk[r][c] for r in range(8)], k, bits,
                       bits - PASS1_BITS)
        for r in range(8):
            p1[r][c] = col[r]
    out = np.empty(coef.shape, np.uint8)
    for r in range(8):
        row = _idct_1d(p1[r], k, bits, bits + PASS1_BITS + 3)
        for c in range(8):
            out[..., r * 8 + c] = np.clip(row[c] + 128, 0, 255)
    return out


def planes(f: Frame, pixels: np.ndarray) -> List[np.ndarray]:
    """Pixel blocks ``[total_mcus, data units, 64]`` to one u8 plane per
    component at its own resolution, MCU-padded."""
    hm, wm = f.height_mcus, f.width_mcus
    out = []
    slot = 0
    for h, v, *_ in f.comps:
        p = pixels[:, slot:slot + h * v].reshape(hm, wm, v, h, 8, 8)
        out.append(p.transpose(0, 2, 4, 1, 3, 5).reshape(hm * v * 8,
                                                         wm * h * 8))
        slot += h * v
    return out


def _fancy_v(p: np.ndarray) -> np.ndarray:
    up = np.concatenate([p[:1], p[:-1]])
    down = np.concatenate([p[1:], p[-1:]])
    out = np.empty((2 * p.shape[0], p.shape[1]), np.int32)
    out[0::2] = (3 * p + up + 1) >> 2
    out[1::2] = (3 * p + down + 2) >> 2
    return out


def _fancy_h(p: np.ndarray) -> np.ndarray:
    left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    out = np.empty((p.shape[0], 2 * p.shape[1]), np.int32)
    out[:, 0::2] = (3 * p + left + 1) >> 2
    out[:, 1::2] = (3 * p + right + 2) >> 2
    return out


def upsample(p: np.ndarray, fx: int, fy: int, fancy: bool) -> np.ndarray:
    p = p.astype(np.int32)
    if fy > 1:
        p = _fancy_v(p) if fancy and fy == 2 else np.repeat(p, fy, axis=0)
    if fx > 1:
        p = _fancy_h(p) if fancy and fx == 2 else np.repeat(p, fx, axis=1)
    return p


def ycbcr_to_rgb(y, cb, cr) -> np.ndarray:
    """Full-range BT.601, integer, arithmetic shifts, clamped."""
    cb = cb - 128
    cr = cr - 128
    r = y + ((45 * cr) >> 5)
    g = y - ((11 * cb + 23 * cr) >> 5)
    b = y + ((113 * cb) >> 6)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode(data: bytes, idct: str = "float", chroma: str = "nearest",
           precision: str = "", lanes: Optional[Lanes] = None) -> np.ndarray:
    """JPEG bytes to ``[H, W, 3]`` u8 RGB. ``idct`` is ``float`` or
    ``islow``, ``chroma`` ``nearest`` or ``fancy``; ``precision`` names a
    control's lower precision (``bf16`` for float, ``int8`` for islow);
    ``lanes``, the hints to decode a restart-less scan in lanes."""
    f = parse(data)
    coef = entropy_decode(f, lanes)
    quant = np.stack([f.qtables[f.comps[c][2]] for c in f.du_comps])
    if idct == "float":
        pix = idct_float(coef, quant, precision or "f32")
    elif idct == "islow":
        pix = idct_int(coef, quant, precision or "int32")
    else:
        raise ValueError(f"unknown idct {idct!r}")
    ps = planes(f, pix)
    up = [upsample(p, f.max_h // h, f.max_v // v, chroma == "fancy")
          for p, (h, v, *_) in zip(ps, f.comps)]
    rgb = ycbcr_to_rgb(*up)
    return rgb[:f.height, :f.width]
