"""A baseline JPEG encoder in numpy: the benchmark's own source of frames.

A frozen copy of the program's test-asset encoder (``encoder.py`` of the
port), with the constants of T.81 taken from :mod:`perfbench.reference.
annex_k` instead of the program's modules, so that a change to the program
cannot change the benchmark's inputs. Produces baseline (SOF0) JPEGs with a
chosen chroma subsampling and restart interval; with ``emit_dht=False`` an
MJPEG-style frame that relies on the Annex K Huffman tables. Slow (a Python
loop a block): the harness encodes small base images once and caches them.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..reference.annex_k import (CHROMA_QTABLE, DEFAULT_TABLES, LUMA_QTABLE,
                                 ZIGZAG, canonical_codes, scale_qtable)


def _encode_map(table) -> Dict[int, Tuple[int, int]]:
    """value -> (code, length) of an Annex K table."""
    return {value: (code, length)
            for code, length, value in canonical_codes(*table)}


def raster_to_zigzag(q_raster: np.ndarray) -> np.ndarray:
    out = np.zeros(64, dtype=q_raster.dtype)
    out[ZIGZAG] = q_raster
    return out


# Forward DCT basis: C[k, n] = c(k)/2 * cos((2n+1) k pi / 16).
def _dct_matrix() -> np.ndarray:
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    c = np.where(k == 0, 1.0 / np.sqrt(2.0), 1.0)
    return 0.5 * c * np.cos((2 * n + 1) * k * np.pi / 16.0)


_C = _dct_matrix()


class BitWriter:
    def __init__(self) -> None:
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0
        self.bits = 0  # bits put so far: the position in the destuffed scan

    def put(self, code: int, length: int) -> None:
        if length == 0:
            return
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.nbits += length
        self.bits += length
        while self.nbits >= 8:
            self.nbits -= 8
            b = (self.acc >> self.nbits) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)  # byte stuffing
        # Keep only the bits not yet written: an accumulator that kept them
        # all would grow with the scan and make a large frame quadratic.
        self.acc &= (1 << self.nbits) - 1

    def pad_to_byte(self) -> None:
        if self.nbits:
            self.put(0x7F, 8 - self.nbits)  # pad with 1-bits

    def raw_marker(self, marker: int) -> None:
        self.pad_to_byte()
        self.out += bytes([0xFF, marker])


def _magnitude(v: int) -> Tuple[int, int]:
    """T.81's (size, bits) of a coefficient or DC difference ``v``."""
    if v == 0:
        return 0, 0
    s = abs(v).bit_length()
    return s, v if v > 0 else v + (1 << s) - 1


def dc_symbol(diff: int, dc_map: Dict[int, Tuple[int, int]]) -> Tuple[int, int]:
    """A DC difference's whole symbol, its Huffman code followed by its
    magnitude bits, as ``(bits, length)``."""
    s, bits = _magnitude(diff)
    code, ln = dc_map[s]
    return (code << s) | bits, ln + s


def _encode_block(
    bw: BitWriter,
    block: np.ndarray,  # 8x8 float, already level-shifted
    q_raster: np.ndarray,
    dc_pred: int,
    dc_map: Dict[int, Tuple[int, int]],
    ac_map: Dict[int, Tuple[int, int]],
) -> int:
    coeffs = _C @ block @ _C.T
    q = np.round(coeffs / q_raster.reshape(8, 8)).astype(np.int64)
    zz = np.zeros(64, dtype=np.int64)
    zz[ZIGZAG] = q.reshape(-1)

    bw.put(*dc_symbol(int(zz[0]) - dc_pred, dc_map))

    run = 0
    last_nz = 0
    for k in range(1, 64):
        if zz[k] != 0:
            last_nz = k
    for k in range(1, last_nz + 1):
        if zz[k] == 0:
            run += 1
            continue
        while run > 15:
            code, ln = ac_map[0xF0]  # ZRL
            bw.put(code, ln)
            run -= 16
        s, bits = _magnitude(int(zz[k]))
        code, ln = ac_map[(run << 4) | s]
        bw.put(code, ln)
        bw.put(bits, s)
        run = 0
    if last_nz != 63:
        code, ln = ac_map[0x00]  # EOB
        bw.put(code, ln)
    return int(zz[0])


SAMPLING_PRESETS = {
    "444": ((1, 1), (1, 1), (1, 1)),
    "422": ((2, 1), (1, 1), (1, 1)),
    "420": ((2, 2), (1, 1), (1, 1)),
    "440": ((1, 2), (1, 1), (1, 1)),
    "411": ((4, 1), (1, 1), (1, 1)),
    "gray": ((1, 1),),
}


def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """JFIF full-range BT.601."""
    r = rgb[..., 0].astype(np.float64)
    g = rgb[..., 1].astype(np.float64)
    b = rgb[..., 2].astype(np.float64)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168735892 * r - 0.331264108 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418687589 * g - 0.081312411 * b
    return np.clip(np.stack([y, cb, cr], axis=-1).round(), 0, 255)


def encode(rgb: np.ndarray, **kw) -> bytes:
    """Encode an ``[H, W, 3]`` (or ``[H, W]`` grayscale) u8 image; the
    keywords are :func:`encode_indexed`'s."""
    return encode_indexed(rgb, **kw)[0]


def dc_maps(ncomp: int) -> List[Dict[int, Tuple[int, int]]]:
    """Each component's DC code map: the Annex K luminance table for the
    first, the chrominance table for the others."""
    return [_encode_map(DEFAULT_TABLES[(0, 0 if ci == 0 else 1)])
            for ci in range(ncomp)]


def encode_indexed(
    rgb: np.ndarray,
    *,
    sampling: str = "422",
    quality: int = 90,
    restart_interval_mcus: Optional[int] = 1,
    app0: bool = True,
    emit_dht: bool = True,
) -> Tuple[bytes, Dict[str, np.ndarray]]:
    """Encode an ``[H, W, 3]`` (or ``[H, W]`` grayscale) u8 image, and
    index its scan.

    ``restart_interval_mcus=None`` omits DRI entirely (one giant interval).
    ``emit_dht=False`` produces an MJPEG-style stream relying on the Annex K
    defaults. The index, int64 arrays whose bit positions count in the
    destuffed scan (restart markers and stuffed zero bytes taken out):

    * ``mcu_bit`` ``[M + 1]``: each MCU's first bit; last, the bit after the
      last MCU, before the final padding;
    * ``dc_bit``, ``dc_len`` ``[M, C]``: where the DC symbol (code and
      magnitude bits) of each component's first data unit in the MCU
      starts, and its length in bits;
    * ``dc_first``, ``dc_last`` ``[M, C]``: the DC value of each
      component's first and last data unit in the MCU (the last is the
      predictor the MCU leaves).
    """
    if sampling not in SAMPLING_PRESETS:
        raise ValueError(f"unknown sampling {sampling}")
    samp = SAMPLING_PRESETS[sampling]
    ncomp = len(samp)
    if ncomp == 1:
        if rgb.ndim == 3:
            rgb = rgb[..., 0]
        planes = [rgb.astype(np.float64)]
    else:
        if rgb.ndim != 3:
            raise ValueError("color encode needs an [H, W, 3] array")
        ycc = rgb_to_ycbcr(rgb)
        planes = [ycc[..., i] for i in range(3)]

    h, w = planes[0].shape
    max_h = max(s[0] for s in samp)
    max_v = max(s[1] for s in samp)
    mcu_w, mcu_h = 8 * max_h, 8 * max_v
    wm = -(-w // mcu_w)
    hm = -(-h // mcu_h)

    q_luma = scale_qtable(LUMA_QTABLE, quality)
    q_chroma = scale_qtable(CHROMA_QTABLE, quality)
    qtabs = [q_luma] + ([q_chroma] if ncomp > 1 else [])
    comp_q = [0] + [1] * (ncomp - 1)

    # Subsample each plane to its component resolution (box filter), padded
    # to full MCUs with edge replication.
    comp_planes: List[np.ndarray] = []
    for ci, (sh, sv) in enumerate(samp):
        p = planes[ci]
        fx, fy = max_h // sh, max_v // sv
        pw, ph = wm * mcu_w, hm * mcu_h
        padded = np.pad(p, ((0, ph - h), (0, pw - w)), mode="edge")
        if fx > 1 or fy > 1:
            padded = padded.reshape(ph // fy, fy, pw // fx, fx).mean(axis=(1, 3))
        comp_planes.append(np.round(padded))

    dcm = dc_maps(ncomp)
    ac_maps = [_encode_map(DEFAULT_TABLES[(1, 0 if ci == 0 else 1)])
               for ci in range(ncomp)]

    # -- entropy-coded data -------------------------------------------------
    bw = BitWriter()
    dc_pred = [0] * ncomp
    ri = restart_interval_mcus
    total_mcus = wm * hm
    rst = 0
    mcus_in_interval = 0
    index: Dict[str, list] = {k: [] for k in (
        "mcu_bit", "dc_bit", "dc_len", "dc_first", "dc_last")}
    for m in range(total_mcus):
        mx, my = m % wm, m // wm
        index["mcu_bit"].append(bw.bits)
        first = []
        for ci, (sh, sv) in enumerate(samp):
            plane = comp_planes[ci]
            qt = qtabs[comp_q[ci]]
            for v in range(sv):
                for hh in range(sh):
                    y0 = (my * sv + v) * 8
                    x0 = (mx * sh + hh) * 8
                    block = plane[y0 : y0 + 8, x0 : x0 + 8] - 128.0
                    pred, at = dc_pred[ci], bw.bits
                    dc_pred[ci] = _encode_block(
                        bw, block, qt, dc_pred[ci], dcm[ci], ac_maps[ci]
                    )
                    if v == 0 and hh == 0:
                        first.append((at, dc_symbol(dc_pred[ci] - pred,
                                                    dcm[ci])[1], dc_pred[ci]))
        for key, vals in zip(("dc_bit", "dc_len", "dc_first"), zip(*first)):
            index[key].append(vals)
        index["dc_last"].append(list(dc_pred))
        mcus_in_interval += 1
        if ri and mcus_in_interval == ri and m != total_mcus - 1:
            bw.raw_marker(0xD0 + rst)
            rst = (rst + 1) % 8
            dc_pred = [0] * ncomp
            mcus_in_interval = 0
    index["mcu_bit"].append(bw.bits)
    bw.pad_to_byte()
    scan = bytes(bw.out)

    # -- container ----------------------------------------------------------
    out = bytearray(b"\xFF\xD8")
    if app0:
        payload = b"JFIF\x00" + bytes([1, 1, 0]) + struct.pack(">HH", 1, 1) + b"\x00\x00"
        out += b"\xFF\xE0" + struct.pack(">H", 2 + len(payload)) + payload
    for slot, qr in enumerate(qtabs):
        zz = raster_to_zigzag(qr)
        payload = bytes([slot]) + bytes(int(v) for v in zz)
        out += b"\xFF\xDB" + struct.pack(">H", 2 + len(payload)) + payload
    sof = bytes([8]) + struct.pack(">HH", h, w) + bytes([ncomp])
    for ci, (sh, sv) in enumerate(samp):
        sof += bytes([ci + 1, (sh << 4) | sv, comp_q[ci]])
    out += b"\xFF\xC0" + struct.pack(">H", 2 + len(sof)) + sof
    if emit_dht:
        specs = [(0, 0, *DEFAULT_TABLES[(0, 0)]),
                 (1, 0, *DEFAULT_TABLES[(1, 0)])]
        if ncomp > 1:
            specs += [(0, 1, *DEFAULT_TABLES[(0, 1)]),
                      (1, 1, *DEFAULT_TABLES[(1, 1)])]
        for cls, slot, counts, values in specs:
            payload = bytes([(cls << 4) | slot]) + bytes(counts) + bytes(values)
            out += b"\xFF\xC4" + struct.pack(">H", 2 + len(payload)) + payload
    if ri:
        out += b"\xFF\xDD" + struct.pack(">HH", 4, ri)
    sos = bytes([ncomp])
    for ci in range(ncomp):
        t = 0 if ci == 0 else 1
        sos += bytes([ci + 1, (t << 4) | t])
    sos += bytes([0, 63, 0])
    out += b"\xFF\xDA" + struct.pack(">H", 2 + len(sos)) + sos
    out += scan
    out += b"\xFF\xD9"
    return bytes(out), {k: np.asarray(v, np.int64) for k, v in index.items()}
