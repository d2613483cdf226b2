"""Peaks of the card and the bytes a decode has to move, from shapes.

The least time a piece of work can take on the card is the larger of its
operations over the peak rate and its bytes over the peak bandwidth; every
kernel of the program is bound by bytes (each input byte read once, each
output byte written once). The counts here are of the work, not of the
kernels that do it: the whole decode of a frame reads its entropy-coded
data once and writes its RGBA once, whatever form the program packs the
data in and whatever planes the kernels write and read between them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

# NVIDIA's data sheet for the H100 SXM (80 GB HBM3), dense, at 700 W.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops_per_s": 67e12},
}
DEFAULT_PEAK = "NVIDIA H100 80GB HBM3"


def peak(kind: str) -> dict:
    """The peaks of the card named ``kind``; the H100 SXM's for a name the
    table lacks."""
    return PEAKS.get(kind, PEAKS[DEFAULT_PEAK])


def rows_bytes(nseg: int, words: int) -> int:
    """Packed entropy-coded rows: one ``words``-wide int32 row a restart
    segment."""
    return nseg * words * 4


def rgba_bytes(height: int, width: int) -> int:
    return height * width * 4


def plane_bytes(height: int, width: int,
                samplings: Sequence[Tuple[int, int]]) -> int:
    """The u8 component planes at their own resolution, MCU-padded."""
    max_h = max(h for h, _ in samplings)
    max_v = max(v for _, v in samplings)
    wm = -(-width // (8 * max_h))
    hm = -(-height // (8 * max_v))
    return sum(hm * v * 8 * wm * h * 8 for h, v in samplings)


def operand_bytes(dus: int, exact: bool) -> int:
    """The IDCT operand a fused kernel reads: ``[DUS, 64, 64]`` float32
    operators, or ``[DUS, 64]`` int32 quantizers for the integer IDCT."""
    return dus * 64 * (4 if exact else 64 * 4)


def k2_bytes(nseg, words, height, width, operand=0) -> int:
    """K2 / K2x: rows and the IDCT operand in, RGBA out."""
    return rows_bytes(nseg, words) + operand + rgba_bytes(height, width)


def k3_bytes(nseg, words, height, width, samplings, operand=0) -> int:
    """K3: rows and the IDCT operand in, component planes out."""
    return (rows_bytes(nseg, words) + operand
            + plane_bytes(height, width, samplings))


def e_bytes(height, width, samplings) -> int:
    """E: component planes in, RGBA out."""
    return plane_bytes(height, width, samplings) + rgba_bytes(height, width)


def scan_bytes(jpeg: bytes) -> int:
    """The entropy-coded data of a one-scan JPEG, counted from its bytes:
    what lies between the SOS segment and EOI, less the RST markers and the
    zero bytes stuffed after each 0xFF."""
    i = 2
    while jpeg[i + 1] != 0xDA:
        i += 2 + ((jpeg[i + 2] << 8) | jpeg[i + 3])
    start = i + 2 + ((jpeg[i + 2] << 8) | jpeg[i + 3])
    s = np.frombuffer(jpeg, np.uint8, len(jpeg) - 2 - start, start)
    after_ff = s[1:][s[:-1] == 0xFF]
    rst = int(((after_ff >= 0xD0) & (after_ff <= 0xD7)).sum())
    return len(s) - 2 * rst - int((after_ff == 0).sum())


def decode_bytes(scan: float, height: int, width: int) -> float:
    """A frame's whole decode: its entropy-coded data (``scan`` bytes) read
    once, its RGBA written once."""
    return scan + rgba_bytes(height, width)


def bound_s(nbytes: float, kind: str = DEFAULT_PEAK) -> float:
    """Seconds that ``nbytes`` take at the card's peak bandwidth."""
    return nbytes / peak(kind)["hbm_bytes_per_s"]
