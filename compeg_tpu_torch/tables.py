"""Shared constant tables: zigzag order, example quantization tables (the
port's copy of compeg_tpu/tables.py).

ZIGZAG maps raster position -> zigzag index (same orientation as the
reference's table, src/dct.wgsl:29-38): ``ZIGZAG[row*8+col]`` is the index in
the zigzag-ordered coefficient stream that holds the (row, col) coefficient.
"""

from __future__ import annotations

import numpy as np

ZIGZAG = np.array(
    [
        0, 1, 5, 6, 14, 15, 27, 28,
        2, 4, 7, 13, 16, 26, 29, 42,
        3, 8, 12, 17, 25, 30, 41, 43,
        9, 11, 18, 24, 31, 40, 44, 53,
        10, 19, 23, 32, 39, 45, 52, 54,
        20, 22, 33, 38, 46, 51, 55, 60,
        21, 34, 37, 47, 50, 56, 59, 61,
        35, 36, 48, 49, 57, 58, 62, 63,
    ],
    dtype=np.int32,
)

# Inverse: UNZIGZAG[z] = raster position of zigzag index z.
UNZIGZAG = np.argsort(ZIGZAG).astype(np.int32)

# ITU T.81 Annex K.1 example quantization tables (zigzag order), used by the
# test-asset encoder at quality 50.
K1_LUMA_QTABLE_RASTER = np.array(
    [
        16, 11, 10, 16, 24, 40, 51, 61,
        12, 12, 14, 19, 26, 58, 60, 55,
        14, 13, 16, 24, 40, 57, 69, 56,
        14, 17, 22, 29, 51, 87, 80, 62,
        18, 22, 37, 56, 68, 109, 103, 77,
        24, 35, 55, 64, 81, 104, 113, 92,
        49, 64, 78, 87, 103, 121, 120, 101,
        72, 92, 95, 98, 112, 100, 103, 99,
    ],
    dtype=np.int32,
)

K1_CHROMA_QTABLE_RASTER = np.array(
    [
        17, 18, 24, 47, 99, 99, 99, 99,
        18, 21, 26, 66, 99, 99, 99, 99,
        24, 26, 56, 99, 99, 99, 99, 99,
        47, 66, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
    ],
    dtype=np.int32,
)


def raster_to_zigzag(q_raster: np.ndarray) -> np.ndarray:
    """Reorder a 64-entry raster-order table into zigzag order."""
    out = np.zeros(64, dtype=q_raster.dtype)
    out[ZIGZAG] = q_raster
    return out


def zigzag_to_raster(q_zigzag: np.ndarray) -> np.ndarray:
    """Reorder a 64-entry zigzag-order table into raster order."""
    return q_zigzag[ZIGZAG]


def scale_qtable(base_raster: np.ndarray, quality: int) -> np.ndarray:
    """IJG quality scaling of a base table (raster order in, raster out)."""
    quality = min(max(quality, 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    q = (base_raster * scale + 50) // 100
    return np.clip(q, 1, 255).astype(np.int32)
