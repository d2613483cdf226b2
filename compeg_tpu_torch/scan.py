"""Entropy-coded scan preprocessing: the Python packer.

The port's copy of what it uses from compeg_tpu/scan.py: byte-destuffing
(``FF 00`` -> ``FF``), restart-marker removal and the per-segment layout,
every restart segment in its own fixed-width row of MSB-first u32 words
(the kernels' bit window needs no byte swap). :func:`to_device_layout` keeps
the reference's ``[G, W, 8, 128]`` block arrangement, so that it stays
comparable with the JAX package's function array for array;
``pipeline.Decoder`` transposes it back into the linear ``[G * 1024, W]``
rows the CUDA kernels read. The raster-tiled slot permutation (``TileMap``)
is a TPU layout and is not carried over.

This module is the Python twin of the C++ implementation in
``native/compeg_host.cpp``: the documented alternative where no C++ compiler
exists, and the test oracle for the native packer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .errors import bail

# Block geometry of the reference layout: SUBLANES*LANES segments per block.
LANES = 128
SUBLANES = 8
SEGMENTS_PER_BLOCK = SUBLANES * LANES

# No guard words are needed past a segment's payload: the kernel's refill
# clamps its word index to the row end, so lookahead past the final byte
# re-reads the last word — bits a valid stream never consumes.
GUARD_WORDS = 0


def split_intervals(scan: bytes, expected: int) -> List[bytes]:
    """Destuff and split the scan into per-restart-interval byte strings.

    Removes RST markers and ``FF 00`` stuffing (keeping the ``FF``); errors if
    the number of intervals found differs from ``expected`` (corruption
    detection, reference src/scan.rs:58-63).
    """
    arr = np.frombuffer(scan, dtype=np.uint8)
    n = arr.size
    if n == 0:
        bail("empty scan data")
    ff = arr == 0xFF
    nxt = np.empty_like(arr)
    nxt[:-1] = arr[1:]
    nxt[-1] = 0
    stuffed_ff = ff & (nxt == 0x00)  # FF 00 -> keep FF, drop 00
    marker_ff = ff & (nxt >= 0xD0) & (nxt <= 0xD7)  # RSTn -> drop both

    drop = np.zeros(n, dtype=bool)
    # Drop the 0x00 of each stuffing pair and both bytes of each RST marker.
    idx_stuff = np.nonzero(stuffed_ff)[0]
    drop[idx_stuff[idx_stuff + 1 < n] + 1] = True
    idx_rst = np.nonzero(marker_ff)[0]
    drop[idx_rst] = True
    drop[idx_rst[idx_rst + 1 < n] + 1] = True

    # An 0xFF that is dropped because it is both "stuffing FF" and "RST FF"
    # cannot happen (0x00 vs 0xD0-D7), but an RST's second byte could itself
    # be 0xFF-adjacent; RST bytes are 0xD0-0xD7 so no overlap either.

    kept = ~drop
    cleaned = arr[kept]
    # Interval k ends right before RST marker k; the last interval runs to the
    # end of the scan. Boundary positions in the cleaned stream:
    kept_cum = np.cumsum(kept) - kept  # cleaned index of each original byte
    bounds = kept_cum[idx_rst] if idx_rst.size else np.zeros(0, dtype=np.int64)
    starts = np.concatenate([[0], bounds + 0])
    ends = np.concatenate([bounds, [cleaned.size]])
    count = starts.size
    if count != expected:
        bail(f"scan contains {count} restart intervals, expected {expected}")
    out = [cleaned[s:e].tobytes() for s, e in zip(starts, ends)]
    return out


def _words_per_segment(max_bytes: int) -> int:
    return (max_bytes + 3) // 4 + GUARD_WORDS


@dataclass
class DeviceScan:
    """Scan data in device layout.

    words:  ``[G, W, SUBLANES, LANES]`` uint32 — segment ``s`` of grid block
            ``g = s // 1024`` streams down ``words[g, :, (s%1024)//128, s%128]``.
    active: ``[G, SUBLANES, LANES]`` int32 — 1 for real segments, 0 padding.
    num_segments: real segment count before padding.
    words_per_segment: W.
    """

    words: np.ndarray
    active: np.ndarray
    num_segments: int
    words_per_segment: int

    @property
    def num_blocks(self) -> int:
        # Derived from the active mask ([G, 8, 128]) so it holds for both the
        # block layout ([G, W, 8, 128]) and the contiguous row layout
        # ([G*1024, W]) of `words`.
        return self.active.shape[0]


def to_device_layout(
    intervals: List[bytes],
    words_per_segment: Optional[int] = None,
) -> DeviceScan:
    """Lay segments out as ``[G, W, 8, 128]`` blocks of MSB-first u32 words,
    segment ``i`` in slot ``i``.

    ``words_per_segment`` can be forced (a stream's steady width) as long as
    it covers the longest segment.
    """
    nseg = len(intervals)
    max_bytes = max(len(s) for s in intervals)
    w = _words_per_segment(max_bytes)
    if words_per_segment is not None:
        if words_per_segment < w:
            bail(
                f"words_per_segment={words_per_segment} too small for "
                f"longest segment ({w} words needed)"
            )
        w = words_per_segment
    g = -(-nseg // SEGMENTS_PER_BLOCK)
    byte_plane = np.zeros((g * SEGMENTS_PER_BLOCK, w * 4), dtype=np.uint8)
    for row, seg in enumerate(intervals):
        byte_plane[row, : len(seg)] = np.frombuffer(seg, dtype=np.uint8)
    words = byte_plane.reshape(g * SEGMENTS_PER_BLOCK, w, 4).astype(np.uint32)
    words = (
        (words[..., 0] << 24) | (words[..., 1] << 16) | (words[..., 2] << 8) | words[..., 3]
    )
    words = words.reshape(g, SUBLANES, LANES, w).transpose(0, 3, 1, 2)
    active = np.zeros(g * SEGMENTS_PER_BLOCK, dtype=np.int32)
    active[:nseg] = 1
    active = active.reshape(g, SUBLANES, LANES)
    return DeviceScan(
        words=np.ascontiguousarray(words),
        active=active,
        num_segments=nseg,
        words_per_segment=w,
    )
