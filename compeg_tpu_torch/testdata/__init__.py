"""Golden reference data for checking the port where the JAX package is not
imported (``chip_smoke.py`` on the card).

``smoke.npz`` holds small streams of every supported sampling with the golden
decoder's raw coefficients, float and integer RGB, integer planes, scaled RGB
and fancy RGB; a ZRL stream and a stream of int32-wrapping blocks with their
answers; and for ``bench_assets/bench4k.jpg`` the digests of golden's
coefficients, RGB, integer RGB, integer planes and fancy RGB plus some of
golden's float and scaled RGB rows; small batches of frames that differ with
golden's answer for every frame; and the digests of golden's 4K answers
rolled by whole MCU rows, the answers of :func:`rotate_restart_segments`'s
frames. tests/test_torch_smoke_vectors.py writes it and checks it against
golden. :func:`garbage_scan` makes frames of random entropy bits from a
stream, for checks that every kernel terminates and agrees with its plain
version on them.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "smoke.npz")


def load(path: str = PATH) -> dict:
    """Every array of the file, by name."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def digest(a: np.ndarray) -> str:
    """sha256 of an array's dtype, shape and C-order bytes."""
    a = np.ascontiguousarray(a)
    head = f"{a.dtype.str} {a.shape}".encode()
    return hashlib.sha256(head + a.tobytes()).hexdigest()


def rotate_restart_segments(data: bytes, scan_offset: int, scan_len: int,
                            segments: int) -> bytes:
    """``data`` with the restart segments of its scan rotated left by
    ``segments``: segment ``j`` of the result is segment ``j + segments`` of
    ``data``. Every segment decodes on its own (the DC predictors restart),
    so with a restart interval of one MCU and ``segments`` a multiple of the
    MCUs per row this is the picture rolled up by that many MCU rows, made
    without an encoder. ``segments`` and the segment count must be multiples
    of 8, so that every segment keeps the RSTn marker that follows it."""
    scan = np.frombuffer(data, np.uint8, scan_len, scan_offset)
    rst = np.flatnonzero((scan[:-1] == 0xFF) & (scan[1:] >= 0xD0)
                         & (scan[1:] <= 0xD7))
    count = len(rst) + 1
    if segments % 8 or count % 8 or not 0 <= segments < count:
        raise ValueError(f"cannot rotate {count} segments by {segments}")
    if segments == 0:
        return bytes(data)
    # Each segment with the marker after it; the last one gets RST7, which
    # it would carry were it not the last (count % 8 == 0).
    pieces = scan.tobytes() + b"\xff\xd7"
    cut = int(rst[segments - 1]) + 2
    body = (pieces[cut:] + pieces[:cut])[:-2]
    return data[:scan_offset] + body + data[scan_offset + scan_len:]


def garbage_scan(data: bytes, scan_offset: int, scan_len: int,
                 seed: int) -> bytes:
    """``data`` with every byte of its scan replaced by a random one from
    ``seed`` except each 0xFF and the byte after it (restart markers and
    stuffing), so the frame keeps its segments and their count while their
    entropy bits are garbage."""
    scan = np.frombuffer(data, np.uint8, scan_len, scan_offset).copy()
    keep = scan == 0xFF
    keep[1:] |= keep[:-1]
    noise = np.random.default_rng(seed).integers(0, 255, scan.size,
                                                 dtype=np.uint8)
    scan[~keep] = noise[~keep]
    return data[:scan_offset] + scan.tobytes() + data[scan_offset + scan_len:]
