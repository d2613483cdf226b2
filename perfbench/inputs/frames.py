"""A cell's frames, made from its configuration and the run's seed.

Each configuration names one or more small base images (smooth fields plus
noise, from the configuration's own content seed), encoded once by the
benchmark's encoder at the configuration's sampling, quality and restart
interval and cached under ``build/perfbench/`` in the checkout. A frame is
the base's header with the SOF set to the configuration's size, and a scan
drawn from the run's seed out of the base images' scans by one of three
sources, which the configuration's own values choose:

* :class:`RunsOfEight`, where a frame's restart segments come in whole runs
  of eight: every restart segment restarts the DC predictors, so any
  sequence of them is a valid scan once the RST markers count 0..7 in
  order. Segments are drawn in runs of eight that begin at a segment index
  divisible by eight, so that each run keeps its own markers RST0..RST7.
* :class:`Segments`, any other restart interval: single segments drawn with
  replacement, their markers renumbered RST0..RST7 in frame order.
* :class:`McuRuns`, no restart interval (no DRI, one DC chain): runs of
  :data:`R` MCUs that start at any MCU of any base, spliced at the bit
  level. The encoder's index of each base (cached beside its JPEG) gives
  each MCU's bits; each run's first DC symbol of each component is encoded
  again against the predictor the run before it left; the whole is
  byte-stuffed and padded with 1-bits. The source reports where each run
  starts (:meth:`McuRuns.lanes`), so that the reference can decode the
  frame in lanes.

Each frame is distinct and has the configuration's geometry; no frame is
encoded whole.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..reference.jpeg import Lanes
from .encoder import dc_maps, dc_symbol, encode_indexed

# ROOT/build/perfbench: beside the program's build cache, inside the
# checkout, at a fixed path.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
CACHE = os.path.join(ROOT, "build", "perfbench")
RUN = 8  # segments a draw: one RST0..RST7 cycle
R = 8  # MCUs a run of a restart-less frame
MCU = {"444": (8, 8), "422": (16, 8), "420": (16, 16), "440": (8, 16),
       "411": (32, 8)}  # MCU width and height of each sampling


def base_image(height: int, width: int, seed: int) -> np.ndarray:
    """``[H, W, 3]`` u8: three smooth fields plus Gaussian noise (sigma 6),
    the kind of content ``bench_assets/gen_4k.py`` makes, here from
    ``seed``."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    p = r.uniform(0.7, 1.4, 6)
    f = np.stack([
        128 + 90 * np.sin(xx / (97.0 * p[0])) + 30 * np.cos(yy / (53.0 * p[1])),
        128 + 80 * np.cos(xx / (71.0 * p[2]) + yy / (131.0 * p[3])),
        128 + 70 * np.sin((xx + yy) / (157.0 * p[4] * p[5])),
    ], axis=-1)
    return np.clip(f + r.normal(0, 6, f.shape), 0, 255).astype(np.uint8)


def _encode_base(cfg: dict, k: int) -> Tuple[bytes, Dict[str, np.ndarray]]:
    b = cfg["base"]
    img = base_image(b["height"], b["width"], b["content_seed"] + k)
    return encode_indexed(img, sampling=cfg["sampling"],
                          quality=cfg["quality"],
                          restart_interval_mcus=cfg["restart_interval_mcus"],
                          emit_dht=cfg["emit_dht"])


def _write(path: str, write) -> None:
    """``write(file)`` into ``path`` by way of a file of its own, renamed."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


def _bases(cfg: dict, indexed: bool
           ) -> List[Tuple[bytes, Optional[Dict[str, np.ndarray]]]]:
    """Each base image's JPEG bytes and, where ``indexed``, the encoder's
    index of its scan; encoded on the first call in a checkout and read
    from the cache afterwards."""
    keys = ("sampling", "quality", "restart_interval_mcus", "emit_dht",
            "base")
    tag = hashlib.sha256(json.dumps({k: cfg[k] for k in keys},
                                    sort_keys=True).encode()).hexdigest()[:16]
    out = []
    for k in range(cfg["base"]["images"]):
        path = os.path.join(CACHE, f"base_{tag}_{k}.jpg")
        ipath = os.path.join(CACHE, f"base_{tag}_{k}.npz")
        if os.path.exists(path) and (not indexed or os.path.exists(ipath)):
            with open(path, "rb") as f:
                data = f.read()
            index = None
            if indexed:
                with np.load(ipath) as z:
                    index = dict(z)
            out.append((data, index))
            continue
        data, index = _encode_base(cfg, k)
        os.makedirs(CACHE, exist_ok=True)
        if indexed:
            _write(ipath, lambda f: np.savez(f, **index))
        _write(path, lambda f: f.write(data))
        out.append((data, index if indexed else None))
    return out


def base_jpegs(cfg: dict) -> List[bytes]:
    """The configuration's base images as JPEG bytes, encoded on the first
    call in a checkout and read from the cache afterwards."""
    return [data for data, _ in _bases(cfg, False)]


def _header_and_scan(data: bytes):
    """(header up to and including the SOS segment, offset of the SOF0
    segment, the scan bytes)."""
    i = 2
    sof = None
    while True:
        marker = data[i + 1]
        length = (data[i + 2] << 8) | data[i + 3]
        if marker == 0xC0:
            sof = i
        if marker == 0xDA:
            start = i + 2 + length
            end = data.rindex(b"\xff\xd9")
            return data[:start], sof, data[start:end]
        i += 2 + length


def runs_of_segments(scan: bytes) -> List[bytes]:
    """The scan cut into runs of eight restart segments, each run with the
    marker after each of its segments (RST0..RST7); a last run short of
    eight segments is left out."""
    s = np.frombuffer(scan, np.uint8)
    rst = np.flatnonzero((s[:-1] == 0xFF) & (s[1:] >= 0xD0) & (s[1:] <= 0xD7))
    whole = scan + b"\xff\xd7"  # the last segment's marker, were it not last
    ends = np.concatenate([rst + 2, [len(whole)]])
    nseg = len(ends)
    runs = []
    lo = 0
    for j in range(RUN - 1, nseg - nseg % RUN, RUN):
        hi = int(ends[j])
        runs.append(whole[lo:hi])
        lo = hi
    return runs


def segments_of(scan: bytes, count: int) -> List[bytes]:
    """The first ``count`` restart segments of a scan, without their
    markers."""
    s = np.frombuffer(scan, np.uint8)
    rst = np.flatnonzero((s[:-1] == 0xFF) & (s[1:] >= 0xD0) & (s[1:] <= 0xD7))
    lo = np.concatenate([[0], rst + 2])
    hi = np.concatenate([rst, [len(scan)]])
    return [scan[a:b] for a, b in zip(lo[:count], hi[:count])]


def _mcus(width: int, height: int, sampling: str) -> int:
    mcu_w, mcu_h = MCU[sampling]
    return -(-width // mcu_w) * -(-height // mcu_h)


@dataclass
class RunsOfEight:
    """Frames of the base images' runs of eight restart segments, under
    the header (SOF patched to the cell's size)."""

    header: bytes
    runs: List[bytes]
    segments: int  # restart segments in a frame of the cell's size

    def frame(self, seed: int, j: int) -> bytes:
        """Frame ``j`` of ``seed``: a scan of ``segments`` segments drawn
        with replacement, in runs of eight, by a generator of its own, so
        that any frame can be made again without the others."""
        idx = rng(seed, 1000 + j).integers(0, len(self.runs),
                                           self.segments // RUN)
        body = b"".join([self.runs[i] for i in idx])[:-2]  # no marker at the end
        return self.header + body + b"\xff\xd9"

    def lanes(self, seed: int, j: int) -> None:
        """No hints: the reference splits the scan at its markers."""
        return None


@dataclass
class Segments:
    """Frames of single restart segments of the base images, drawn with
    replacement, under the header."""

    header: bytes
    segs: List[bytes]  # every whole segment of the bases, markers removed
    segments: int

    def __post_init__(self):
        # destuffed bytes of each segment: a 0xFF inside one is stuffed
        self.destuffed = np.array([len(g) - g.count(b"\xff")
                                   for g in self.segs])

    def _draw(self, seed: int, j: int) -> np.ndarray:
        return rng(seed, 1000 + j).integers(0, len(self.segs), self.segments)

    def frame(self, seed: int, j: int) -> bytes:
        """Frame ``j`` of ``seed``, the segments joined by RST(i mod 8)
        after the ``i``-th, and no marker after the last."""
        parts = []
        for i, g in enumerate(self._draw(seed, j)):
            if i:
                parts.append(bytes([0xFF, 0xD0 + (i - 1) % 8]))
            parts.append(self.segs[g])
        return self.header + b"".join(parts) + b"\xff\xd9"

    def row_bytes(self, seed: int, j: int) -> int:
        """Destuffed bytes of frame ``j``'s longest segment."""
        return int(self.destuffed[self._draw(seed, j)].max())

    def lanes(self, seed: int, j: int) -> None:
        """No hints: the reference splits the scan at its markers."""
        return None


class McuRuns:
    """Restart-less frames of runs of :data:`R` MCUs out of the base
    images' scans, spliced at the bit level, under the header."""

    segments = 1

    def __init__(self, header: bytes, bases, mcus: int):
        self.header, self.mcus = header, mcus
        bits, cols = [], {k: [] for k in ("start", "end", "dc_bit", "dc_len",
                                          "dc_first", "dc_last")}
        starts = []
        off = n = 0
        for data, ix in bases:
            scan = np.frombuffer(_header_and_scan(data)[2], np.uint8)
            keep = np.ones(len(scan), bool)
            keep[np.flatnonzero(scan[:-1] == 0xFF) + 1] = False  # stuffing
            b = np.unpackbits(scan[keep])
            m = len(ix["mcu_bit"]) - 1
            cols["start"].append(ix["mcu_bit"][:-1] + off)
            cols["end"].append(ix["mcu_bit"][1:] + off)
            cols["dc_bit"].append(ix["dc_bit"] + off)
            for k in ("dc_len", "dc_first", "dc_last"):
                cols[k].append(ix[k])
            starts.append(np.arange(n, n + m - R + 1))
            bits.append(b)
            off += len(b)
            n += m
        self.bits = np.concatenate(bits)
        for k, v in cols.items():
            setattr(self, k, np.concatenate(v))
        self.run_starts = np.concatenate(starts)  # every MCU a run can start at
        self.dcm = dc_maps(self.dc_first.shape[1])
        # [C, category]: bits of a DC symbol of that size in each component
        self.dc_size = np.array([[m[s][1] + s for s in range(12)]
                                 for m in self.dcm], np.int64)
        self._symbols: Dict[Tuple[int, int], np.ndarray] = {}

    def _symbol(self, c: int, diff: int) -> np.ndarray:
        """The bits of a DC difference's symbol in component ``c``."""
        key = (min(c, 1), diff)
        got = self._symbols.get(key)
        if got is None:
            code, length = dc_symbol(diff, self.dcm[c])
            got = self._symbols[key] = np.array(
                [(code >> (length - 1 - i)) & 1 for i in range(length)],
                np.uint8)
        return got

    def _plan(self, seed: int, j: int):
        """Frame ``j``'s runs: the first and the last MCU of each, indexed
        over all the bases' MCUs; each run's first DC difference of each
        component, ``[runs, C]``, against the predictors the run before
        left; and the lanes."""
        k = -(-self.mcus // R)
        lens = np.full(k, R, np.int64)
        lens[-1] = self.mcus - R * (k - 1)
        g = self.run_starts[rng(seed, 1000 + j).integers(
            0, len(self.run_starts), k)]
        last = g + lens - 1
        preds = np.zeros((k + 1, self.dc_first.shape[1]), np.int64)
        preds[1:] = self.dc_last[last]
        diff = self.dc_first[g] - preds[:-1]
        size = np.frexp(np.abs(diff))[1]  # T.81's SSSS: the bit length
        new_len = np.take_along_axis(self.dc_size.T, size, 0)
        run_bits = (self.end[last] - self.start[g] - self.dc_len[g].sum(1)
                    + new_len.sum(1))
        bits = np.concatenate([[0], np.cumsum(run_bits)])
        return g, last, diff, Lanes(bits=bits, mcus=lens, preds=preds)

    def frame(self, seed: int, j: int) -> bytes:
        """Frame ``j`` of ``seed``: no DRI, no RST, one DC chain."""
        g, last, diff, _ = self._plan(seed, j)
        pieces = []
        dc_bit, dc_len = self.dc_bit.tolist(), self.dc_len.tolist()
        for gk, ek, dk in zip(g.tolist(), last.tolist(), diff.tolist()):
            cur = int(self.start[gk])
            for c, d in enumerate(dk):
                pieces.append(self.bits[cur:dc_bit[gk][c]])
                pieces.append(self._symbol(c, d))
                cur = dc_bit[gk][c] + dc_len[gk][c]
            pieces.append(self.bits[cur:self.end[ek]])
        bits = np.concatenate(pieces)
        packed = np.packbits(np.concatenate(
            [bits, np.ones(-len(bits) % 8, np.uint8)]))  # pad with 1-bits
        stuffed = np.insert(packed, np.flatnonzero(packed == 0xFF) + 1, 0)
        return self.header + stuffed.tobytes() + b"\xff\xd9"

    def row_bytes(self, seed: int, j: int) -> int:
        """Destuffed bytes of frame ``j``'s one segment."""
        return -(-int(self._plan(seed, j)[3].bits[-1]) // 8)

    def lanes(self, seed: int, j: int) -> Lanes:
        """Where each of frame ``j``'s runs starts in its destuffed scan,
        and the DC predictors it starts from: the hints by which the
        reference decodes the frame in lanes, one a run."""
        return self._plan(seed, j)[3]


def source(cfg: dict):
    """The frame source the configuration's restart interval, size and
    sampling choose."""
    h, w = cfg["height"], cfg["width"]
    ri = cfg["restart_interval_mcus"]
    bases = _bases(cfg, ri is None)
    header, sof, _ = _header_and_scan(bases[0][0])
    header = bytearray(header)
    header[sof + 5:sof + 9] = bytes([h >> 8, h & 255, w >> 8, w & 255])
    header = bytes(header)
    mcus = _mcus(w, h, cfg["sampling"])
    if ri is None:
        return McuRuns(header, bases, mcus)
    if mcus % ri:
        raise ValueError(f"{mcus} MCUs are no whole number of restart "
                         f"intervals of {ri}")
    scans = [_header_and_scan(b)[2] for b, _ in bases]
    if (mcus // ri) % RUN == 0:
        return RunsOfEight(header, [r for s in scans
                                    for r in runs_of_segments(s)],
                           mcus // ri)
    b = cfg["base"]
    whole = _mcus(b["width"], b["height"], cfg["sampling"]) // ri
    return Segments(header, [g for s in scans for g in segments_of(s, whole)],
                    mcus // ri)


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one use (``stream``) of a run's seed, any whole
    number: different seeds and different uses draw apart."""
    return np.random.default_rng([abs(seed), int(seed < 0), stream])


def pool(cfg: dict, seed: int, n: int) -> List[bytes]:
    """The cell's first ``n`` frames for ``seed``."""
    src = source(cfg)
    return [src.frame(seed, j) for j in range(n)]
