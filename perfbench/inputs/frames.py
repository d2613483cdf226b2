"""A cell's frames, made from its configuration and the run's seed.

Each configuration names one or more small base images (smooth fields plus
noise, from the configuration's own content seed), encoded once by the
benchmark's encoder at the configuration's sampling, quality and restart
interval and cached under ``build/perfbench/`` in the checkout. A frame is
the base's header with the SOF set to the configuration's size, and a scan
of the base images' restart segments drawn from the run's seed: every
restart segment restarts the DC predictors, so any sequence of them is a
valid scan once the RST markers count 0..7 in order. Segments are drawn in
runs of eight that begin at a segment index divisible by eight, so that
each run keeps its own markers RST0..RST7. Each frame is distinct and has
the configuration's geometry; no frame is encoded whole.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from typing import List

import numpy as np

from .encoder import encode

# ROOT/build/perfbench: beside the program's build cache, inside the
# checkout, at a fixed path.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
CACHE = os.path.join(ROOT, "build", "perfbench")
RUN = 8  # segments a draw: one RST0..RST7 cycle
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


def _encode_base(cfg: dict, k: int) -> bytes:
    b = cfg["base"]
    img = base_image(b["height"], b["width"], b["content_seed"] + k)
    return encode(img, sampling=cfg["sampling"], quality=cfg["quality"],
                  restart_interval_mcus=cfg["restart_interval_mcus"],
                  emit_dht=cfg["emit_dht"])


def base_jpegs(cfg: dict) -> List[bytes]:
    """The configuration's base images as JPEG bytes, encoded on the first
    call in a checkout and read from the cache afterwards."""
    keys = ("sampling", "quality", "restart_interval_mcus", "emit_dht",
            "base")
    tag = hashlib.sha256(json.dumps({k: cfg[k] for k in keys},
                                    sort_keys=True).encode()).hexdigest()[:16]
    out = []
    for k in range(cfg["base"]["images"]):
        path = os.path.join(CACHE, f"base_{tag}_{k}.jpg")
        if os.path.exists(path):
            with open(path, "rb") as f:
                out.append(f.read())
            continue
        data = _encode_base(cfg, k)
        os.makedirs(CACHE, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        out.append(data)
    return out


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


@dataclass
class Source:
    """What frames are drawn from: the header (SOF patched to the cell's
    size) and every base image's runs of segments."""

    header: bytes
    runs: List[bytes]
    segments: int  # restart segments in a frame of the cell's size


def source(cfg: dict) -> Source:
    bases = base_jpegs(cfg)
    header, sof, _ = _header_and_scan(bases[0])
    h, w = cfg["height"], cfg["width"]
    header = bytearray(header)
    header[sof + 5:sof + 9] = bytes([h >> 8, h & 255, w >> 8, w & 255])
    runs = [r for b in bases for r in runs_of_segments(_header_and_scan(b)[2])]
    mcu_w, mcu_h = MCU[cfg["sampling"]]
    mcus = -(-w // mcu_w) * -(-h // mcu_h)
    ri = cfg["restart_interval_mcus"]
    if mcus % ri or (mcus // ri) % RUN:
        raise ValueError(f"{mcus} MCUs in segments of {ri} are no whole "
                         f"number of runs of {RUN} segments")
    return Source(bytes(header), runs, mcus // ri)


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one use (``stream``) of a run's seed, any whole
    number: different seeds and different uses draw apart."""
    return np.random.default_rng([abs(seed), int(seed < 0), stream])


def frame(src: Source, seed: int, j: int) -> bytes:
    """Frame ``j`` of ``seed``: a scan of ``src.segments`` segments drawn
    with replacement, in runs of eight, by a generator of its own, so that
    any frame can be made again without the others."""
    idx = rng(seed, 1000 + j).integers(0, len(src.runs), src.segments // RUN)
    body = b"".join([src.runs[i] for i in idx])[:-2]  # no marker at the end
    return src.header + body + b"\xff\xd9"


def pool(cfg: dict, seed: int, n: int) -> List[bytes]:
    """The cell's first ``n`` frames for ``seed``."""
    src = source(cfg)
    return [frame(src, seed, j) for j in range(n)]
