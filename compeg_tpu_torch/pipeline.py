"""Single-image decode orchestration on PyTorch: the port of
:mod:`compeg_tpu.pipeline`'s default path.

A frame decode is host preparation plus ONE kernel launch:

    prepare (host: header cache, native scan_info + destuff/split/pack into
    linear segment rows, device-budget check)
      -> fused_decode_rgba (kernel K2: entropy -> IDCT -> composite,
         written straight into the raster)
      -> packed RGBA [H, W] int32 on the device

The host layer is the JAX package's own (``compeg_tpu`` parser, metadata,
scan, native packer); nothing here imports jax.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from compeg_tpu import native
from compeg_tpu import scan as S
from compeg_tpu.errors import CompegError
from compeg_tpu.metadata import ImageData, analyze
from compeg_tpu.profiling import stage_timer

from .ops import entropy as E
from .ops import fused as F
from .ops import idct as D

log = logging.getLogger("compeg_tpu_torch")


@dataclass(frozen=True)
class FrameGeometry:
    """Per-frame decode geometry (the JAX package's, without ``tiling``:
    the port packs segments linearly and writes the raster directly)."""

    width: int
    height: int
    width_mcus: int
    height_mcus: int
    samplings: Tuple[Tuple[int, int], ...]
    du_to_comp: Tuple[int, ...]
    ri: int
    # Samples are already RGB (component IDs R,G,B): skip the YCbCr matrix.
    rgb: bool = False

    @property
    def total_mcus(self) -> int:
        return self.width_mcus * self.height_mcus

    @staticmethod
    def from_image(img: ImageData) -> "FrameGeometry":
        return FrameGeometry(
            width=img.width,
            height=img.height,
            width_mcus=img.width_mcus,
            height_mcus=img.height_mcus,
            samplings=tuple((c.h_sample, c.v_sample) for c in img.components),
            du_to_comp=tuple(img.du_to_comp),
            ri=img.restart_interval,
            rgb=img.color_space == "rgb",
        )


@dataclass
class PreparedFrame:
    """Host-side preparation of one frame: the packed segment rows and the
    stream constants (already on the decoder's device)."""

    rows: np.ndarray  # [>= nseg, W] uint32, MSB-first words
    nseg: int
    tables: E.EntropyTables
    lq_t: torch.Tensor  # [DUS, 64, 64] f32 operators (ops/idct.py)
    geom: FrameGeometry
    image: ImageData
    packer: str  # "native" or "python"


# Knobs of compeg_tpu.Decoder that this port does not implement yet, with
# their default and the ROADMAP.md queue-1 item that ports them.
_UNPORTED = {
    "exact_idct": (False, "queue 1 item 4"),
    "zrl_compat": (False, "queue 1 item 4"),
    "fancy_upsampling": (False, "queue 1 item 6"),
    "planes_epilogue": (None, "queue 1 item 6"),
    "fused": (True, "queue 1 item 7"),
}


class Decoder:
    """Per-stream decoder. Reuse one instance across the frames of a stream:
    it keeps the last header and its device-resident constants."""

    def __init__(
        self,
        retained_coefficients: int = 64,
        max_device_bytes: int = 8 << 30,
        pack_threads: Optional[int] = None,
        device="cuda",
        **knobs,
    ):
        for name, value in knobs.items():
            if name not in _UNPORTED:
                raise TypeError(f"Decoder() got an unexpected keyword {name!r}")
            default, item = _UNPORTED[name]
            if value != default:
                raise NotImplementedError(
                    f"Decoder({name}={value!r}) is not ported to "
                    f"compeg_tpu_torch yet (ROADMAP.md {item})"
                )
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Decoder(device={device!r}) needs a CUDA device and none is "
                "available; pass device='cpu' for the plain PyTorch path"
            )
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device!r}")
        if not 1 <= retained_coefficients <= 64:
            raise ValueError("retained_coefficients must be in 1..64")
        self.retained = retained_coefficients
        # Device-buffer budget per frame, the analogue of the reference's
        # MAX_RESTART_INTERVALS dispatch cap: a degenerate geometry fails
        # with a clean CompegError instead of an out-of-memory error.
        self.max_device_bytes = max_device_bytes
        # Worker threads per native pack call (None: the machine-sized pool).
        self.pack_threads = pack_threads
        # Steady-state width: frames of a stream reuse the last row width
        # and re-measure only when a segment overflows it (the reference's
        # grow-only buffers, src/dynamic.rs:38-61).
        self._cached_width: Optional[int] = None
        # (header bytes, ImageData template, stream constants) of the last
        # stream. One entry: a frame with other header bytes replaces it.
        # The constants (tables and operators on the device, geometry) live
        # in the same tuple, so a frame never pairs one stream's header with
        # another's constants.
        self._hdr_cache: Optional[Tuple[bytes, ImageData, Dict]] = None
        self._warned_parallelism = False
        self._last_geom: Optional[FrameGeometry] = None

    # -- host side ---------------------------------------------------------

    def _analyze(self, data):
        """(ImageData, consts dict or None) with the header cache."""
        cached = self._hdr_cache
        if (
            cached is not None
            and len(data) > len(cached[0])
            and bytes(data[: len(cached[0])]) == cached[0]
        ):
            tmpl = cached[1]
            src = bytes(data)
            if native.available():
                # Zero-copy view: the native pack reads the scan in place.
                scan = memoryview(src)[tmpl.scan_offset:]
            else:
                # Inside valid entropy data every FF is followed by 00 or
                # D0-D7, so the first FF D9 after the header ends the scan.
                end = src.find(b"\xff\xd9", tmpl.scan_offset)
                scan = src[tmpl.scan_offset:end] if end >= 0 else None
            if scan is not None:
                return dataclasses.replace(tmpl, source=src, scan_data=scan), cached[2]
        img = analyze(data)
        if img.source is None:
            return img, None
        consts: Dict = {}
        self._hdr_cache = (img.source[: img.scan_offset], img, consts)
        return img, consts

    def _pack(self, img: ImageData) -> Tuple[np.ndarray, str]:
        """Destuff + split + pack the scan into ``[>= nseg, W]`` u32 rows."""
        expected = img.total_restart_intervals
        if not native.available():
            intervals = S.split_intervals(bytes(img.scan_data), expected)
            w = max(1, S._words_per_segment(max(len(s) for s in intervals)))
            blk = S.to_device_layout(intervals, w)
            rows = blk.words.transpose(0, 2, 3, 1).reshape(-1, blk.words_per_segment)
            return np.ascontiguousarray(rows), "python"
        src, off, ln = (
            (img.source, img.scan_offset, len(img.scan_data))
            if img.source is not None
            else (bytes(img.scan_data), 0, len(img.scan_data))
        )
        g = -(-expected // S.SEGMENTS_PER_BLOCK)
        nthr = self.pack_threads or 0
        w = self._cached_width
        if w is not None:
            try:
                rows, _ = native.pack_rows(src, expected, w, g, offset=off,
                                           length=ln, n_threads=nthr)
                return rows, "native"
            except CompegError:
                pass  # a longer segment or another count: re-measure
        n, mx = native.scan_info(src, offset=off, length=ln)
        if n != expected:
            raise CompegError(
                f"scan contains {n} restart intervals, expected {expected}"
            )
        w = max(1, S._words_per_segment(mx))
        self._cached_width = w
        rows, _ = native.pack_rows(src, expected, w, g, offset=off, length=ln,
                                   n_threads=nthr)
        return rows, "native"

    def prepare(self, data) -> PreparedFrame:
        with stage_timer("parse"):
            if isinstance(data, ImageData):
                img, consts = data, None
            else:
                img, consts = self._analyze(data)
        nseg = img.total_restart_intervals
        if nseg < 10000 and not self._warned_parallelism:
            # The reference's guidance (src/lib.rs:838-846): few restart
            # intervals leave the device mostly idle.
            log.info("image has %d restart intervals (parallelism); device "
                     "decode is most efficient above ~10000", nseg)
            self._warned_parallelism = True
        # Device budget: the raster output (MCU-padded bound) plus the scan
        # words, which are at most the scan's bytes plus a word per segment.
        est = (img.total_mcus * img.mcu_width * img.mcu_height * 4
               + len(img.scan_data) + 4 * nseg)
        if est > self.max_device_bytes:
            raise CompegError(
                f"decode would need ~{est >> 20} MiB of device buffers "
                f"(restart interval {img.restart_interval} MCUs over {nseg} "
                f"segments); exceeds the {self.max_device_bytes >> 20} MiB "
                "budget — fall back to a software decoder"
            )
        with stage_timer("preprocess"):
            rows, packer = self._pack(img)
        hit = consts.get(self.retained) if consts is not None else None
        if hit is None:
            hit = (
                E.tables_from_image(img, self.device),
                D.idct_operators(D.qz_by_slot_array(img), self.retained,
                                 self.device),
                FrameGeometry.from_image(img),
            )
            if consts is not None:
                consts[self.retained] = hit
        tables, lq_t, geom = hit
        return PreparedFrame(rows=rows, nseg=nseg, tables=tables, lq_t=lq_t,
                             geom=geom, image=img, packer=packer)

    # -- device side -------------------------------------------------------

    def upload(self, pf: PreparedFrame) -> torch.Tensor:
        """The frame's segment rows as an int32 tensor on the device."""
        rows = torch.from_numpy(pf.rows[: pf.nseg].view(np.int32))
        return rows.to(self.device)

    def decode_prepared(self, pf: PreparedFrame) -> torch.Tensor:
        """Asynchronous decode: packed RGBA ``[H, W]`` int32 on the device."""
        return F.fused_decode_rgba(self.upload(pf), pf.nseg, pf.tables,
                                   pf.lq_t, pf.geom)

    def decode(self, data) -> np.ndarray:
        """Decode one JPEG to an ``[H, W, 3]`` u8 RGB numpy array."""
        out = self.decode_prepared(self.prepare(data))
        return F.rgba_to_rgb(out).cpu().numpy()

    def decode_rgba(self, data) -> np.ndarray:
        """Decode to ``[H, W, 4]`` u8 RGBA (alpha 255), the reference's
        output format."""
        out = self.decode_prepared(self.prepare(data)).cpu().numpy()
        return out.view(np.uint8).reshape(out.shape + (4,))

    def start_decode(self, data) -> "DecodeOp":
        """Prepare on the host, launch on the device and return at once (the
        reference's ``start_decode``, src/lib.rs:483-499)."""
        pf = self.prepare(data)
        changed = pf.geom != self._last_geom
        self._last_geom = pf.geom
        return DecodeOp(result=self.decode_prepared(pf), geometry=pf.geom,
                        geometry_changed=changed)

    def decode_scaled(self, data, scale_blocks: int):
        raise NotImplementedError(
            "decode_scaled is not ported to compeg_tpu_torch yet "
            "(ROADMAP.md queue 1 item 5)"
        )

    def decode_ycbcr(self, data):
        raise NotImplementedError(
            "decode_ycbcr is not ported to compeg_tpu_torch yet "
            "(ROADMAP.md queue 1 item 6)"
        )


@dataclass
class DecodeOp:
    """Handle for an in-flight decode (the reference's ``DecodeOp``,
    src/lib.rs:538-574). ``geometry_changed`` tells the caller to rebuild
    what depends on the frame size."""

    result: torch.Tensor  # packed RGBA [H, W] int32 on the device
    geometry: FrameGeometry
    geometry_changed: bool

    def rgb(self) -> np.ndarray:
        """Blocking readback to ``[H, W, 3]`` u8."""
        return F.rgba_to_rgb(self.result).cpu().numpy()

    def block_until_ready(self) -> "DecodeOp":
        if self.result.is_cuda:
            torch.cuda.current_stream(self.result.device).synchronize()
        return self

    # The decoded words go to any DLPack consumer without a host round trip
    # (the reference hands its output texture to the render pipeline).
    def __dlpack__(self, **kwargs):
        return self.result.__dlpack__(**kwargs)

    def __dlpack_device__(self):
        return self.result.__dlpack_device__()


def decode_rgb(data: bytes, retained_coefficients: int = 64,
               device="cuda") -> np.ndarray:
    """One-shot decode to ``[H, W, 3]`` u8."""
    return Decoder(retained_coefficients, device=device).decode(data)


def decode_rgba(data: bytes, retained_coefficients: int = 64,
                device="cuda") -> np.ndarray:
    """One-shot decode to ``[H, W, 4]`` u8 RGBA."""
    return Decoder(retained_coefficients, device=device).decode_rgba(data)
