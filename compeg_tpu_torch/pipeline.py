"""Single-image decode orchestration on PyTorch: the port of
:mod:`compeg_tpu.pipeline`.

A frame decode is host preparation plus ONE fused kernel launch (the fused
tier, the default):

    prepare (host: header cache, native scan_info + destuff/split/pack into
    linear segment rows, device-budget check, stream constants)
      -> decode_fused: the lane index L where a restart segment is long, then
         one fused kernel (entropy -> IDCT -> output), chosen by the knobs:
         K2  fused_decode_rgba        default: float IDCT, nearest chroma
         K2x fused_decode_rgba_exact  exact_idct: the integer IDCT
         K3  fused_decode_planes      fancy_upsampling or planes_epilogue
             (then the planes epilogue E of ops/color.py), and decode_ycbcr
         K2s fused_decode_scaled      decode_scaled(k), k in {1, 2, 4}
      -> packed RGBA [H, W] int32 on the device (u8 planes for decode_ycbcr)

or, with ``Decoder(fused=False)``, the staged tier
(:func:`decode_frame_device`): the entropy kernel alone and every later
stage as torch ops, each result a tensor one can look at:

      -> K1 entropy_decode            [nseg, ri, DUS, 64] int32 coefficients
      -> ops/idct.idct_pixels, or ops/int_idct.idct_pixels_int (exact_idct)
      -> ops/color.component_planes, then finalize_planes (nearest or fancy;
         the planes epilogue E on the card)
      -> [H, W, 3] u8 on the device

``zrl_compat`` changes only the entropy phase, in every kernel. The host
layer (parser, metadata, scan, the native packer) is the port's own copy of
the JAX package's; nothing here imports jax or ``compeg_tpu``. Batches and
streams of frames are :mod:`compeg_tpu_torch.batch`.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import native
from . import scan as S
from .errors import CompegError
from .metadata import ImageData, analyze
from .ops import color as C
from .ops import entropy as E
from .ops import fused as F
from .ops import idct as D
from .ops import int_idct as I
from .ops import lanes as L
from .profiling import (LANES_LAUNCHED, MCUS_LAUNCHED, PACK_PAD_BYTES,
                        PINNED_READBACKS, count, stage_timer)

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

    rows: Optional[np.ndarray]  # [>= nseg, W] uint32, MSB-first words
    nseg: int
    tables: E.EntropyTables
    # The IDCT operand of the decoder's mode: the [DUS, 64, 64] f32
    # operators (ops/idct.py), or the [DUS, 64] int32 quantizers
    # (ops/int_idct.py) when exact_idct.
    op: torch.Tensor
    geom: FrameGeometry
    image: ImageData
    packer: str  # "native" or "python"
    # The stream constants of the frame's header (None without a header
    # cache entry), where decode_scaled keeps its operators.
    consts: Optional[Dict] = dataclasses.field(default=None, repr=False)


def decode_frame_device(rows: torch.Tensor, nseg: int,
                        tables: E.EntropyTables, qz_by_slot,
                        geom: FrameGeometry, retained: int = 64,
                        fancy: bool = False, exact_idct: bool = False,
                        op: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The staged frame decode: segment rows ``[>= nseg, W]`` int32 ->
    ``[H, W, 3]`` u8 on the rows' device (``decode_frame_device``,
    compeg_tpu/pipeline.py:80-106).

    Kernel K1 (:func:`~compeg_tpu_torch.ops.entropy.entropy_decode`) decodes
    the coefficients; the IDCT (float, or the integer butterfly with
    ``exact_idct``) and the component planes are torch ops, as they are XLA
    ops outside any kernel in the JAX package, and the chroma upsampling
    (nearest, or the triangle filter with ``fancy``) and the colour
    conversion the planes epilogue E (:func:`~compeg_tpu_torch.ops.color.
    finalize_planes`), XLA's output fusion there.
    ``qz_by_slot`` are the ``[DUS, 64]`` zigzag quantizers of
    :func:`~compeg_tpu_torch.ops.idct.qz_by_slot_array`; ``op`` is the IDCT
    operand made from them for ``retained`` (``idct_operators``, or
    ``int_quantizers`` with ``exact_idct``) where the caller keeps it on the
    device (``qz_by_slot`` may then be None), else it is made here."""
    if op is None:
        make = I.int_quantizers if exact_idct else D.idct_operators
        op = make(np.asarray(qz_by_slot), retained, rows.device)
    coeffs = E.entropy_decode(rows, nseg, tables, geom.ri, geom.total_mcus,
                              geom.du_to_comp)
    pixels = I.idct_pixels_int(coeffs, op) if exact_idct else D.idct_pixels(
        coeffs, op)
    planes = C.component_planes(pixels, geom)
    rgba = C.finalize_planes(planes, geom.samplings, geom.width, geom.height,
                             fancy=fancy, rgb=geom.rgb)
    return F.rgba_to_rgb(rgba)


def count_launch(geom: FrameGeometry, nseg: int, frames: int,
                 lanes: Optional[L.LaneTable] = None) -> None:
    """Count a launch's lanes (one a segment, or those of ``lanes``) and
    MCUs, ``frames`` frames of them."""
    count(LANES_LAUNCHED, (nseg if lanes is None
                           else lanes.count(geom.total_mcus)) * frames)
    count(MCUS_LAUNCHED, geom.total_mcus * frames)


def decode_fused(rows: torch.Tensor, nseg: int, tables: E.EntropyTables,
                 op: torch.Tensor, geom: FrameGeometry, *, exact: bool,
                 planes: bool, gate: Optional[F.BandGate] = None):
    """A frame's ``[>= nseg, W]`` int32 rows, or a ``[B, R, W]`` batch, to
    K3's u8 planes with ``planes``, else to packed RGBA by K2, or K2x with
    ``exact``; ``gate`` makes the frames bands. A segment of more than
    ``ops.lanes.split_mcus(frames)`` MCUs runs as lanes, whose table kernel
    L makes; a banded launch takes none (there is no gated LANES launch).
    Every fused launch but K2s's (``decode_scaled``: no lane form) is here."""
    frames = rows.shape[0] if rows.dim() == 3 else 1
    mcus = None if gate is not None else L.lane_length(
        min(geom.ri, geom.total_mcus), nseg, frames)
    lanes = None if mcus is None else L.lane_index(rows, nseg, tables, geom,
                                                    mcus)
    count_launch(geom, nseg, frames, lanes)
    if planes:
        return F.fused_decode_planes(rows, nseg, tables, op, geom, exact,
                                     gate=gate, lanes=lanes)
    decode = F.fused_decode_rgba_exact if exact else F.fused_decode_rgba
    return decode(rows, nseg, tables, op, geom, gate, lanes)


def to_rgb_tensor(out: torch.Tensor) -> torch.Tensor:
    """A decode result as ``[..., H, W, 3]`` u8: the fused tier's packed
    RGBA ``[..., H, W]`` int32 unpacked, the staged tier's u8 as it is."""
    return out if out.dtype == torch.uint8 else F.rgba_to_rgb(out)


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host array of its own, once the work that makes it is
    done. A CUDA tensor is copied into a new block of torch's pinned-memory
    cache, which the card writes by DMA at the link's rate, with no staging
    copy on the host and no page faults; the block goes back to the cache
    when the array is dropped, and the next readback of its size takes it
    again (counted as :data:`~compeg_tpu_torch.profiling.PINNED_READBACKS`).
    A view on the card is copied as a contiguous array. A CPU tensor is
    returned as its numpy view."""
    if not t.is_cuda:
        return t.numpy()
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    count(PINNED_READBACKS)
    return buf.numpy()


class Decoder:
    """Per-stream decoder. Reuse one instance across the frames of a stream:
    it keeps the last header and its device-resident constants."""

    def __init__(
        self,
        retained_coefficients: int = 64,
        max_device_bytes: int = 8 << 30,
        pack_threads: Optional[int] = None,
        device="cuda",
        exact_idct: bool = False,
        zrl_compat: bool = False,
        fancy_upsampling: bool = False,
        planes_epilogue: Optional[bool] = None,
        fused: bool = True,
    ):
        # fused=False: the staged tier (decode_frame_device) for decode,
        # decode_rgba, start_decode and decode_prepared; decode_ycbcr and
        # decode_scaled have no staged form in the port and stay on K3 and
        # K2s. The JAX package also sends fancy frames it cannot tile to its
        # staged tier; the port has no tiling, so only fused=False does.
        self.fused = fused
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
        # exact_idct: the integer IDCT, byte-identical to
        # golden.decode_rgb(idct="int") (kernels K2x, K3).
        self.exact_idct = exact_idct
        # zrl_compat: the reference's ZRL-advance-17 entropy semantics; with
        # exact_idct (and retained_coefficients=32, the reference's default)
        # the documented "Compeg-compat" configuration (PARITY.md).
        self.zrl_compat = zrl_compat
        # fancy_upsampling: libjpeg's triangle-filter chroma (K3 + the
        # planes epilogue E, ops/color.finalize_planes). planes_epilogue: True routes nearest
        # upsampling through K3 + the epilogue too, bit-identical to K2's
        # in-kernel composite; None (auto) and False keep the composite for
        # nearest. Fancy always takes K3, as the JAX package's tiled fused
        # path does whatever planes_epilogue says.
        self.fancy = fancy_upsampling
        self.planes_epilogue = planes_epilogue
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

    @staticmethod
    def _scan_span(img: ImageData) -> Tuple[bytes, int, int]:
        """(buffer, offset, length) of the entropy-coded span, in place in
        the source file where the frame has one."""
        if img.source is not None:
            return img.source, img.scan_offset, len(img.scan_data)
        return bytes(img.scan_data), 0, len(img.scan_data)

    def measure_width(self, img: ImageData) -> int:
        """Words per row that hold the frame's longest destuffed segment;
        raises when the scan's interval count is not the header's."""
        expected = img.total_restart_intervals
        if native.available():
            src, off, ln = self._scan_span(img)
            n, mx = native.scan_info(src, offset=off, length=ln)
            if n != expected:
                raise CompegError(
                    f"scan contains {n} restart intervals, expected {expected}"
                )
        else:
            mx = max(len(s) for s in
                     S.split_intervals(bytes(img.scan_data), expected))
        return max(1, S._words_per_segment(mx))

    def pack_into(self, img: ImageData, out: np.ndarray) -> str:
        """Destuff + split + pack the scan into ``out``, ``[row_capacity(
        n), W]`` uint32 for some ``n >= nseg``, at ``out``'s width, the
        rows past the last segment zero; raises CompegError when a
        segment does not fit or the interval count is off. Returns the
        packer's name."""
        expected = img.total_restart_intervals
        if native.available():
            src, off, ln = self._scan_span(img)
            native.pack_rows(src, expected, out.shape[1],
                             out.shape[0] // S.SEGMENTS_PER_BLOCK,
                             offset=off, length=ln,
                             n_threads=self.pack_threads or 0, out=out)
            return "native"
        intervals = S.split_intervals(bytes(img.scan_data), expected)
        blk = S.to_device_layout(intervals, out.shape[1])
        rows = blk.words.transpose(0, 2, 3, 1).reshape(-1, out.shape[1])
        out[:len(rows)] = rows
        out[len(rows):] = 0
        return "python"

    def _pack(self, img: ImageData,
              alloc: Optional[Callable[[int, int], np.ndarray]] = None
              ) -> Tuple[np.ndarray, str]:
        """Destuff + split + pack the scan into ``[>= nseg, W]`` u32 rows,
        written into ``alloc(rows, W)`` (a new array by default)."""
        alloc = alloc or _new_rows
        cap = row_capacity(img.total_restart_intervals)
        w = self._cached_width
        if w is not None:
            rows = alloc(cap, w)
            try:
                return rows, self.pack_into(img, rows)
            except CompegError:
                pass  # a longer segment or another count: re-measure
        w = self._cached_width = self.measure_width(img)
        rows = alloc(cap, w)
        return rows, self.pack_into(img, rows)

    def prepare(self, data,
                alloc: Optional[Callable[[int, int], np.ndarray]] = None
                ) -> PreparedFrame:
        """Host preparation of one frame. ``alloc(rows, W)`` supplies the
        uint32 array the rows are packed into (a pinned staging buffer, for
        an asynchronous upload); a new array by default."""
        with stage_timer("prepare"):
            with stage_timer("parse"):
                if isinstance(data, ImageData):
                    img, consts = data, None
                else:
                    img, consts = self._analyze(data)
            nseg = img.total_restart_intervals
            if nseg < 10000 and not self._warned_parallelism:
                # The reference's guidance (src/lib.rs:838-846): few restart
                # intervals leave the device mostly idle.
                log.info("image has %d restart intervals (parallelism); "
                         "device decode is most efficient above ~10000",
                         nseg)
                self._warned_parallelism = True
            self.check_budget(img, 1)
            with stage_timer("preprocess"):
                rows, packer = self._pack(img, alloc)
            count(PACK_PAD_BYTES, (rows.shape[0] - nseg) * rows.shape[1]
                  * rows.itemsize)
            pf = self.frame_constants(img, consts)
            pf.rows, pf.packer = rows, packer
            return pf

    def frame_constants(self, img: ImageData,
                        consts: Optional[Dict]) -> PreparedFrame:
        """A frame's :class:`PreparedFrame` without its rows: geometry and
        the stream constants of its header, made on the first frame of a
        stream and found in ``consts`` afterwards."""
        tables, geom = _stream_const(consts, "frame", lambda: (
            E.tables_from_image(img, self.device, zrl17=self.zrl_compat),
            FrameGeometry.from_image(img)))
        return PreparedFrame(rows=None, nseg=img.total_restart_intervals,
                             tables=tables, op=self._operator(img, consts, 8),
                             geom=geom, image=img, packer="", consts=consts)

    def check_budget(self, img: ImageData, frames: int) -> None:
        """Device budget of ``frames`` frames decoded at once: the raster
        output (MCU-padded bound), the u8 component planes of the planes
        kernel (one byte per sample), and the scan words, which are at most
        the scan's bytes plus a word per segment. The staged tier also holds
        K1's coefficients, ``[nseg, ri, DUS, 64]`` int32 (66 MB at 4K), one
        frame's at a time."""
        nseg = img.total_restart_intervals
        est = frames * (img.total_mcus * (img.mcu_width * img.mcu_height * 4
                                          + img.dus_per_mcu * 64)
                        + len(img.scan_data) + 4 * nseg)
        if not self.fused:
            est += nseg * img.restart_interval * img.dus_per_mcu * 64 * 4
        if est > self.max_device_bytes:
            raise CompegError(
                f"decode would need ~{est >> 20} MiB of device buffers "
                f"({frames} frame(s), restart interval "
                f"{img.restart_interval} MCUs over {nseg} segments); exceeds "
                f"the {self.max_device_bytes >> 20} MiB budget — fall back "
                "to a software decoder"
            )

    def _operator(self, img: ImageData, consts: Optional[Dict], scale: int):
        """The IDCT operand at ``scale`` (8: the decoder's own mode; k: the
        scaled decode's float operators), keyed like the JAX package's
        ``_stream_consts`` by retained count, exact flag and scale."""
        exact = self.exact_idct and scale == 8

        def make():
            qz = D.qz_by_slot_array(img)
            if exact:
                return I.int_quantizers(qz, self.retained, self.device)
            if scale != 8:
                return D.scaled_operators(qz, scale, self.retained,
                                          self.device)
            return D.idct_operators(qz, self.retained, self.device)

        return _stream_const(consts, ("op", self.retained, exact, scale), make)

    # -- device side -------------------------------------------------------

    def upload(self, pf: PreparedFrame) -> torch.Tensor:
        """The frame's segment rows as an int32 tensor on the device."""
        with stage_timer("upload"):
            rows = torch.from_numpy(pf.rows[: pf.nseg].view(np.int32))
            return rows.to(self.device)

    def decode_rows(self, pf: PreparedFrame,
                    rows: torch.Tensor) -> torch.Tensor:
        """Decode segment rows that are on the device already, on the
        current stream: one frame's ``[>= nseg, W]`` int32 to packed RGBA
        ``[H, W]`` int32, or a ``[B, R, W]`` batch of frames that share
        ``pf``'s geometry and tables to ``[B, H, W]`` in one launch
        (:func:`decode_fused`, which cuts long restart segments into
        lanes). The staged tier gives ``[H, W, 3]`` (``[B, H, W, 3]``) u8
        instead, like the JAX package's, frame by frame with one K1 launch
        each."""
        with stage_timer("launch"):  # the host's enqueueing of the work
            g = pf.geom
            if not self.fused:
                count_launch(g, pf.nseg, len(rows) if rows.dim() == 3 else 1)

                def staged(r):
                    return decode_frame_device(
                        r, pf.nseg, pf.tables, None, g, self.retained,
                        self.fancy, self.exact_idct, op=pf.op)

                if rows.dim() == 2:
                    return staged(rows)
                return torch.stack([staged(r) for r in rows])
            planes = self.fancy or self.planes_epilogue is True
            out = decode_fused(rows, pf.nseg, pf.tables, pf.op, g,
                               exact=self.exact_idct, planes=planes)
            if not planes:
                return out
            # K3, then the planes epilogue E: a batch's planes are one
            # [B, Hc, Wc] tensor each and take one launch, whose vertical
            # filter stays inside each frame.
            return C.finalize_planes(out, g.samplings, g.width, g.height,
                                     fancy=self.fancy, rgb=g.rgb)

    def decode_prepared(self, pf: PreparedFrame) -> torch.Tensor:
        """Asynchronous decode: packed RGBA ``[H, W]`` int32 on the device
        (the staged tier: ``[H, W, 3]`` u8)."""
        return self.decode_rows(pf, self.upload(pf))

    def decode(self, data) -> np.ndarray:
        """Decode one JPEG to an ``[H, W, 3]`` u8 RGB numpy array, a new
        one every call, which the caller may keep. On a CUDA device the
        array lies in page-locked host memory from torch's pinned-memory
        cache (:func:`to_host`) and goes back to that cache when it is
        dropped: a caller who holds N frames holds N frames of pinned
        memory."""
        with stage_timer("decode"):
            out = self.decode_prepared(self.prepare(data))
            with stage_timer("readback"):  # waits for the device work too
                return to_host(to_rgb_tensor(out))

    def decode_rgba(self, data) -> np.ndarray:
        """Decode to ``[H, W, 4]`` u8 RGBA (alpha 255), the reference's
        output format; on a CUDA device in pinned memory, as :meth:`decode`
        gives it."""
        with stage_timer("decode"):
            out = self.decode_prepared(self.prepare(data))
            with stage_timer("readback"):
                out = to_host(out)
        if out.dtype == np.uint8:  # the staged tier's [H, W, 3]
            alpha = np.full(out.shape[:2] + (1,), 255, np.uint8)
            return np.concatenate([out, alpha], axis=-1)
        return out.view(np.uint8).reshape(out.shape + (4,))

    def start_decode(self, data) -> "DecodeOp":
        """Prepare on the host, launch on the device and return at once (the
        reference's ``start_decode``, src/lib.rs:483-499)."""
        pf = self.prepare(data)
        changed = pf.geom != self._last_geom
        self._last_geom = pf.geom
        return DecodeOp(result=self.decode_prepared(pf), geometry=pf.geom,
                        geometry_changed=changed)

    def decode_ycbcr(self, data) -> list:
        """Decode to raw per-component planes, no chroma upsampling and no
        colour conversion: a list of ``[Hc, Wc]`` u8 arrays in frame
        component order (Y, Cb, Cr; one for gray), ``Hc = ceil(H*v/max_v)``,
        ``Wc = ceil(W*h/max_h)`` (T.81 A.1.1). Kernel K3, with the integer
        IDCT under ``exact_idct``, on lanes (:func:`decode_fused`)."""
        pf = self.prepare(data)
        g = pf.geom
        max_h = max(h for h, _ in g.samplings)
        max_v = max(v for _, v in g.samplings)
        return [
            to_host(p[: -(-g.height * v // max_v), : -(-g.width * h // max_h)])
            for p, (h, v) in zip(decode_fused(
                self.upload(pf), pf.nseg, pf.tables, pf.op, g,
                exact=self.exact_idct, planes=True), g.samplings)
        ]

    def decode_scaled(self, data, scale_blocks: int) -> np.ndarray:
        """Thumbnail decode at ``scale_blocks/8`` scale (k in {1, 2, 4, 8}):
        ``[ceil(H*k/8), ceil(W*k/8), 3]`` u8 RGB through the k-point scaled
        IDCT (kernel K2s), the libjpeg ``scale_denom`` feature. k = 8 is
        :meth:`decode`. Always the float IDCT and nearest chroma, as in the
        JAX package: ``exact_idct`` and ``fancy_upsampling`` do not apply."""
        if scale_blocks == 8:
            return self.decode(data)
        if scale_blocks not in (1, 2, 4):
            raise CompegError(
                f"scale_blocks must be 1, 2, 4, or 8 (got {scale_blocks})"
            )
        pf = self.prepare(data)
        lq_k = self._operator(pf.image, pf.consts, scale_blocks)
        out = F.fused_decode_scaled(self.upload(pf), pf.nseg, pf.tables, lq_k,
                                    pf.geom, scale_blocks)
        return to_host(F.rgba_to_rgb(out))


@dataclass
class DecodeOp:
    """Handle for an in-flight decode (the reference's ``DecodeOp``,
    src/lib.rs:538-574). ``geometry_changed`` tells the caller to rebuild
    what depends on the frame size."""

    # on the device: packed RGBA [H, W] int32, or the staged tier's
    # [H, W, 3] u8
    result: torch.Tensor
    geometry: FrameGeometry
    geometry_changed: bool

    def rgb(self) -> np.ndarray:
        """Blocking readback to ``[H, W, 3]`` u8; on a CUDA device a new
        array every call, in page-locked memory from torch's pinned-memory
        cache, which takes it back when it is dropped (:func:`to_host`)."""
        return to_host(to_rgb_tensor(self.result))

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


def row_capacity(nseg: int) -> int:
    """Rows of a frame's packed buffer: the packer writes whole blocks of
    ``SEGMENTS_PER_BLOCK`` rows, zero past ``nseg``."""
    return -(-nseg // S.SEGMENTS_PER_BLOCK) * S.SEGMENTS_PER_BLOCK


def _new_rows(rows: int, width: int) -> np.ndarray:
    return np.empty((rows, width), dtype=np.uint32)


def _stream_const(consts: Optional[Dict], key, make):
    """``consts[key]``, made and stored on a miss (made every time when the
    frame has no header cache entry)."""
    hit = consts.get(key) if consts is not None else None
    if hit is None:
        hit = make()
        if consts is not None:
            consts[key] = hit
    return hit


def decode_rgb(data: bytes, retained_coefficients: int = 64,
               device="cuda") -> np.ndarray:
    """One-shot decode to ``[H, W, 3]`` u8."""
    return Decoder(retained_coefficients, device=device).decode(data)


def decode_rgba(data: bytes, retained_coefficients: int = 64,
                device="cuda") -> np.ndarray:
    """One-shot decode to ``[H, W, 4]`` u8 RGBA."""
    return Decoder(retained_coefficients, device=device).decode_rgba(data)
