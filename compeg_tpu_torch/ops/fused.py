"""Fused decode: entropy -> IDCT -> output in one kernel, in its four modes,
each with its plain PyTorch twin.

Counterpart of :mod:`compeg_tpu.ops.fused`:

* :func:`fused_decode_rgba` (K2): float IDCT, nearest chroma upsampling,
  BT.601, packed RGBA raster (gray and RGB-ID frames included);
* :func:`fused_decode_rgba_exact` (K2x): the same with the exact integer
  IDCT (``exact_idct``), byte-identical to ``golden.decode_rgb(idct="int")``;
* :func:`fused_decode_planes` (K3): float or integer IDCT, one u8 plane per
  component for the epilogue of ``ops/color.py`` (fancy upsampling,
  ``planes_epilogue``, ``decode_ycbcr``);
* :func:`fused_decode_scaled` (K2s): the k-point scaled IDCT and the
  composite of k x k blocks, the ``k/8`` thumbnail decode.

The Pallas kernels write segment-major blocks or tiled slabs that an XLA
transpose assembles; a GPU thread can scatter, so these kernels write the
raster (or the planes) themselves. Pixels are packed
``r | g << 8 | b << 16 | 0xFF << 24`` into int32, the same bits as the JAX
package's u32 RGBA. CUDA tensors launch the kernel; CPU tensors take the
plain twin.

A batch: K2, K2x and K3 also take the rows of B same-geometry frames as one
``[B, R, W]`` tensor (``R >= nseg`` rows per frame) and decode them in ONE
launch, the frame being the grid's second dimension; the output gains a
leading ``B``. ``nseg`` and ``geom`` stay one frame's. (The JAX package
concatenates the frames' blocks along its grid, compeg_tpu/batch.py:71-114.)
A banded batch (``parallel/sharding.py``) adds a :class:`BandGate`: each
frame is a band of a taller image and decodes only its MCUs inside the
image. K2, K2x and K3 also take a lane table (``lanes``,
:class:`~compeg_tpu_torch.ops.lanes.LaneTable`): the frames' long restart
segments are then decoded as lanes of ``lanes.mcus`` MCUs each, every lane
from its entry of the table (the LANES launch; the plain twins decode lane
by lane likewise).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import _build
from .color import component_planes, pack_rgba, ycbcr_to_rgba
from .entropy import EntropyTables, _check, entropy_decode_reference
from .idct import SCALED_ZLEN, idct_pixels
from .int_idct import idct_pixels_int
from .lanes import LaneTable


def _check_op(op: torch.Tensor, shape, dtype, device, name: str) -> None:
    if (op.dtype != dtype or tuple(op.shape) != tuple(shape)
            or not op.is_contiguous() or op.device != device):
        raise ValueError(
            f"{name} must be contiguous {list(shape)} {dtype} on {device}, "
            f"got {op.dtype} {tuple(op.shape)} on {op.device}"
        )
    if op.is_cuda and op.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the "
                         "kernels load it in vectors)")


class BandGate(NamedTuple):
    """The per-frame MCU gate of a banded launch, the counterpart of the
    JAX package's ``seg_mcus`` (compeg_tpu/parallel/sharding.py
    prepare_banded): frame ``f`` of the launch is band ``first + f % bands``
    of an image of ``image_mcus`` MCUs cut into bands of ``geom.total_mcus``
    MCUs, and holds :meth:`mcus` of them, 0 for a band past the image.

    A gated MCU (past the image's last) is not decoded: the kernels read
    none of its bits and write none of its pixels, which keep what the
    output buffer held; the plain twins give it zero coefficients. Its
    pixels lie in MCU rows at or past the image's MCU-padded height, which
    the banded decode crops and the fancy filter's content-edge clamp never
    reads, so no kept pixel depends on one."""

    image_mcus: int
    bands: int
    first: int = 0

    def mcus(self, band_mcus: int, frame: int) -> int:
        """MCUs frame ``frame`` holds of its band's ``band_mcus``
        (csrc/entropy.cuh ``frame_mcus``)."""
        band = self.first + frame % self.bands
        return max(0, min(self.image_mcus - band * band_mcus, band_mcus))


def _frames(rows: torch.Tensor) -> Optional[int]:
    """B of a ``[B, R, W]`` batch, None for one frame's ``[R, W]`` rows."""
    return rows.shape[0] if rows.dim() == 3 else None


def _check_args(rows, nseg, tables, op, geom, npx: Optional[int]) -> bool:
    """Checks the inputs; True when they lie on the CPU (the plain twin's
    case). ``npx`` is the float operator's pixel count, None for the integer
    quantizers."""
    if rows.dim() == 3 and rows.shape[0] < 1:
        raise ValueError("a batch holds at least one frame")
    _check(rows[0] if rows.dim() == 3 else rows, nseg, tables)
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")
    dus = len(geom.du_to_comp)
    if npx is None:
        _check_op(op, (dus, 64), torch.int32, rows.device, "qz")
    else:
        _check_op(op, (dus, 64, npx), torch.float32, rows.device, "lq_t")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rows.device}")
    return rows.device.type == "cpu"


@functools.lru_cache(maxsize=None)
def composite_offsets(samplings: Tuple[Tuple[int, int], ...], blk: int = 8):
    """The RGBA kernels' sample offsets, ``(mcu_w, mcu_h, row_off,
    col_off)``: pixel ``(r, x)`` of an MCU of ``mcu_h`` x ``mcu_w`` output
    pixels reads the luma element ``(row_off[r] & 0xFFFF) + (col_off[x] &
    0xFFFF)`` of its segment's tile and the second component's element
    ``(row_off[r] >> 16) + (col_off[x] >> 16)`` (the third lies its slot
    distance further). A tile holds 64 elements per data unit, of which the
    first ``blk * blk`` are its pixels in raster order. The offsets split
    into a row and a column term because ``rgba_at``
    (compeg_tpu/ops/fused.py:290-326) does; the plain twin's
    :func:`_composite_index` computes the same samples pixel by pixel."""
    gray = len(samplings) == 1
    max_h = 1 if gray else max(h for h, _ in samplings)
    max_v = 1 if gray else max(v for _, v in samplings)
    mh, mw = blk * max_v, blk * max_h
    yh, yv = samplings[0]
    ch, cv = samplings[0] if gray else samplings[1]
    slot1 = 0 if gray else yh * yv
    row_off, col_off = [], []
    for r in range(mh):
        luma = (r * yv // mh) * yh * 64 + (r * yv * blk // mh % blk) * blk
        chroma = slot1 * 64 + (r * cv * blk // mh) * blk
        row_off.append(luma | chroma << 16)
    for x in range(mw):
        luma = (x * yh // mw) * 64 + x * yh * blk // mw % blk
        col_off.append(luma | (x * ch * blk // mw) << 16)
    return mw, mh, tuple(row_off), tuple(col_off)


@functools.lru_cache(maxsize=None)
def plane_offsets(samplings: Tuple[Tuple[int, int], ...]):
    """The planes kernels' store units, ``(du, pair, row, col)`` each, in
    data-unit order: data unit ``du`` lies at sample ``(row, col)`` of the
    MCU's footprint in its component's plane (``8 * v`` by ``8 * h``
    samples: the k-th unit of a component at ``(k // h * 8, k % h * 8)``),
    and with ``pair`` the next data unit lies to its right, so that a row of
    the unit is 16 neighbouring samples of the plane. Units pair up where a
    component has an even number of data units side by side (h = 2 or 4:
    the luma of 4:2:2, 4:2:0 and 4:1:1). :func:`component_planes
    <compeg_tpu_torch.ops.color.component_planes>` places the same samples
    by reshapes."""
    units, slot = [], 0
    for h, v in samplings:
        for k in range(0, h * v, 2 if h % 2 == 0 else 1):
            units.append((slot + k, int(h % 2 == 0), k // h * 8, k % h * 8))
        slot += h * v
    return tuple(units)


def plane_store_route(ptr: int, h: int) -> str:
    """How the planes kernels store a row into a component's plane that
    starts at byte address ``ptr``, ``h`` data units side by side per MCU:
    ``"16-byte"`` (a pair's row at once), ``"8-byte"`` or ``"byte"``.
    Pitches and offsets are multiples of 8 (16 where units pair), so the
    plane's base alone decides; planes the wrapper allocates take the widest
    store their component allows."""
    if h % 2 == 0 and ptr % 16 == 0:
        return "16-byte"
    return "8-byte" if ptr % 8 == 0 else "byte"


def _params(rows, nseg, tables, geom, blk=8, gate=None, lanes=None):
    ri, seg_ri = geom.ri, 0
    if lanes is not None:  # lanes of lanes.mcus MCUs in the segments' place
        nseg, ri = lanes.count(geom.total_mcus), lanes.mcus
        seg_ri = min(geom.ri, geom.total_mcus)
    return _build.make_params(
        nseg, rows.shape[-1], ri, geom.total_mcus, geom.du_to_comp,
        samplings=geom.samplings, width=geom.width, height=geom.height,
        width_mcus=geom.width_mcus, rgb=geom.rgb, zrl17=tables.zrl17,
        blk=blk, zlen=SCALED_ZLEN.get(blk, 64), frames=_frames(rows) or 1,
        frame_rows=rows.shape[-2],
        composite=composite_offsets(tuple(map(tuple, geom.samplings)), blk),
        planes=plane_offsets(tuple(map(tuple, geom.samplings))),
        table_of=tables.table_of, gate=gate, seg_ri=seg_ri,
    )


def _batched(shape, rows):
    """``shape`` with the batch's leading B, when ``rows`` is a batch."""
    b = _frames(rows)
    return tuple(shape) if b is None else (b, *shape)


def _per_frame(fn, rows, geom, gate=None, lanes=None):
    """``fn(frame rows, its MCU count, its lane table)`` for one frame, or
    stacked over a batch's frames; a frame's count is ``geom.total_mcus`` or
    its band's under ``gate``, its lane table its part of ``lanes`` or
    None."""
    def mcus(f):
        return geom.total_mcus if gate is None else gate.mcus(
            geom.total_mcus, f)

    def lane(f):
        return lanes if lanes is None or _frames(rows) is None else (
            lanes._replace(table=lanes.table[f]))

    if _frames(rows) is None:
        return fn(rows, mcus(0), lane(0))
    outs = [fn(r, mcus(f), lane(f)) for f, r in enumerate(rows)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(p) for p in zip(*outs))
    return torch.stack(outs)


def _lane_args(entry, op, lanes):
    """The entry point and its tensors up to the outputs: the LANES one,
    with the lane table after ``op``, when there is a table."""
    if lanes is None:
        return entry, (op,)
    return entry + "_lanes", (op, lanes.table)


def _launch_rgba(entry, key, rows, nseg, tables, op, geom, blk=8, gate=None,
                 lanes=None):
    out = torch.empty(_batched((geom.height, geom.width), rows),
                      dtype=torch.int32, device=rows.device)
    entry, args = _lane_args(entry, op, lanes)
    _build.launch(entry, rows, tables.packed, *args, out,
                  params=_params(rows, nseg, tables, geom, blk, gate, lanes))
    _build.LAUNCHES[key] += 1
    return out


def _check_lanes(gate, lanes) -> None:
    if gate is not None and lanes is not None:
        raise ValueError("a banded launch takes no lane table")


def fused_decode_rgba(rows: torch.Tensor, nseg: int, tables: EntropyTables,
                      lq_t: torch.Tensor, geom,
                      gate: Optional[BandGate] = None,
                      lanes: Optional[LaneTable] = None) -> torch.Tensor:
    """Decode a frame to packed RGBA ``[H, W]`` int32 (kernel K2), or a
    ``[B, R, W]`` batch to ``[B, H, W]`` in one launch.

    ``rows`` are the packed segment words ``[>= nseg, W]`` int32, ``lq_t``
    the operators of :func:`~compeg_tpu_torch.ops.idct.idct_operators`, and
    ``geom`` a :class:`~compeg_tpu_torch.pipeline.FrameGeometry`; ``gate``
    makes the frames bands (:class:`BandGate`), ``lanes`` decodes the
    segments as the lanes of that table (the LANES launch)."""
    _check_lanes(gate, lanes)
    if _check_args(rows, nseg, tables, lq_t, geom, 64):
        return _per_frame(lambda r, m, ln: fused_decode_rgba_reference(
            r, nseg, tables, lq_t, geom, m, ln), rows, geom, gate, lanes)
    return _launch_rgba("compeg_fused_decode", "fused", rows, nseg, tables,
                        lq_t, geom, gate=gate, lanes=lanes)


def fused_decode_rgba_exact(rows: torch.Tensor, nseg: int,
                            tables: EntropyTables, qz: torch.Tensor,
                            geom, gate: Optional[BandGate] = None,
                            lanes: Optional[LaneTable] = None
                            ) -> torch.Tensor:
    """:func:`fused_decode_rgba` with the exact integer IDCT (kernel K2x);
    ``qz`` are the quantizers of
    :func:`~compeg_tpu_torch.ops.int_idct.int_quantizers`."""
    _check_lanes(gate, lanes)
    if _check_args(rows, nseg, tables, qz, geom, None):
        return _per_frame(lambda r, m, ln: fused_decode_rgba_exact_reference(
            r, nseg, tables, qz, geom, m, ln), rows, geom, gate, lanes)
    return _launch_rgba("compeg_fused_decode_exact", "fused_exact", rows,
                        nseg, tables, qz, geom, gate=gate, lanes=lanes)


def scaled_geometry(geom, k: int):
    """The geometry of the ``k/8`` scaled frame: ``ceil(H*k/8)`` x
    ``ceil(W*k/8)`` pixels over the same MCU grid (libjpeg's rounding)."""
    return dataclasses.replace(geom, height=-(-geom.height * k // 8),
                               width=-(-geom.width * k // 8))


def fused_decode_scaled(rows: torch.Tensor, nseg: int, tables: EntropyTables,
                        lq_k: torch.Tensor, geom, k: int) -> torch.Tensor:
    """Decode at ``k/8`` scale, k in {1, 2, 4}, to packed RGBA
    ``[ceil(H*k/8), ceil(W*k/8)]`` int32 (kernel K2s); ``lq_k`` are the
    operators of :func:`~compeg_tpu_torch.ops.idct.scaled_operators`."""
    if k not in SCALED_ZLEN:
        raise ValueError(f"scaled decode takes k in 1, 2, 4 (got {k})")
    if rows.dim() != 2:
        raise ValueError("the scaled decode takes one frame's [R, W] rows")
    if _check_args(rows, nseg, tables, lq_k, geom, k * k):
        return fused_decode_scaled_reference(rows, nseg, tables, lq_k, geom, k)
    return _launch_rgba("compeg_fused_decode_scaled", "scaled", rows, nseg,
                        tables, lq_k, scaled_geometry(geom, k), blk=k)


def plane_shapes(geom):
    """Each component's MCU-padded plane, ``[height_mcus*8*v,
    width_mcus*8*h]``."""
    return [(geom.height_mcus * 8 * v, geom.width_mcus * 8 * h)
            for h, v in geom.samplings]


def fused_decode_planes(rows: torch.Tensor, nseg: int, tables: EntropyTables,
                        op: torch.Tensor, geom, exact: bool = False,
                        out: Optional[Sequence[torch.Tensor]] = None,
                        gate: Optional[BandGate] = None,
                        lanes: Optional[LaneTable] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """Decode a frame to one u8 plane per component (kernel K3), see
    :func:`plane_shapes`; a ``[B, R, W]`` batch gives ``[B, Hc, Wc]`` planes
    in one launch. ``op`` is ``lq_t`` for the float IDCT, or the integer
    quantizers when ``exact``. ``out`` are the planes to write into,
    contiguous u8 tensors of those shapes on the rows' device that may start
    at any byte (:func:`plane_store_route`); new ones by default. ``gate``
    makes the frames bands (:class:`BandGate`), ``lanes`` decodes lanes
    (:func:`fused_decode_rgba`)."""
    _check_lanes(gate, lanes)
    shapes = [_batched(s, rows) for s in plane_shapes(geom)]
    if out is not None and (len(out) != len(shapes) or any(
            t.dtype != torch.uint8 or tuple(t.shape) != s
            or not t.is_contiguous() or t.device != rows.device
            for t, s in zip(out, shapes))):
        raise ValueError(f"out must be contiguous uint8 planes {shapes} on "
                         f"{rows.device}")
    if _check_args(rows, nseg, tables, op, geom, None if exact else 64):
        planes = _per_frame(lambda r, m, ln: fused_decode_planes_reference(
            r, nseg, tables, op, geom, exact, m, ln), rows, geom, gate, lanes)
        if out is None:
            return planes
        for t, plane in zip(out, planes):
            t.copy_(plane)
        return tuple(out)
    planes = list(out) if out is not None else [
        torch.empty(s, dtype=torch.uint8, device=rows.device) for s in shapes]
    entry, args = _lane_args("compeg_fused_decode_planes_exact" if exact
                             else "compeg_fused_decode_planes", op, lanes)
    _build.launch(entry, rows, tables.packed, *args,
                  *(planes + [None] * (3 - len(planes))),
                  params=_params(rows, nseg, tables, geom, gate=gate,
                                 lanes=lanes))
    _build.LAUNCHES["planes"] += 1
    return tuple(planes)


# ---------------------------------------------------------------------------
# Plain versions: the entropy decode's plain twin, a plain IDCT, and the
# output as gathers (composite) or reshapes (planes).
# ---------------------------------------------------------------------------


def _composite_index(geom, device, blk: int = 8) -> dict:
    """Index maps of the nearest-sampling composite: for every raster pixel,
    the flat index into ``pixels.reshape(-1)`` (``[nseg * ri, DUS, blk*blk]``
    MCU-major) of its luma sample and of its two other component samples
    (``rgba_at``, compeg_tpu/ops/fused.py:290-326)."""
    samp = geom.samplings
    gray = len(samp) == 1
    max_h = 1 if gray else max(h for h, _ in samp)
    max_v = 1 if gray else max(v for _, v in samp)
    mh, mw = blk * max_v, blk * max_h
    npx = blk * blk
    Y = torch.arange(geom.height, device=device)[:, None]
    X = torch.arange(geom.width, device=device)[None, :]
    r, x = Y % mh, X % mw
    base = ((Y // mh) * geom.width_mcus + X // mw) * (len(geom.du_to_comp) * npx)
    yh, yv = samp[0]
    yslot = (r * yv // mh) * yh + (x * yh // mw)
    yp = ((r * yv * blk // mh) % blk) * blk + (x * yh * blk // mw) % blk
    maps = {"y": base + yslot * npx + yp}
    if not gray:
        ch, cv = samp[1]
        cp = (r * cv * blk // mh) * blk + (x * ch * blk // mw)
        slot1 = yh * yv
        slot2 = slot1 + ch * cv
        maps["c1"] = base + slot1 * npx + cp
        maps["c2"] = base + slot2 * npx + cp
    return maps


def composite_rgba(pixels: torch.Tensor, geom, blk: int = 8) -> torch.Tensor:
    """Pixel blocks ``[nseg, ri, DUS, blk*blk]`` int32 -> packed RGBA
    ``[H, W]`` of ``geom``'s size: nearest upsampling, integer BT.601 (45/32,
    11/32 + 23/32, 113/64 with arithmetic shifts), clamp, pack."""
    flat = pixels.reshape(-1)
    maps = _composite_index(geom, pixels.device, blk)
    y = flat[maps["y"]]
    if "c1" not in maps:
        return pack_rgba(y, y, y)
    c1, c2 = flat[maps["c1"]], flat[maps["c2"]]
    return pack_rgba(y, c1, c2) if geom.rgb else ycbcr_to_rgba(y, c1, c2)


def _coefficients(rows, nseg, tables, geom, mcus=None, lanes=None):
    """Raw coefficients, ``[segments or lanes, MCUs each, DUS, 64]``:
    MCU-major either way, which is all the IDCT and output steps read."""
    total = geom.total_mcus if mcus is None else mcus
    if lanes is None:
        return entropy_decode_reference(rows, nseg, tables, geom.ri, total,
                                        geom.du_to_comp)
    return entropy_decode_reference(
        rows, lanes.count(geom.total_mcus), tables, lanes.mcus, total,
        geom.du_to_comp, lanes=lanes.table,
        seg_ri=min(geom.ri, geom.total_mcus))


def fused_decode_rgba_reference(rows: torch.Tensor, nseg: int,
                                tables: EntropyTables, lq_t: torch.Tensor,
                                geom, mcus: Optional[int] = None,
                                lanes: Optional[LaneTable] = None
                                ) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_decode_rgba`, on any device:
    :func:`entropy_decode_reference` -> :func:`idct_pixels` ->
    :func:`composite_rgba`. ``mcus`` is the frame's MCU count where a
    :class:`BandGate` gates it (``geom.total_mcus`` by default); ``lanes``
    (one frame's table) decodes lane by lane from it."""
    coeffs = _coefficients(rows, nseg, tables, geom, mcus, lanes)
    return composite_rgba(idct_pixels(coeffs, lq_t), geom)


def fused_decode_rgba_exact_reference(rows: torch.Tensor, nseg: int,
                                      tables: EntropyTables, qz: torch.Tensor,
                                      geom, mcus: Optional[int] = None,
                                      lanes: Optional[LaneTable] = None
                                      ) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_decode_rgba_exact`."""
    coeffs = _coefficients(rows, nseg, tables, geom, mcus, lanes)
    return composite_rgba(idct_pixels_int(coeffs, qz), geom)


def fused_decode_scaled_reference(rows: torch.Tensor, nseg: int,
                                  tables: EntropyTables, lq_k: torch.Tensor,
                                  geom, k: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_decode_scaled`."""
    coeffs = _coefficients(rows, nseg, tables, geom)
    return composite_rgba(idct_pixels(coeffs, lq_k), scaled_geometry(geom, k),
                          blk=k)


def fused_decode_planes_reference(rows: torch.Tensor, nseg: int,
                                  tables: EntropyTables, op: torch.Tensor,
                                  geom, exact: bool = False,
                                  mcus: Optional[int] = None,
                                  lanes: Optional[LaneTable] = None
                                  ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`fused_decode_planes`."""
    coeffs = _coefficients(rows, nseg, tables, geom, mcus, lanes)
    pixels = idct_pixels_int(coeffs, op) if exact else idct_pixels(coeffs, op)
    return component_planes(pixels, geom)


def rgba_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """Packed RGBA ``[..., H, W]`` int32 -> contiguous ``[..., H, W, 3]``
    uint8 on the same device (the int32's bytes are little-endian r, g, b, a)."""
    rgba = img.contiguous().view(torch.uint8).reshape(*img.shape, 4)
    return rgba[..., :3].contiguous()
