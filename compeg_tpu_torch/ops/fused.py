"""Fused decode (kernel K2): entropy -> IDCT -> upsample/color -> raster RGBA,
and its plain PyTorch twin.

Counterpart of :mod:`compeg_tpu.ops.fused` in its default mode (nearest
chroma upsampling, float IDCT, gray and RGB-ID frames included). The Pallas
kernel writes segment-major blocks that an XLA transpose assembles; a GPU
thread can scatter, so K2 writes the cropped raster ``[H, W]`` itself.

Pixels are packed ``r | g << 8 | b << 16 | 0xFF << 24`` into int32, the same
bits as the JAX package's u32 RGBA.
"""

from __future__ import annotations

import torch

from . import _build
from .entropy import EntropyTables, _check, entropy_decode_reference
from .idct import idct_pixels


def _check_lq(lq_t: torch.Tensor, geom, device) -> None:
    dus = len(geom.du_to_comp)
    if (lq_t.dtype != torch.float32 or tuple(lq_t.shape) != (dus, 64, 64)
            or not lq_t.is_contiguous() or lq_t.device != device):
        raise ValueError(
            f"lq_t must be contiguous [{dus}, 64, 64] float32 on {device}, got "
            f"{lq_t.dtype} {tuple(lq_t.shape)} on {lq_t.device}"
        )


def fused_decode_rgba(rows: torch.Tensor, nseg: int, tables: EntropyTables,
                      lq_t: torch.Tensor, geom) -> torch.Tensor:
    """Decode a frame to packed RGBA ``[H, W]`` int32.

    ``rows`` are the packed segment words ``[>= nseg, W]`` int32, ``lq_t``
    the operators of :func:`~compeg_tpu_torch.ops.idct.idct_operators`, and
    ``geom`` a :class:`~compeg_tpu_torch.pipeline.FrameGeometry`. CUDA
    tensors launch kernel K2; CPU tensors take
    :func:`fused_decode_rgba_reference`."""
    _check(rows, nseg, tables)
    _check_lq(lq_t, geom, rows.device)
    if rows.device.type == "cpu":
        return fused_decode_rgba_reference(rows, nseg, tables, lq_t, geom)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    out = torch.empty((geom.height, geom.width), dtype=torch.int32,
                      device=rows.device)
    params = _build.make_params(
        nseg, rows.shape[1], geom.ri, geom.total_mcus, geom.du_to_comp,
        samplings=geom.samplings, width=geom.width, height=geom.height,
        width_mcus=geom.width_mcus, rgb=geom.rgb,
    )
    _build.launch("compeg_fused_decode", rows, tables.packed, lq_t, out,
                  params=params)
    _build.LAUNCHES["fused"] += 1
    return out


def _composite_index(geom, device) -> dict:
    """Index maps of the nearest-sampling composite: for every raster pixel,
    the flat index into ``pixels.reshape(-1)`` (``[nseg * ri, DUS, 64]``
    MCU-major) of its luma sample and of its two other component samples
    (``rgba_at``, compeg_tpu/ops/fused.py:290-326)."""
    samp = geom.samplings
    gray = len(samp) == 1
    max_h = 1 if gray else max(h for h, _ in samp)
    max_v = 1 if gray else max(v for _, v in samp)
    mh, mw = 8 * max_v, 8 * max_h
    dus = len(geom.du_to_comp)
    Y = torch.arange(geom.height, device=device)[:, None]
    X = torch.arange(geom.width, device=device)[None, :]
    r, x = Y % mh, X % mw
    base = ((Y // mh) * geom.width_mcus + X // mw) * (dus * 64)
    yh, yv = samp[0]
    yslot = (r * yv // mh) * yh + (x * yh // mw)
    yp = ((r * yv * 8 // mh) % 8) * 8 + (x * yh * 8 // mw) % 8
    maps = {"y": base + yslot * 64 + yp}
    if not gray:
        ch, cv = samp[1]
        cp = (r * cv * 8 // mh) * 8 + (x * ch * 8 // mw)
        slot1 = yh * yv
        slot2 = slot1 + ch * cv
        maps["c1"] = base + slot1 * 64 + cp
        maps["c2"] = base + slot2 * 64 + cp
    return maps


def composite_rgba(pixels: torch.Tensor, geom) -> torch.Tensor:
    """Pixel blocks ``[nseg, ri, DUS, 64]`` int32 -> packed RGBA ``[H, W]``:
    nearest upsampling, integer BT.601 (45/32, 11/32 + 23/32, 113/64 with
    arithmetic shifts), clamp, pack."""
    flat = pixels.reshape(-1)
    maps = _composite_index(geom, pixels.device)
    y = flat[maps["y"]]
    if "c1" not in maps:
        rr = gg = bb = y
    elif geom.rgb:
        rr, gg, bb = y, flat[maps["c1"]], flat[maps["c2"]]
    else:
        cb = flat[maps["c1"]] - 128
        cr = flat[maps["c2"]] - 128
        rr = y + ((45 * cr) >> 5)
        gg = y - ((11 * cb + 23 * cr) >> 5)
        bb = y + ((113 * cb) >> 6)
    rr, gg, bb = (torch.clamp(v, 0, 255) for v in (rr, gg, bb))
    return rr | (gg << 8) | (bb << 16) | -16777216  # alpha 0xFF as int32


def fused_decode_rgba_reference(rows: torch.Tensor, nseg: int,
                                tables: EntropyTables, lq_t: torch.Tensor,
                                geom) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_decode_rgba`, on any device:
    :func:`entropy_decode_reference` -> :func:`idct_pixels` ->
    :func:`composite_rgba`."""
    coeffs = entropy_decode_reference(rows, nseg, tables, geom.ri,
                                      geom.total_mcus, geom.du_to_comp)
    return composite_rgba(idct_pixels(coeffs, lq_t), geom)


def rgba_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """Packed RGBA ``[H, W]`` int32 -> contiguous ``[H, W, 3]`` uint8 on the
    same device (the int32's bytes are little-endian r, g, b, a)."""
    rgba = img.contiguous().view(torch.uint8).reshape(*img.shape, 4)
    return rgba[..., :3].contiguous()
