"""Component planes, chroma upsampling and YCbCr -> RGB: the epilogue of the
planes kernel (K3), as one CUDA kernel (E, csrc/epilogue.cu) and its plain
PyTorch twin.

Counterpart of the XLA stages of the JAX package's planes path,
``finalize_planes`` (compeg_tpu/ops/fused.py:890-1073), which XLA fuses into
one output pass, and of ``compeg_tpu.ops.color``
(``assemble_component_plane``, ``upsample_fancy_h/v``, ``ycbcr_to_rgb``).
The JAX package byte-packs the planes and maps chroma onto the luma word
grid to suit the TPU's layout; a GPU reads u8 planes directly, so here each
step is the plain array form of the same integer arithmetic:

* nearest: sample replication by ``fx`` in {1, 2, 4} and ``fy`` in {1, 2};
* fancy: libjpeg's triangle filter, vertical first, then horizontal, each a
  2x construct (``(3 * near + far + 1) >> 2`` for even outputs, ``+ 2`` for
  odd ones), clamped at the edge of the MCU-padded plane, never at the image
  edge; 4:1:1's 4x stays replication, as in libjpeg;
* gray replicated to three channels, RGB-ID passed through, otherwise
  integer BT.601 (45/32, 11/32 + 23/32, 113/64, arithmetic shifts), clamped;
* packed RGBA int32, cropped to ``[H, W]``.

:func:`finalize_planes` launches E on CUDA planes and takes
:func:`finalize_planes_reference` on CPU planes; a batch of frames (or a
rank's band frames) is one launch. E gives the twin's bytes with its own
arithmetic (csrc/epilogue.cu): a lane a quad of 4 pixels down a strip of
rows, one load a row per component, the filter's horizontal neighbours by
shuffle and its vertical ones from a window of the strip's rows, and the
filter and the colour conversion two samples to a 32-bit word.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from . import _build


def component_planes(pixels: torch.Tensor, geom) -> Tuple[torch.Tensor, ...]:
    """Pixel blocks ``[nseg, ri, DUS, 64]`` -> one u8 plane per component at
    its own resolution, ``[height_mcus*8*v, width_mcus*8*h]`` (what K3
    writes; ``assemble_component_plane``)."""
    x = pixels.reshape(-1, pixels.shape[-2], 64)[: geom.total_mcus]
    hm, wm = geom.height_mcus, geom.width_mcus
    planes = []
    slot = 0
    for sh, sv in geom.samplings:
        p = x[:, slot:slot + sh * sv].reshape(hm, wm, sv, sh, 8, 8)
        p = p.permute(0, 2, 4, 1, 3, 5).reshape(hm * sv * 8, wm * sh * 8)
        planes.append(p.to(torch.uint8))
        slot += sh * sv
    return tuple(planes)


def upsample_fancy_h(plane: torch.Tensor) -> torch.Tensor:
    """Horizontal x2 triangle filter over the last dimension
    (``ops/color.upsample_fancy_h``)."""
    left = torch.cat([plane[..., :1], plane[..., :-1]], dim=-1)
    right = torch.cat([plane[..., 1:], plane[..., -1:]], dim=-1)
    even = (3 * plane + left + 1) >> 2
    odd = (3 * plane + right + 2) >> 2
    return torch.stack([even, odd], dim=-1).reshape(*plane.shape[:-1], -1)


def upsample_fancy_v(plane: torch.Tensor, above: Optional[torch.Tensor] = None,
                     below: Optional[torch.Tensor] = None,
                     valid: Optional[int] = None) -> torch.Tensor:
    """Vertical x2 triangle filter over the rows, the second-to-last
    dimension (``ops/color.upsample_fancy_v``); a leading batch dimension
    filters each frame on its own.

    The halo-aware form serves a plane that is one slice of a taller one
    (``_upsample_fancy_v_sharded``, compeg_tpu/ops/fused.py:696-733):
    ``above`` is the row just above the slice and ``below`` the row just
    under it (each ``[W]``, or ``[B, W]`` for a batch; None clamps to the
    slice's own first or last row, the plane's edge). ``valid`` counts the
    slice's rows that hold content when the content ends inside it: the
    rows from ``valid - 1`` on clamp to themselves below, so that padding
    rows never bleed into real ones (None: the content runs through the
    slice and into ``below``)."""
    top = plane[..., :1, :] if above is None else above.unsqueeze(-2)
    bottom = plane[..., -1:, :] if below is None else below.unsqueeze(-2)
    up = torch.cat([top, plane[..., :-1, :]], dim=-2)
    down = torch.cat([plane[..., 1:, :], bottom], dim=-2)
    if valid is not None:
        rows = torch.arange(plane.shape[-2], device=plane.device)[:, None]
        down = torch.where(rows < valid - 1, down, plane)
    even = (3 * plane + up + 1) >> 2
    odd = (3 * plane + down + 2) >> 2
    return torch.stack([even, odd], dim=-2).reshape(
        *plane.shape[:-2], -1, plane.shape[-1])


def upsample(plane: torch.Tensor, fx: int, fy: int, fancy: bool,
             halo: Optional[Tuple] = None) -> torch.Tensor:
    """One int32 plane (or a batch of them) to the luma grid; ``halo`` is
    ``(above, below, valid)`` of :func:`upsample_fancy_v` for a slice of a
    taller plane."""
    if fy > 1:
        plane = (upsample_fancy_v(plane, *(halo or ())) if fancy
                 else plane.repeat_interleave(fy, dim=-2))
    if fx > 1:
        plane = (upsample_fancy_h(plane) if fancy and fx == 2
                 else plane.repeat_interleave(fx, dim=-1))
    return plane


def pack_rgba(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Channels in [0, 255] -> ``r | g << 8 | b << 16 | 0xFF << 24`` int32."""
    return r | (g << 8) | (b << 16) | -16777216  # alpha 0xFF as int32


def ycbcr_to_rgba(y: torch.Tensor, cb: torch.Tensor,
                  cr: torch.Tensor) -> torch.Tensor:
    """Integer BT.601 with the reference's constants, clamped, packed."""
    cb = cb - 128
    cr = cr - 128
    r = torch.clamp(y + ((45 * cr) >> 5), 0, 255)
    g = torch.clamp(y - ((11 * cb + 23 * cr) >> 5), 0, 255)
    b = torch.clamp(y + ((113 * cb) >> 6), 0, 255)
    return pack_rgba(r, g, b)


def _factors(samplings) -> List[Tuple[int, int]]:
    max_h = max(h for h, _ in samplings)
    max_v = max(v for _, v in samplings)
    return [(max_h // h, max_v // v) for h, v in samplings]


def finalize_planes_reference(planes: Sequence[torch.Tensor],
                              samplings: Sequence[Tuple[int, int]],
                              width: int, height: int, fancy: bool = False,
                              rgb: bool = False,
                              halos: Optional[Sequence[Optional[Tuple]]] = None
                              ) -> torch.Tensor:
    """Plain PyTorch version of :func:`finalize_planes`, on any device:
    component planes (u8, MCU-padded, ``[Hc, Wc]`` or a batch ``[B, Hc,
    Wc]``) -> packed RGBA int32 ``[H, W]`` (``[B, H, W]``). ``halos`` give
    each component's ``(above, below, valid)`` where the planes are a band
    of taller ones (:func:`upsample_fancy_v`)."""
    halos = halos or [None] * len(planes)
    up = [upsample(p.to(torch.int32), fx, fy, fancy, halo)
          for p, (fx, fy), halo in zip(planes, _factors(samplings), halos)]
    if len(up) == 1:
        img = pack_rgba(up[0], up[0], up[0])
    elif rgb:  # component IDs R, G, B: the samples are already RGB
        img = pack_rgba(*up)
    else:
        img = ycbcr_to_rgba(*up)
    return img[..., :height, :width]


def _check_planes(planes, samplings, width, height, halos):
    """Checks what E takes (the plain twin takes the same); returns the
    batch size, None for one frame's 2-D planes."""
    if len(planes) not in (1, 3) or len(samplings) != len(planes):
        raise ValueError(f"{len(planes)} planes for {len(samplings)} "
                         "samplings: the epilogue takes 1 or 3 components")
    dev, dim = planes[0].device, planes[0].dim()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dim not in (2, 3):
        raise ValueError(f"planes must be [Hc, Wc] or [B, Hc, Wc], got "
                         f"{tuple(planes[0].shape)}")
    batch = planes[0].shape[0] if dim == 3 else None
    if batch is not None and not 1 <= batch <= 65535:
        raise ValueError(f"a batch holds 1 to 65535 frames, not {batch}")
    if width < 1 or height < 1:
        raise ValueError(f"output size {height} x {width}")
    factors = _factors(samplings)
    grid = (planes[0].shape[-2] * factors[0][1],
            planes[0].shape[-1] * factors[0][0])  # the upsampled planes
    max_h = max(h for h, _ in samplings)
    max_v = max(v for _, v in samplings)
    for c, (p, (fx, fy)) in enumerate(zip(planes, factors)):
        if (p.dtype != torch.uint8 or not p.is_contiguous()
                or p.device != dev or p.dim() != dim
                or (batch is not None and p.shape[0] != batch)):
            raise ValueError(
                f"plane {c} must be a contiguous uint8 tensor of "
                f"{dim} dimensions on {dev} like plane 0 "
                f"{tuple(planes[0].shape)}, got {p.dtype} {tuple(p.shape)} "
                f"on {p.device}")
        if (fx not in (1, 2, 4) or fy not in (1, 2)
                or samplings[c][0] * fx != max_h
                or samplings[c][1] * fy != max_v):
            raise ValueError(f"sampling {tuple(samplings[c])} of "
                             f"{[tuple(s) for s in samplings]}: the epilogue "
                             "upsamples by 1, 2 or 4 across and 1 or 2 down")
        if (p.shape[-2] * fy, p.shape[-1] * fx) != grid:
            raise ValueError(f"plane {c} {tuple(p.shape)} upsampled by "
                             f"{fx} x {fy} does not cover plane 0's {grid}")
    if grid[0] < height or grid[1] < width:
        raise ValueError(f"the planes upsample to {grid}, less than "
                         f"{height} x {width}")
    if halos is None:
        return batch
    if len(halos) != len(planes):
        raise ValueError(f"{len(halos)} halos for {len(planes)} planes")
    for c, (p, halo) in enumerate(zip(planes, halos)):
        if halo is None:
            continue
        above, below, valid = halo
        row = (p.shape[-1],) if batch is None else (batch, p.shape[-1])
        for name, h in (("above", above), ("below", below)):
            if h is not None and (h.dtype != torch.uint8 or h.device != dev
                                  or tuple(h.shape) != row
                                  or not h.is_contiguous()):
                raise ValueError(
                    f"halo {name} of plane {c} must be a contiguous uint8 "
                    f"{list(row)} on {dev}, got {h.dtype} {tuple(h.shape)} "
                    f"on {h.device}")
        if valid is not None and not 0 <= valid <= p.shape[-2]:
            raise ValueError(f"valid {valid} of plane {c}: not in [0, "
                             f"{p.shape[-2]}]")
    return batch


def finalize_planes(planes: Sequence[torch.Tensor],
                    samplings: Sequence[Tuple[int, int]], width: int,
                    height: int, fancy: bool = False,
                    rgb: bool = False,
                    halos: Optional[Sequence[Optional[Tuple]]] = None
                    ) -> torch.Tensor:
    """Component planes (u8, MCU-padded) -> packed RGBA int32 ``[H, W]``, or
    a batch ``[B, Hc, Wc]`` of each frame's planes -> ``[B, H, W]`` in one
    launch of the planes epilogue E (csrc/epilogue.cu); CPU planes take
    :func:`finalize_planes_reference`. ``halos`` give each component's
    ``(above, below, valid)`` where the planes are a band of taller ones
    (:func:`upsample_fancy_v`; ``above`` and ``below`` ``[Wc]``, ``[B, Wc]``
    for a batch, or None)."""
    batch = _check_planes(planes, samplings, width, height, halos)
    if planes[0].device.type == "cpu":
        return finalize_planes_reference(planes, samplings, width, height,
                                         fancy, rgb, halos)
    frames = batch or 1
    out = torch.empty((frames, height, width), dtype=torch.int32,
                      device=planes[0].device)
    params, tensors = epilogue_args(planes, samplings, width, height, fancy,
                                    rgb, halos)
    _build.launch("compeg_planes_epilogue", *tensors, out, params=params)
    _build.LAUNCHES["epilogue"] += 1
    return out if batch is not None else out[0]


def epilogue_args(planes, samplings, width, height, fancy=False, rgb=False,
                  halos=None):
    """E's launch parameters and the nine tensors its entry point takes
    before the output (three planes, three ``above`` and three ``below``
    halo rows, None for a null pointer), for planes that
    :func:`finalize_planes` has checked."""
    p = _build.EpilogueParams(
        frames=planes[0].shape[0] if planes[0].dim() == 3 else 1,
        ncomp=len(planes), rgb=int(rgb), fancy=int(fancy), width=width,
        height=height)
    halos = halos or [None] * len(planes)
    above, below = [None] * 3, [None] * 3
    for c, (plane, (fx, fy), halo) in enumerate(
            zip(planes, _factors(samplings), halos)):
        p.plane_h[c], p.plane_w[c] = plane.shape[-2:]
        p.fx[c], p.fy[c] = fx, fy
        p.valid[c] = -1
        if halo is not None:
            above[c], below[c], valid = halo
            p.valid[c] = -1 if valid is None else valid
    padded = list(planes) + [None] * (3 - len(planes))
    return p, padded + above + below
