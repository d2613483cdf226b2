"""Component planes, chroma upsampling and YCbCr -> RGB as torch ops: the
epilogue of the planes kernel (K3).

Counterpart of the XLA stages of the JAX package's planes path,
``finalize_planes`` (compeg_tpu/ops/fused.py:890-1073), and of
``compeg_tpu.ops.color`` (``assemble_component_plane``,
``upsample_fancy_h/v``, ``ycbcr_to_rgb``). The JAX package byte-packs the
planes and maps chroma onto the luma word grid to suit the TPU's layout; a
GPU reads u8 planes directly, so here each step is the plain array form of
the same integer arithmetic:

* nearest: sample replication by ``fx`` in {1, 2, 4} and ``fy`` in {1, 2};
* fancy: libjpeg's triangle filter, vertical first, then horizontal, each a
  2x construct (``(3 * near + far + 1) >> 2`` for even outputs, ``+ 2`` for
  odd ones), clamped at the edge of the MCU-padded plane, never at the image
  edge; 4:1:1's 4x stays replication, as in libjpeg;
* gray replicated to three channels, RGB-ID passed through, otherwise
  integer BT.601 (45/32, 11/32 + 23/32, 113/64, arithmetic shifts), clamped;
* packed RGBA int32, cropped to ``[H, W]``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


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
    """Horizontal x2 triangle filter (``ops/color.upsample_fancy_h``)."""
    left = torch.cat([plane[:, :1], plane[:, :-1]], dim=1)
    right = torch.cat([plane[:, 1:], plane[:, -1:]], dim=1)
    even = (3 * plane + left + 1) >> 2
    odd = (3 * plane + right + 2) >> 2
    return torch.stack([even, odd], dim=2).reshape(plane.shape[0], -1)


def upsample_fancy_v(plane: torch.Tensor, above: Optional[torch.Tensor] = None,
                     below: Optional[torch.Tensor] = None,
                     valid: Optional[int] = None) -> torch.Tensor:
    """Vertical x2 triangle filter (``ops/color.upsample_fancy_v``).

    The halo-aware form serves a plane that is one slice of a taller one
    (``_upsample_fancy_v_sharded``, compeg_tpu/ops/fused.py:696-733):
    ``above`` is the row just above the slice and ``below`` the row just
    under it (each ``[W]``; None clamps to the slice's own first or last
    row, the plane's edge). ``valid`` counts the slice's rows that hold
    content when the content ends inside it: the rows from ``valid - 1``
    on clamp to themselves below, so that padding rows never bleed into
    real ones (None: the content runs through the slice and into
    ``below``)."""
    top = plane[:1] if above is None else above.reshape(1, -1)
    bottom = plane[-1:] if below is None else below.reshape(1, -1)
    up = torch.cat([top, plane[:-1]], dim=0)
    down = torch.cat([plane[1:], bottom], dim=0)
    if valid is not None:
        rows = torch.arange(plane.shape[0], device=plane.device)[:, None]
        down = torch.where(rows < valid - 1, down, plane)
    even = (3 * plane + up + 1) >> 2
    odd = (3 * plane + down + 2) >> 2
    return torch.stack([even, odd], dim=1).reshape(-1, plane.shape[1])


def upsample(plane: torch.Tensor, fx: int, fy: int, fancy: bool,
             halo: Optional[Tuple] = None) -> torch.Tensor:
    """One int32 plane to the luma grid; ``halo`` is ``(above, below,
    valid)`` of :func:`upsample_fancy_v` for a slice of a taller plane."""
    if fy > 1:
        plane = (upsample_fancy_v(plane, *(halo or ())) if fancy
                 else plane.repeat_interleave(fy, dim=0))
    if fx > 1:
        plane = (upsample_fancy_h(plane) if fancy and fx == 2
                 else plane.repeat_interleave(fx, dim=1))
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


def finalize_planes(planes: Sequence[torch.Tensor],
                    samplings: Sequence[Tuple[int, int]], width: int,
                    height: int, fancy: bool = False,
                    rgb: bool = False,
                    halos: Optional[Sequence[Optional[Tuple]]] = None
                    ) -> torch.Tensor:
    """Component planes (u8, MCU-padded) -> packed RGBA int32 ``[H, W]``.
    ``halos`` give each component's ``(above, below, valid)`` where the
    planes are a band of taller ones (:func:`upsample_fancy_v`)."""
    max_h = max(h for h, _ in samplings)
    max_v = max(v for _, v in samplings)
    halos = halos or [None] * len(planes)
    up = [upsample(p.to(torch.int32), max_h // h, max_v // v, fancy, halo)
          for p, (h, v), halo in zip(planes, samplings, halos)]
    if len(up) == 1:
        img = pack_rgba(up[0], up[0], up[0])
    elif rgb:  # component IDs R, G, B: the samples are already RGB
        img = pack_rgba(*up)
    else:
        img = ycbcr_to_rgba(*up)
    return img[:height, :width]
