"""Banded decode over a (data, seq) mesh of processes: the port of
compeg_tpu/parallel/sharding.py.

Two axes of parallelism, composable, as in the JAX package:

 * ``data``: frames of a batch are independent; each rank of the data axis
   decodes its share of the batch (the many-streams configuration).
 * ``seq``: one frame's MCU rows are split into horizontal *bands*; each
   rank of the seq axis decodes its own bands. Restart segments give clean
   cut points: a band decodes its own segments and nothing else.

The JAX package maps one program over a jax ``Mesh`` with ``shard_map``.
Here the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the process group (one process a rank, and on CUDA one card a
rank), and every rank calls :func:`decode_batch_sharded` on its own part of
the batch. A single process with no process group gets :class:`LocalMesh`,
the 1 x 1 mesh, and needs no ``torch.distributed`` at all.

**One layout.** The JAX package packs bands in a raster-tiled slot layout
when the restart interval divides the MCU-row width and in linear slots
otherwise. The port has no tiling: every frame is packed into the linear
per-segment rows of ``pack_rows``, and a band is the run of rows that holds
its segments. Band height follows the JAX fallback
(compeg_tpu/parallel/sharding.py:199-207): ``ceil(hm / n_bands)`` rounded up
to ``r0 = Ri / gcd(Ri, wm)`` MCU rows, so that every band starts at a row
start and at a restart boundary whatever Ri is (``r0 = 1`` where Ri divides
``wm``).

**A band is a frame.** A rank holding ``B_l`` frames of ``NB_l`` bands
decodes them as ``B_l * NB_l`` frames of the band's geometry
(``band_rows`` MCU rows high) in ONE launch of the batched kernels, which
take frames along ``blockIdx.y``: K2 for nearest chroma, K2x with
``exact_idct``, and K3 followed by one launch of the planes epilogue E
(``ops/color.finalize_planes``, the rank's frames and halos together) for
fancy chroma.

**The band gate.** As the JAX package gates every segment by its
``seg_mcus``, each band frame decodes only its MCUs inside the image:
``clip(total_mcus - b * band_rows * wm, 0, band_rows * wm)`` for band ``b``
(:func:`band_mcus`, ``BandedFrame.band_mcus``), which the launch derives
from three scalars (:class:`~compeg_tpu_torch.ops.fused.BandGate`: the
image's MCUs, the bands of a frame in the launch and the first one's
index). The image's short final interval, the last band's rows past the
image and the bands wholly past it read no bits. Their pixels are not
written (the plain twins give them zero coefficients) and lie only in rows
at or past the MCU-padded height, which are cropped; the fancy filter's
content-edge clamp keeps them out of the last real rows, and a rank whose
bands all lie past the image sends halos that no rank reads.

**The halo.** The fancy (triangle) vertical filter needs the chroma row
just above and just below each rank's shard: :func:`exchange_halos` swaps
them with the seq neighbours (``dist.batch_isend_irecv``), rank 0 clamps its
top to its own first row, and the content edge clamps as in one piece
(``_upsample_fancy_v_sharded``, compeg_tpu/ops/fused.py:696-733). Bands
inside one rank are one shard-tall plane and need no exchange. Nearest
upsampling stays inside an MCU and needs no neighbour at all.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..batch import BatchDecoder
from ..errors import CompegError, bail
from ..metadata import ImageData
from ..ops import color as C
from ..ops import entropy as E
from ..ops import fused as F
from ..ops import idct as D
from ..pipeline import Decoder, FrameGeometry, decode_fused, row_capacity

AXES = ("data", "seq")


class LocalMesh:
    """The 1 x 1 (data, seq) mesh of one process that has no process group:
    the subset of ``DeviceMesh`` that this module reads."""

    shape = (1, 1)

    def __init__(self, device_type: str = "cuda"):
        self.device_type = device_type
        self.mesh = torch.zeros((1, 1), dtype=torch.int64)  # global ranks

    def get_coordinate(self) -> List[int]:
        return [0, 0]


def make_mesh(n_data: int, n_seq: int = 1, device_type: Optional[str] = None):
    """A (data, seq) mesh over the ranks of the process group, which must
    hold exactly ``n_data * n_seq`` ranks; ``device_type`` defaults to the
    group's (``cuda`` under NCCL, else ``cpu``). Without a process group
    only the 1 x 1 mesh exists, as :class:`LocalMesh`."""
    need = n_data * n_seq
    if not dist.is_initialized():
        if need != 1:
            bail(f"a {n_data} x {n_seq} mesh needs a process group of {need} "
                 "ranks (multihost.init_distributed)")
        return LocalMesh(device_type or "cuda")
    world = dist.get_world_size()
    if world != need:
        bail(f"a {n_data} x {n_seq} mesh needs {need} ranks, the process "
             f"group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (n_data, n_seq), mesh_dim_names=AXES)


def mesh_coordinate(mesh) -> Tuple[int, int]:
    """This rank's (data, seq) coordinate in ``mesh``."""
    coord = mesh.get_coordinate()
    if coord is None:
        bail("this rank is not in the mesh")
    return int(coord[0]), int(coord[1])


@dataclass
class BandedFrame:
    """One frame packed as ``n_bands`` horizontal bands of MCU rows.

    rows:       ``[n_bands, nseg, W]`` int32: band ``b`` holds the frame's
                restart segments ``b * nseg`` to ``(b + 1) * nseg - 1``, one
                a row of MSB-first words (``pack_rows``' layout), zero rows
                past the frame's last segment
    nseg:       segments in each band, ``band_rows * wm / Ri`` (whole
                intervals, the same for every band)
    band_rows:  MCU rows per band (trailing bands may be padding)
    band_mcus:  ``[n_bands]`` int32, the MCUs of each band inside the image
                (:func:`band_mcus`): the JAX ``seg_mcus`` summed per band,
                0 for a band past the image; the kernels decode no other
    qz_by_slot: ``[DUS, 64]`` zigzag quantizers, the IDCT's constants
    image:      the analysed frame (geometry and Huffman tables)

    There is no ``tiling``: the port packs every frame in one layout.
    """

    rows: np.ndarray
    nseg: int
    band_rows: int
    band_mcus: np.ndarray
    qz_by_slot: np.ndarray
    image: ImageData

    @property
    def seg_mcus(self) -> np.ndarray:
        """``[n_bands, nseg]`` int32, the MCUs each segment of each band
        decodes: ``min(Ri, band's MCUs - k * Ri)`` for its k-th segment, 0
        past them (the JAX linear layout's ``seg_mcus``, segment by
        segment)."""
        ri = self.image.restart_interval
        k = np.arange(self.nseg, dtype=np.int64)
        return np.clip(self.band_mcus[:, None] - k * ri, 0, ri).astype(
            np.int32)


def band_rows_for(img: ImageData, n_bands: int) -> int:
    """MCU rows per band: ``ceil(hm / n_bands)`` rounded up to a multiple
    of ``r0 = Ri / gcd(Ri, wm)``, the fewest rows that hold whole restart
    intervals."""
    ri, wm, hm = img.restart_interval, img.width_mcus, img.height_mcus
    r0 = ri // math.gcd(ri, wm)
    return -(-(-(-hm // n_bands)) // r0) * r0


def band_segments(img: ImageData, band_rows: int) -> int:
    """Restart segments in a band of ``band_rows`` MCU rows."""
    return band_rows * img.width_mcus // img.restart_interval


def band_mcus(img: ImageData, n_bands: int) -> np.ndarray:
    """``[n_bands]`` int32: the MCUs of each band that lie in the image,
    ``clip(total_mcus - b * band_rows * wm, 0, band_rows * wm)``, the sum
    over band ``b`` of the JAX package's ``seg_mcus`` on either of its
    layouts."""
    per_band = band_rows_for(img, n_bands) * img.width_mcus
    b = np.arange(n_bands, dtype=np.int64)
    return np.clip(img.total_mcus - b * per_band, 0, per_band).astype(
        np.int32)


def prepare_banded(img: ImageData, n_bands: int,
                   words_per_segment: Optional[int] = None) -> BandedFrame:
    """Host-side packing of one frame into ``n_bands`` MCU-row bands: the
    scan packed once into segment rows (the native packer where it is
    built), then cut into runs of ``nseg`` rows. ``words_per_segment``
    forces the row width (a stream's steady width); it must hold the
    longest segment."""
    if n_bands < 1:
        bail(f"n_bands must be at least 1 (got {n_bands})")
    band_rows = band_rows_for(img, n_bands)
    nseg_b = band_segments(img, band_rows)
    packer = Decoder(device="cpu")
    width = words_per_segment or packer.measure_width(img)
    rows = np.empty((row_capacity(n_bands * nseg_b), width), np.uint32)
    packer.pack_into(img, rows)
    return BandedFrame(rows=rows[:n_bands * nseg_b].view(np.int32).reshape(
                           n_bands, nseg_b, width),
                       nseg=nseg_b, band_rows=band_rows,
                       band_mcus=band_mcus(img, n_bands),
                       qz_by_slot=D.qz_by_slot_array(img), image=img)


def stack_banded(frames: Sequence[BandedFrame]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Stack banded frames of one geometry into the rows ``[B, n_bands,
    nseg, W]`` int32, every frame's widened with zero words to the widest,
    and their ``band_mcus``, ``[B, n_bands]`` int32 (the JAX function's
    ``(words, seg_mcus)``)."""
    f0 = frames[0]
    for f in frames[1:]:
        if (f.rows.shape[:2] != f0.rows.shape[:2] or f.band_rows != f0.band_rows
                or not np.array_equal(f.band_mcus, f0.band_mcus)):
            bail("banded frames must share geometry and band count")
    width = max(f.rows.shape[2] for f in frames)
    out = np.zeros((len(frames),) + f0.rows.shape[:2] + (width,), np.int32)
    for i, f in enumerate(frames):
        out[i, :, :, :f.rows.shape[2]] = f.rows
    return out, np.stack([f.band_mcus for f in frames])


def band_geometry(geom: FrameGeometry, band_rows: int) -> FrameGeometry:
    """The geometry the kernels decode one band as: ``band_rows`` MCU rows
    of the frame's width, of which the :func:`band_gate` keeps those inside
    the image."""
    max_v = max(v for _, v in geom.samplings)
    return dataclasses.replace(geom, height=band_rows * 8 * max_v,
                               height_mcus=band_rows)


def band_gate(geom: FrameGeometry, n_local: int, seq: int) -> F.BandGate:
    """The launch's gate for a rank at seq coordinate ``seq`` holding
    ``n_local`` bands of each of its frames: its band frame ``f`` is band
    ``seq * n_local + f % n_local`` of an image of ``geom.total_mcus``
    MCUs."""
    return F.BandGate(geom.total_mcus, n_local, seq * n_local)


def check_budget(geom: FrameGeometry, band_rows: int, frames: int,
                 rows_bytes: int, max_device_bytes: int) -> None:
    """``Decoder.check_budget`` for one rank's ``frames`` band frames: each
    band's raster and u8 planes, MCU-padded, and the rank's segment rows."""
    max_h = max(h for h, _ in geom.samplings)
    max_v = max(v for _, v in geom.samplings)
    mcu = 64 * max_h * max_v * 4 + len(geom.du_to_comp) * 64
    est = frames * band_rows * geom.width_mcus * mcu + rows_bytes
    if est > max_device_bytes:
        raise CompegError(
            f"banded decode would need ~{est >> 20} MiB of device buffers on "
            f"this rank ({frames} band frames of {band_rows} MCU rows); "
            f"exceeds the {max_device_bytes >> 20} MiB budget"
        )


def exchange_halos(planes: Sequence[torch.Tensor], geom: FrameGeometry,
                   mesh) -> List[Optional[Tuple]]:
    """The fancy vertical filter's halos of this rank's shard-tall planes
    (``[B_l, rows, Wc]`` u8, one per component): for each component the
    filter upsamples vertically, ``(above, below, valid)`` for
    :func:`~compeg_tpu_torch.ops.color.upsample_fancy_v`, each halo
    ``[B_l, Wc]`` or None; None for the others.

    ``above`` is the last row of the seq neighbour above (None at the top
    of the image: rank 0 clamps to its own first row) and ``below`` the
    first row of the neighbour below where the content runs on into it;
    where the content ends inside this shard, ``valid`` counts its content
    rows and the filter clamps there (the content edge). Every rank sends
    its first rows up and its last rows down in one
    ``dist.batch_isend_irecv``, all components and frames in one tensor
    each way."""
    n_seq = mesh.shape[1]
    d, s = mesh_coordinate(mesh)
    max_v = max(v for _, v in geom.samplings)
    need = [max_v // v > 1 for _, v in geom.samplings]
    sub = [p for p, n in zip(planes, need) if n]
    from_above = from_below = None
    if sub and n_seq > 1:
        first = torch.cat([p[:, 0] for p in sub], dim=1).contiguous()
        last = torch.cat([p[:, -1] for p in sub], dim=1).contiguous()
        ops = []
        if s > 0:
            up = int(mesh.mesh[d, s - 1])
            from_above = torch.empty_like(last)
            ops += [dist.P2POp(dist.isend, first, up),
                    dist.P2POp(dist.irecv, from_above, up)]
        if s < n_seq - 1:
            down = int(mesh.mesh[d, s + 1])
            from_below = torch.empty_like(first)
            ops += [dist.P2POp(dist.isend, last, down),
                    dist.P2POp(dist.irecv, from_below, down)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    widths = [p.shape[2] for p in sub]

    def split(t):  # each component's rows, contiguous as E takes them
        return [None] * len(sub) if t is None else [
            h.contiguous() for h in t.split(widths, 1)]

    above, below = iter(split(from_above)), iter(split(from_below))
    halos: List[Optional[Tuple]] = []
    for p, n, (_, v) in zip(planes, need, geom.samplings):
        if not n:
            halos.append(None)
            continue
        shard = p.shape[1]
        left = geom.height_mcus * 8 * v - s * shard  # content rows from here
        a, b = next(above), next(below)
        halos.append((a, b if left > shard else None,
                      None if left > shard else max(0, left)))
    return halos


def decode_batch_sharded(
    rows: torch.Tensor,  # [B_l, NB_l, nseg, W] int32, this rank's part
    nseg: int,
    tables: E.EntropyTables,
    op: torch.Tensor,
    *,
    mesh,
    geom: FrameGeometry,
    band_rows: int,
    fancy_upsample: bool = False,
    exact_idct: bool = False,
    max_device_bytes: int = 8 << 30,
) -> torch.Tensor:
    """Decode this rank's part of a batch of banded frames.

    ``rows`` are the rank's ``B_l`` frames of ``NB_l`` bands (its data
    coordinate's frames and its seq coordinate's bands of
    :func:`stack_banded`'s array) on its device, with the
    stream's ``tables`` and IDCT operand ``op`` (the mode's: integer with
    ``exact_idct``) on the same device, as ``Decoder.frame_constants``
    makes them. All band frames decode in one kernel launch (K2; K2x with
    ``exact_idct``; K3 and one launch of the planes epilogue with
    ``fancy_upsample``),
    each gated to its band's MCUs inside the image (:func:`band_gate`: the
    rank's band ``j`` of a frame is the image's band ``s * NB_l + j``), and
    the seq neighbours swap halos where the fancy filter needs them.

    Returns packed RGBA int32 ``[B_l, rows_l, W]``: this rank's rows of the
    global ``[B, H, W]`` (r | g << 8 | b << 16 | a << 24, the single-frame
    contract), cropped to ``[0, H)``, so zero rows for a rank whose bands
    all lie past the bottom. The JAX function returns one global array
    sharded over the mesh; torch has no such array, so each rank gets its
    own part and :func:`gather_global` assembles the whole.

    There is no ``tiling`` argument: the JAX keyword tells its two slot
    layouts apart, and the port packs every frame in the one linear layout.
    ``max_device_bytes`` is ``Decoder``'s budget, checked for this rank's
    ``B_l * NB_l`` band frames."""
    if rows.dim() != 4 or rows.dtype != torch.int32:
        raise ValueError(f"rows must be [B_l, NB_l, nseg, W] int32, got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    _, s = mesh_coordinate(mesh)
    b_l, nb_l, r, w = rows.shape
    check_budget(geom, band_rows, b_l * nb_l, rows.numel() * 4,
                 max_device_bytes)
    bg = band_geometry(geom, band_rows)
    shard_h = nb_l * bg.height
    out = decode_fused(rows.contiguous().reshape(b_l * nb_l, r, w), nseg,
                       tables, op, bg, exact=exact_idct,
                       planes=fancy_upsample, gate=band_gate(geom, nb_l, s))
    if not fancy_upsample:
        out = out.reshape(b_l, shard_h, geom.width)
    else:
        planes = [p.reshape(b_l, nb_l * p.shape[1], p.shape[2]) for p in out]
        # The rank's frames and their halos in one launch of the planes
        # epilogue E.
        out = C.finalize_planes(planes, geom.samplings, geom.width, shard_h,
                                fancy=True, rgb=geom.rgb,
                                halos=exchange_halos(planes, geom, mesh))
    return out[:, :min(shard_h, max(0, geom.height - s * shard_h))]


def gather_global(out: torch.Tensor, mesh) -> torch.Tensor:
    """The global ``[B, H, W]`` from every rank's part
    (:func:`decode_batch_sharded`'s results), all-gathered over the process
    group so that every rank holds it; for tests and the dryrun. On the
    1 x 1 :class:`LocalMesh` the part is the whole."""
    if isinstance(mesh, LocalMesh):
        return out
    n_data, n_seq = mesh.shape
    world = dist.get_world_size()
    count = torch.tensor([out.shape[1]], dtype=torch.int64, device=out.device)
    counts = [torch.zeros_like(count) for _ in range(world)]
    dist.all_gather(counts, count)
    counts = [int(c) for c in counts]
    padded = out.new_zeros((out.shape[0], max(counts), out.shape[2]))
    padded[:, :out.shape[1]] = out
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded)
    ranks = mesh.mesh.tolist()
    return torch.cat([
        torch.cat([parts[ranks[d][s]][:, :counts[ranks[d][s]]]
                   for s in range(n_seq)], dim=1)
        for d in range(n_data)])


def decode_frames_sharded(frames: Sequence[bytes], mesh,
                          n_bands: Optional[int] = None, *,
                          decoder: Optional[BatchDecoder] = None
                          ) -> torch.Tensor:
    """Decode the global batch ``frames`` (JPEG bytes of one geometry and
    one set of tables; every rank passes the same list) in ``n_bands``
    bands a frame (the mesh's seq size by default). Each rank analyses and
    packs only its own frames, uploads its bands and runs
    :func:`decode_batch_sharded`; the result is this rank's part, as there.

    ``decoder`` is the rank's :class:`~compeg_tpu_torch.batch.BatchDecoder`
    (a new one on the card by default): its device, ``exact_idct``,
    ``fancy_upsampling`` and budget are the decode's, its header cache keeps
    the stream's tables and IDCT operand on the device, and the frames are
    packed into its pinned staging buffer, so reuse one across the batches
    of a stream."""
    dec = decoder if decoder is not None else BatchDecoder()
    if not dec.fused:
        bail("the banded decode takes the fused kernels (fused=True)")
    n_data, n_seq = mesh.shape
    d, s = mesh_coordinate(mesh)
    n_bands = n_bands or n_seq
    if not frames or len(frames) % n_data or n_bands % n_seq:
        bail(f"batch of {len(frames)} frames in {n_bands} bands not "
             f"divisible by mesh {n_data}x{n_seq}")
    b_l, nb_l = len(frames) // n_data, n_bands // n_seq
    mine = frames[d * b_l:(d + 1) * b_l]
    img0 = dec._dec._analyze(mine[0])[0]
    band_rows = band_rows_for(img0, n_bands)
    nseg_b = band_segments(img0, band_rows)
    pf = dec.prepare_batch(mine, n_bands * nseg_b)[0]
    rows = dec.upload(nb_l * nseg_b, lo=s * nb_l * nseg_b)
    return decode_batch_sharded(
        rows.reshape(b_l, nb_l, nseg_b, rows.shape[2]), nseg_b, pf.tables,
        pf.op, mesh=mesh, geom=pf.geom, band_rows=band_rows,
        fancy_upsample=dec.fancy, exact_idct=dec.exact_idct,
        max_device_bytes=dec._dec.max_device_bytes)


def dryrun(n_devices: int, device="cuda") -> None:
    """A smoke test of the banded path: one sharded decode step of each
    configuration on an ``n_devices`` mesh of the current process group
    (``(n/2, 2)`` when n is even, a 1 x 1 :class:`LocalMesh` for one
    process without a group), at tiny shapes: Ri = 1 nearest (K2), Ri = 1 fancy 4:2:0 with the halo
    exchange (K3 and the epilogue), and Ri = 3 with ``exact_idct`` (K2x),
    whose bands are cut at a restart boundary (Ri does not divide the 2-MCU
    row). Checks each gathered result's shape and dtype."""
    from ..encoder import encode

    n_seq = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_data = n_devices // n_seq
    mesh = make_mesh(n_data, n_seq, torch.device(device).type)
    h, w = 32, 32
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 7 % 256, yy * 5 % 256, (xx + yy) % 256],
                   axis=-1).astype(np.uint8)
    for ri, sampling, knobs in ((1, "422", {}),
                                (1, "420", {"fancy_upsampling": True}),
                                (3, "422", {"exact_idct": True})):
        data = encode(img, sampling=sampling, quality=85,
                      restart_interval_mcus=ri)
        out = gather_global(decode_frames_sharded(
            [data] * n_data, mesh,
            decoder=BatchDecoder(device=device, **knobs)), mesh)
        if tuple(out.shape) != (n_data, h, w) or out.dtype != torch.int32:
            raise AssertionError(f"dryrun, Ri {ri} {sampling} {knobs}: "
                                 f"{tuple(out.shape)} {out.dtype}")
