"""Relayouts of u32 rasters: the four kernels of csrc/relayout.cu, each with
its plain PyTorch version beside it.

Counterpart of the JAX package's relayout probes under ``tools/``
(``exp_interleave.py``, ``exp_swap_pallas.py``, ``exp_assembly2.py``,
``exp_mosaic_bisect.py``). Those asked which formulation of a permutation
the TPU's compiler could lower and how fast; here each permutation they
compute is one hand-written kernel:

* :func:`relayout_interleave`: the minor transpose ``[..., X, L] ->
  [..., L, X]`` flattened to ``[..., L * X]``, optionally with the rows
  stacked as the raster form stacks them. It has a 16-byte vector kernel
  and a word tile; :func:`interleave_route` picks between them;
* :func:`relayout_swap_crop`: the assembly's tile swap and the crop to
  ``[H, W]`` in one pass, the interleave of every tile of the slab into a
  pitched raster on the same two kernels; :func:`swap_crop_route` picks;
* :func:`relayout_stack`: ``[g, s, r, x, l] -> [g, x, s * R + r, l]``;
* :func:`relayout_spread_merge`: ``out[s, l * X + k] = (a if k == 0 else
  b)[s, l]``; :func:`relayout_spread` (``b = a``) and :func:`relayout_copy`
  (``X = 1``, the store-bandwidth floor) are its special cases. It has
  16-byte vector kernels, the copy's shift kernel for views they do not fit
  and a word-per-thread kernel for the spread and merge;
  :func:`spread_merge_route` picks among them from pointers, strides and
  lengths.

Tensors are int32 (the same bits as the probes' u32). A CUDA tensor launches
the kernel; a CPU tensor takes the plain version (a ``permute`` /
``reshape`` / slice), which on the card also serves as the library call
whose time stands beside the kernel's.
"""

from __future__ import annotations

import torch

from . import _build


def _check(t: torch.Tensor, ndim, name: str) -> bool:
    """Checks a kernel input; True when it lies on the CPU."""
    dims = ndim if isinstance(ndim, tuple) else (ndim,)
    if t.dtype != torch.int32 or t.dim() not in dims:
        raise ValueError(f"{name} must be int32 with {ndim} dimensions, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cpu"


def _contiguous(t: torch.Tensor, name: str) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(entry: str, key: str, *tensors, **fields) -> None:
    _build.launch(entry, *tensors, params=_build.RelayoutParams(**fields))
    _build.LAUNCHES[key] += 1


# -- P1: (x, lane) -> raster interleave --------------------------------------


def _interleave_shape(shape, stack_rows: bool):
    *lead, x, l = shape
    if stack_rows:
        if len(lead) < 2:
            raise ValueError("stack_rows needs [..., S, R, X, L]")
        lead = [*lead[:-2], lead[-2] * lead[-1]]
    return (*lead, l * x)


def relayout_interleave_reference(v: torch.Tensor,
                                  stack_rows: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`relayout_interleave`."""
    out = v.transpose(-1, -2).contiguous()
    return out.reshape(_interleave_shape(v.shape, stack_rows))


def interleave_route(in_ptr: int, out_ptr: int, n: int, x: int, l: int,
                     in_stride: int) -> str:
    """Which kernel an interleave of ``n`` matrices ``[x, l]`` takes, from
    its pointers (byte addresses), sizes and batch stride alone: ``"vec"``,
    the 16-byte kernel, or ``"word"``, the word tile (16-byte vectors where
    memory's alignment allows, single words at the ends of its rows and of
    its output span).

    The vector kernel moves 4 x 4 blocks, so it needs X in {4, 8, 16, 32}
    (its index splits are shifts), rows of whole vectors (``l % 4 == 0``),
    both pointers on a 16-byte boundary, and, for more than one matrix, a
    batch stride of whole vectors."""
    if x not in (4, 8, 16, 32) or l % 4 or in_ptr % 16 or out_ptr % 16:
        return "word"
    if n > 1 and in_stride % 4:
        return "word"
    return "vec"


def relayout_interleave(v: torch.Tensor,
                        stack_rows: bool = False) -> torch.Tensor:
    """``out[..., l * X + x] = v[..., x, l]`` for ``v [..., X, L]``
    (``ref_interleave``, tools/exp_interleave.py:158). With ``stack_rows``
    the two dimensions before ``X`` merge, ``[G, S, R, X, L] ->
    [G, S * R, L * X]`` (``stack_rows_kernel`` :104); that is the same
    memory, so it costs nothing more.

    ``v`` may be a strided batch of contiguous ``[X, L]`` matrices, such as
    ``t[:, 0]`` of a contiguous ``[S, R, X, L]`` (the single-block
    constructs of tools/exp_mosaic_bisect.py:80-100)."""
    if _check(v, (2, 3, 4, 5), "v"):
        return relayout_interleave_reference(v, stack_rows)
    x, l = v.shape[-2:]
    batch = v.reshape(-1, x, l) if v.is_contiguous() else v
    if batch.dim() != 3 or batch.stride(2) != 1 or batch.stride(1) != l:
        raise ValueError("v must be contiguous, or a [N, X, L] batch of "
                         "contiguous matrices")
    n = batch.shape[0]
    out = torch.empty(_interleave_shape(v.shape, stack_rows),
                      dtype=torch.int32, device=v.device)
    in_stride = batch.stride(0) if n > 1 else x * l
    route = interleave_route(batch.data_ptr(), out.data_ptr(), n, x, l,
                             in_stride)
    _launch("compeg_relayout_interleave", "interleave", batch, out, n=n, x=x,
            l=l, in_stride=in_stride, vec=int(route == "vec"))
    return out


# -- P2: the assembly's minor swap and crop ----------------------------------

LANES = 128  # words per lane row of the JAX package's slab


def relayout_swap_crop_reference(slab: torch.Tensor, x: int, height: int,
                                 width: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`relayout_swap_crop`."""
    n_tr, rt, cols = slab.shape
    n_tc = _tile_columns(slab, x)
    z = slab.reshape(n_tr * rt, n_tc, x, LANES).transpose(2, 3)
    return z.reshape(n_tr * rt, cols)[:height, :width].contiguous()


def _tile_columns(slab: torch.Tensor, x: int) -> int:
    """n_tc of a slab whose rows hold whole ``[X, 128]`` tiles."""
    if x < 1 or slab.shape[2] % (x * LANES):
        raise ValueError(f"slab rows of {slab.shape[2]} words are no whole "
                         f"number of [{x}, {LANES}] tiles")
    return slab.shape[2] // (x * LANES)


def swap_crop_route(slab_ptr: int, out_ptr: int, x: int, width: int) -> str:
    """Which kernel :func:`relayout_swap_crop` takes, from its pointers
    (byte addresses), X and the kept width alone: ``"vec"``, the interleave's
    16-byte kernel with a pitched destination, or ``"word"``, the word tile.

    The vector kernel needs what the interleave's does (X in {4, 8, 16, 32},
    both pointers on a 16-byte boundary; the slab's rows of 128 words and
    tiles of ``X * 128`` are whole vectors), and output rows of whole
    vectors (``width % 4 == 0``), so that the crop drops whole vectors."""
    if x not in (4, 8, 16, 32) or slab_ptr % 16 or out_ptr % 16 or width % 4:
        return "word"
    return "vec"


def relayout_swap_crop(slab: torch.Tensor, x: int, height: int,
                       width: int) -> torch.Tensor:
    """The tiled slab ``[n_tr, RT, n_tc * X * 128]`` to the raster ``[H,
    W]``: ``out[r * RT + t, c * 128 * X + l * X + x] = slab[r, t, c * X * 128
    + x * 128 + l]``, cropped (``make_swap``, tools/exp_swap_pallas.py:35).
    The edge tiles are partial: slab rows past ``H`` and columns past ``W``
    are dropped in the same pass."""
    cpu = _check(slab, 3, "slab")
    n_tc = _tile_columns(slab, x)
    n_tr, rt, cols = slab.shape
    if not (0 < height <= n_tr * rt and 0 < width <= cols):
        raise ValueError(f"crop [{height}, {width}] outside the slab's "
                         f"[{n_tr * rt}, {cols}]")
    if cpu:
        return relayout_swap_crop_reference(slab, x, height, width)
    _contiguous(slab, "slab")
    out = torch.empty((height, width), dtype=torch.int32, device=slab.device)
    route = swap_crop_route(slab.data_ptr(), out.data_ptr(), x, width)
    _launch("compeg_relayout_swap_crop", "swap_crop", slab, out,
            n=n_tr * rt * n_tc, x=x, l=LANES, tiles=n_tc, h=height, w=width,
            vec=int(route == "vec"))
    return out


def swap_crop_inverse(img: torch.Tensor, x: int, rt: int) -> torch.Tensor:
    """The slab that :func:`relayout_swap_crop` turns into ``img`` (plain
    PyTorch; the rows and columns the crop drops are zero): what the tools
    build P2's input from, the port's decode having no slab of its own."""
    h, w = img.shape
    n_tr = -(-h // rt)
    n_tc = -(-w // (x * LANES))
    full = torch.zeros((n_tr * rt, n_tc * LANES * x), dtype=img.dtype,
                       device=img.device)
    full[:h, :w] = img
    z = full.reshape(n_tr * rt, n_tc, LANES, x).transpose(2, 3)
    return z.reshape(n_tr, rt, n_tc * x * LANES).contiguous()


# -- P3: sublane-stack slab store --------------------------------------------


def relayout_stack_reference(v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`relayout_stack`."""
    g, s, r, x, l = v.shape
    return v.permute(0, 3, 1, 2, 4).reshape(g, x, s * r, l).contiguous()


def relayout_stack(v: torch.Tensor) -> torch.Tensor:
    """``out[g, x, s * R + r, l] = v[g, s, r, x, l]``
    (``stack_epilogue_kernel``, tools/exp_assembly2.py:38, :110)."""
    if _check(v, 5, "v"):
        return relayout_stack_reference(v)
    _contiguous(v, "v")
    g, s, r, x, l = v.shape
    out = torch.empty((g, x, s * r, l), dtype=torch.int32, device=v.device)
    _launch("compeg_relayout_stack", "stack", v, out, g=g, sr=s * r, x=x, l=l)
    return out


# -- P4: lane spread, where-merge, copy --------------------------------------


def relayout_spread_merge_reference(a: torch.Tensor, b: torch.Tensor,
                                    x: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`relayout_spread_merge`."""
    out = b.repeat_interleave(x, dim=1)
    out[:, ::x] = a
    return out


def spread_merge_route(a_ptr: int, out_ptr: int, n: int, l: int, x: int,
                       in_stride: int) -> str:
    """Which kernel a spread, merge or copy takes, from its pointers (byte
    addresses), shape and row stride alone: ``"vec"``, the 16-byte kernels;
    for a copy (``x == 1``) they do not fit, ``"shift"``, the copy that
    shifts aligned 16-byte chunks of the input by each row's word offset;
    for a spread or merge they do not fit, ``"word"``, the word-per-thread
    kernel.

    The 16-byte kernels need an output that starts on a 16-byte boundary
    and holds whole 16-byte vectors: all of it when the input rows are
    contiguous (``n == 1`` or ``in_stride == l``: one long row), else each
    of its rows. The copy's also loads vectors, so its input must start on
    such a boundary too, with a row stride of whole vectors; a spread or
    merge reads single words."""
    flat = n == 1 or in_stride == l
    whole = (n * l * x) % 4 == 0 if flat else (l * x) % 4 == 0
    fallback = "shift" if x == 1 else "word"
    if out_ptr % 16 or not whole:
        return fallback
    if x == 1 and (a_ptr % 16 or (not flat and in_stride % 4)):
        return fallback
    return "vec"


def relayout_spread_merge(a: torch.Tensor, b: torch.Tensor,
                          x: int) -> torch.Tensor:
    """``out[s, l * X + k] = (a if k == 0 else b)[s, l]`` for two ``[S, L]``
    tensors of one shape and row stride (rows may be strided, elements not):
    the iota + where merge of two lane spreads, tools/exp_mosaic_bisect.py
    :60-70."""
    cpu = _check(a, 2, "a")
    _check(b, 2, "b")
    if a.shape != b.shape or a.device != b.device or x < 1:
        raise ValueError("a and b must share shape and device, and X >= 1")
    if cpu:
        return relayout_spread_merge_reference(a, b, x)
    s, l = a.shape
    if (a.stride(1), b.stride(1)) != (1, 1) or a.stride(0) != b.stride(0):
        raise ValueError("a and b need unit element stride and one row "
                         "stride")
    out = torch.empty((s, l * x), dtype=torch.int32, device=a.device)
    route = spread_merge_route(a.data_ptr(), out.data_ptr(), s, l, x,
                               a.stride(0))
    _launch("compeg_relayout_spread_merge",
            "copy_shift" if route == "shift" else "spread_merge", a, b, out,
            n=s, l=l, x=x, in_stride=a.stride(0), vec=int(route == "vec"))
    return out


def relayout_spread(a: torch.Tensor, x: int) -> torch.Tensor:
    """``out[s, l * X + k] = a[s, l]``: the X-fold lane spread
    (tools/exp_mosaic_bisect.py:41-57)."""
    return relayout_spread_merge(a, a, x)


def relayout_copy(a: torch.Tensor) -> torch.Tensor:
    """A copy of ``a`` (any shape with a contiguous last dimension and at
    most one strided row dimension): the store-bandwidth floor of the
    probes (``copy_kernel``, tools/exp_interleave.py:56)."""
    if a.dim() != 2:
        _contiguous(a, "a")
    rows = a if a.dim() == 2 else a.reshape(-1, a.shape[-1])
    return relayout_spread_merge(rows, rows, 1).reshape(a.shape)
