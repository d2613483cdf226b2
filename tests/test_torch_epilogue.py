"""The planes epilogue E (``ops/color.finalize_planes``, csrc/epilogue.cu) on
the CPU: its plain twin against the JAX package's ``finalize_planes``
(compeg_tpu/ops/fused.py:890, over the planes byte-packed as
``assemble_plane_tiled`` gives them), the batched and the halo forms against
the single frame and the whole frame, the wrapper's refusals, the params
struct against the C one, and the kernel's quad walk (``component_quad``
and the store of ``planes_epilogue_kernel``) run in numpy against the plain
twin. The kernel itself runs on the card (tests/test_torch_kernels.py,
``python3 chip_smoke.py``).

Planes are random u8 samples made with numpy from a seed, MCU-padded as K3
writes them. Tolerance 0 everywhere: every step is integer arithmetic."""

import ctypes
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from compeg_tpu.ops import fused as JF  # noqa: E402
from compeg_tpu_torch.ops import _build  # noqa: E402
from compeg_tpu_torch.ops import color as C  # noqa: E402

SAMPLINGS = {
    "444": ((1, 1), (1, 1), (1, 1)),
    "422": ((2, 1), (1, 1), (1, 1)),
    "420": ((2, 2), (1, 1), (1, 1)),
    "440": ((1, 2), (1, 1), (1, 1)),
    "411": ((4, 1), (1, 1), (1, 1)),
    "gray": ((1, 1),),
}
# (sampling, RGB-ID)
KINDS = [(s, False) for s in SAMPLINGS] + [("444", True)]


def padded_shapes(samplings, height, width):
    """Each component's MCU-padded plane, as K3 writes it."""
    max_h = max(h for h, _ in samplings)
    max_v = max(v for _, v in samplings)
    hm, wm = -(-height // (8 * max_v)), -(-width // (8 * max_h))
    return [(hm * 8 * v, wm * 8 * h) for h, v in samplings]


def random_planes(samplings, height, width, seed, batch=None):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    return [rng.integers(0, 256, lead + s, dtype=np.uint8)
            for s in padded_shapes(samplings, height, width)]


def port(planes, samplings, width, height, **kw):
    out = C.finalize_planes([torch.from_numpy(p) for p in planes], samplings,
                            width, height, **kw)
    return out.numpy().view(np.uint32)


@pytest.mark.parametrize("fancy", [False, True], ids=["nearest", "fancy"])
@pytest.mark.parametrize("height,width", [(17, 37), (18, 38), (24, 40)])
@pytest.mark.parametrize("kind,rgb", KINDS,
                         ids=[s + ("-rgbid" if r else "") for s, r in KINDS])
def test_plain_twin_equals_jax_finalize_planes(kind, rgb, height, width,
                                               fancy):
    samplings = SAMPLINGS[kind]
    planes = random_planes(samplings, height, width, seed=height * width)
    packed = tuple(jnp.asarray(np.ascontiguousarray(p).view("<u4"))
                   for p in planes)
    want = np.asarray(JF.finalize_planes(packed, samplings, width, height,
                                         fancy=fancy, rgb=rgb))
    got = port(planes, samplings, width, height, fancy=fancy, rgb=rgb)
    assert got.shape == (height, width)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("fancy", [False, True], ids=["nearest", "fancy"])
@pytest.mark.parametrize("kind", ["420", "422", "440", "gray"])
def test_batched_equals_frames_stacked(kind, fancy):
    """A batch ``[B, Hc, Wc]`` is each frame on its own: the vertical filter
    never reads a neighbouring frame's rows."""
    samplings = SAMPLINGS[kind]
    planes = random_planes(samplings, 18, 38, seed=7, batch=3)
    got = port(planes, samplings, 38, 18, fancy=fancy)
    assert got.shape == (3, 18, 38)
    for f in range(3):
        one = port([p[f] for p in planes], samplings, 38, 18, fancy=fancy)
        assert np.array_equal(got[f], one), f


def band(planes, samplings, lo, hi, junk_rows=0, batch=False):
    """The planes of the band of chroma rows [lo, hi) of ``planes`` (4:2:0),
    with ``junk_rows`` rows of noise under it, and its halos as
    ``exchange_halos`` gives them: the row above and the row below where
    the content runs on, else ``valid``, the band's content rows."""
    rng = np.random.default_rng(lo * 31 + hi)
    out, halos = [], []
    for p, (_, v) in zip(planes, samplings):
        rows = p[..., lo * v:hi * v, :]
        if junk_rows:
            extra = rng.integers(0, 256, rows.shape[:-2] + (junk_rows * v,
                                 rows.shape[-1]), dtype=np.uint8)
            rows = np.concatenate([rows, extra], axis=-2)
        out.append(torch.from_numpy(np.ascontiguousarray(rows)))
        if v == 2:
            halos.append(None)
            continue
        n = p.shape[-2]
        above = (torch.from_numpy(np.ascontiguousarray(p[..., lo - 1, :]))
                 if lo > 0 else None)
        below = (torch.from_numpy(np.ascontiguousarray(p[..., hi, :]))
                 if hi < n and not junk_rows else None)
        halos.append((above, below, hi - lo if junk_rows else None))
    return out, halos


@pytest.mark.parametrize("batch", [False, True], ids=["frame", "batch"])
@pytest.mark.parametrize("lo,hi,junk", [(0, 5, 0), (5, 11, 0), (11, 16, 0),
                                        (11, 16, 3)],
                         ids=["first", "middle", "last", "last-valid"])
def test_halo_form_equals_the_whole_frame_rows(lo, hi, junk, batch):
    """A band of a 4:2:0 frame, with the chroma rows above and below it (or
    ``valid`` where the content ends inside it and rows of noise follow),
    gives the whole frame's output rows of that band."""
    samplings = SAMPLINGS["420"]
    planes = random_planes(samplings, 32, 45, seed=3,
                           batch=2 if batch else None)
    whole = port(planes, samplings, 45, 32, fancy=True)
    parts, halos = band(planes, samplings, lo, hi, junk, batch)
    rows = 2 * (hi - lo + junk)
    got = C.finalize_planes(parts, samplings, 45, rows, fancy=True,
                            halos=halos).numpy().view(np.uint32)
    assert np.array_equal(got[..., :2 * (hi - lo), :],
                          whole[..., 2 * lo:2 * hi, :])
    if junk:  # without valid the noise bleeds into the last content row
        bled = C.finalize_planes(parts, samplings, 45, rows, fancy=True,
                                 halos=[h and (h[0], None, None)
                                        for h in halos])
        assert not np.array_equal(
            bled.numpy().view(np.uint32)[..., :2 * (hi - lo), :],
            whole[..., 2 * lo:2 * hi, :])


def _bad_inputs():
    s = SAMPLINGS["420"]
    y, cb, cr = (torch.from_numpy(p) for p in random_planes(s, 16, 32, 1))
    yb, cbb, crb = (torch.from_numpy(p)
                    for p in random_planes(s, 16, 32, 1, batch=2))
    row = torch.zeros(16, dtype=torch.uint8)
    return {
        "dtype": ([y.int(), cb, cr], s, None),
        "non-contiguous": ([y, cb.t().contiguous().t(), cr], s, None),
        "batch sizes": ([yb, cbb, crb[:1]], s, None),
        "batch and frame": ([yb, cb, cr], s, None),
        "halo shape": ([y, cb, cr], s,
                       [None, (torch.zeros(17, dtype=torch.uint8), None,
                               None), None]),
        "halo of a batch": ([yb, cbb, crb], s,
                            [None, (row, None, None), None]),
        "halo dtype": ([y, cb, cr], s, [None, (row.int(), None, None), None]),
        "valid": ([y, cb, cr], s, [None, (None, None, 9), None]),
        "samplings": ([y, cb, cr], s[:2], None),
        "two planes": ([y, cb], s[:2], None),
        "plane shape": ([y, cb[:4], cr], s, None),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_refuses(case):
    planes, samplings, halos = _bad_inputs()[case]
    with pytest.raises(ValueError):
        C.finalize_planes(planes, samplings, 32, 16, fancy=True, halos=halos)


def test_wrapper_refuses_an_output_larger_than_the_planes():
    planes = [torch.from_numpy(p) for p in random_planes(SAMPLINGS["422"],
                                                         16, 32, 2)]
    with pytest.raises(ValueError):
        C.finalize_planes(planes, SAMPLINGS["422"], 33, 16)


def test_epilogue_params_mirror_the_c_struct():
    """The ctypes block lists csrc/epilogue.cu's struct fields in order, all
    int32, and the launch is counted under its own key."""
    with open(os.path.join(_build.CSRC, "epilogue.cu")) as f:
        body = re.search(r"struct EpilogueParams \{(.*?)\};", f.read(),
                         re.S)[1]
    c_fields = re.findall(r"^\s*int (\w+)(?:\[(\d+)\])?;", body, re.M)
    py_fields = [(n, getattr(t, "_length_", 1)) for n, t in
                 _build.EpilogueParams._fields_]
    assert [(n, int(k or 1)) for n, k in c_fields] == py_fields
    assert all((t._type_ if issubclass(t, ctypes.Array) else t)
               is ctypes.c_int32 for _, t in _build.EpilogueParams._fields_)
    assert _build.ENTRY_POINTS["compeg_planes_epilogue"] == 10
    assert "epilogue" in _build.LAUNCHES


# ---------------------------------------------------------------------------
# The kernel's walk in numpy: component_quad and the quad store of
# csrc/epilogue.cu, line for line (change both together).
# ---------------------------------------------------------------------------


def kernel_walk(planes, samplings, width, height, fancy, rgb, halos=None):
    """What planes_epilogue_kernel writes, thread by thread: each (frame,
    row, quad) reads the bytes component_quad reads and stores the quad's
    pixels left of ``width``."""
    planes = [p if p.ndim == 3 else p[None] for p in planes]
    frames = planes[0].shape[0]
    max_h = max(h for h, _ in samplings)
    max_v = max(v for _, v in samplings)
    halos = halos or [None] * len(planes)
    out = np.zeros((frames, height, width), np.uint32)

    def quad(c, f, Y, X0):
        p = planes[c][f]
        H, W = p.shape
        fx, fy = max_h // samplings[c][0], max_v // samplings[c][1]
        above, below, valid = halos[c] or (None, None, None)
        above = None if above is None else above.reshape(frames, W)[f]
        below = None if below is None else below.reshape(frames, W)[f]
        r = Y >> 1 if fy == 2 else Y
        row = p[r].astype(int)
        filt = fancy and fy == 2
        nb, bias = row, 0
        if filt:
            if Y & 1:
                limit = H if valid is None else valid - 1
                nb = (row if r >= limit else p[r + 1].astype(int)
                      if r + 1 < H else row if below is None
                      else below.astype(int))
                bias = 2
            else:
                nb = (p[r - 1].astype(int) if r > 0 else row
                      if above is None else above.astype(int))
                bias = 1

        def vert(x):
            return (3 * row[x] + nb[x] + bias) >> 2 if filt else row[x]

        if fx == 1:
            return [vert(min(X0 + j, W - 1)) for j in range(4)]
        if fx == 2:
            x = X0 >> 1
            m0, m1 = vert(x), vert(min(x + 1, W - 1))
            if not fancy:
                return [m0, m0, m1, m1]
            left, right = vert(max(x - 1, 0)), vert(min(x + 2, W - 1))
            return [(3 * m0 + left + 1) >> 2, (3 * m0 + m1 + 2) >> 2,
                    (3 * m1 + m0 + 1) >> 2, (3 * m1 + right + 2) >> 2]
        return [vert(min(X0 >> 2, W - 1))] * 4

    def rgba(y, c1, c2):
        if len(planes) == 1:
            r = g = b = y
        elif rgb:
            r, g, b = y, c1, c2
        else:
            cb, cr = c1 - 128, c2 - 128
            r = y + ((45 * cr) >> 5)
            g = y - ((11 * cb + 23 * cr) >> 5)
            b = y + ((113 * cb) >> 6)
        r, g, b = (min(max(t, 0), 255) for t in (r, g, b))
        return r | g << 8 | b << 16 | 0xFF << 24

    for f in range(frames):
        for Y in range(height):
            for X0 in range(0, width, 4):
                s = [quad(c, f, Y, X0) for c in range(len(planes))]
                for j in range(4):
                    if X0 + j < width:
                        out[f, Y, X0 + j] = rgba(
                            s[0][j], *((0, 0) if len(s) == 1
                                       else (s[1][j], s[2][j])))
    return out


@pytest.mark.parametrize("fancy", [False, True], ids=["nearest", "fancy"])
@pytest.mark.parametrize("kind,rgb", KINDS,
                         ids=[s + ("-rgbid" if r else "") for s, r in KINDS])
def test_kernel_walk_equals_the_plain_twin(kind, rgb, fancy):
    """The quad walk of csrc/epilogue.cu, at 18 x 38 (a width no multiple
    of 4, the padded edge one chroma column past the image) and over a
    batch of two frames, equals the plain twin."""
    samplings = SAMPLINGS[kind]
    planes = random_planes(samplings, 18, 38, seed=11, batch=2)
    want = port(planes, samplings, 38, 18, fancy=fancy, rgb=rgb)
    assert np.array_equal(kernel_walk(planes, samplings, 38, 18, fancy, rgb),
                          want)


@pytest.mark.parametrize("lo,hi,junk", [(0, 5, 0), (5, 11, 0), (11, 16, 3)],
                         ids=["first", "middle", "last-valid"])
def test_kernel_walk_with_halos(lo, hi, junk):
    """The walk over a band's planes with its halo rows and ``valid``
    equals the plain twin's halo form."""
    samplings = SAMPLINGS["420"]
    planes = random_planes(samplings, 32, 45, seed=3, batch=2)
    parts, halos = band(planes, samplings, lo, hi, junk, True)
    rows = 2 * (hi - lo + junk)
    want = C.finalize_planes(parts, samplings, 45, rows, fancy=True,
                             halos=halos).numpy().view(np.uint32)
    got = kernel_walk([p.numpy() for p in parts], samplings, 45, rows, True,
                      False, [h and (None if h[0] is None else h[0].numpy(),
                                     None if h[1] is None else h[1].numpy(),
                                     h[2]) for h in halos])
    assert np.array_equal(got, want)
