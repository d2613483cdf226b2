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
# The kernel's walk in numpy: planes_epilogue_kernel, component_strip,
# load_samples, blend and the store of csrc/epilogue.cu, line for line
# (change both together), with its constants read from the source.
# ---------------------------------------------------------------------------


def kernel_constants():
    with open(os.path.join(_build.CSRC, "epilogue.cu")) as f:
        text = f.read()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", text)[1])
            for name in ("EP_STRIP", "EP_WARPS")}


def byte_perm(x, y, sel):
    """CUDA's __byte_perm for selectors of nibbles 0-7."""
    b = (x | y << 32).to_bytes(8, "little")
    return sum(b[sel >> 4 * i & 7] << 8 * i for i in range(4))


LANES16 = 0x00FF00FF


def blend(near, far, bias):
    """blend: (3 * near + far + bias) >> 2 in each byte, two bytes to a
    16-bit lane."""
    k = bias * 0x10001
    lo = ((near & LANES16) * 3 + (far & LANES16) + k) >> 2
    hi = ((near >> 8 & LANES16) * 3 + (far >> 8 & LANES16) + k) >> 2
    return (lo & LANES16) | (hi & LANES16) << 8


def blend16(near, far, bias):
    """blend16: the same in the two 16-bit lanes of a word."""
    return (near * 3 + far + bias * 0x10001) >> 2 & LANES16


def viaddmin_s16x2_relu(a, b, c):
    """CUDA's __viaddmin_s16x2_relu: max(min(a + b, c), 0) in each signed
    16-bit lane."""
    out = 0
    for i in (0, 1):
        lane = [(x >> 16 * i & 0xFFFF) for x in (a, b, c)]
        x, y, z = (v - 0x10000 if v & 0x8000 else v for v in lane)
        out |= (max(min(x + y, z), 0) & 0xFFFF) << 16 * i
    return out


def rgba_quad(gray, rgb, y, c1, c2):
    """rgba_quad: a quad's RGBA words from its samples as (lo, hi) words of
    16-bit lanes (pixels 0 and 2, 1 and 3); in csrc/color.cuh."""
    top = 0x00FF00FF
    w = [[0, 0], [0, 0]]
    for h in (0, 1):
        yy = y[h]
        r = g = b = yy
        if not gray:
            u, v = c1[h], c2[h]
            if rgb:
                g, b = u, v
            else:
                rt = (v * 45) >> 5 & 0x01FF01FF
                gt = (u * 11 + v * 23) >> 5 & 0x01FF01FF
                bt = (u * 113) >> 6 & 0x01FF01FF
                r = viaddmin_s16x2_relu(yy + rt, 0xFF4CFF4C, top)
                g = viaddmin_s16x2_relu((yy + 0x02880288 - gt) & 0xFFFFFFFF,
                                        0xFE00FE00, top)
                b = viaddmin_s16x2_relu(yy + bt, 0xFF1EFF1E, top)
        rg, ba = r | g << 8, b | 0xFF00FF00
        w[h] = [byte_perm(rg, ba, 0x5410), byte_perm(rg, ba, 0x7632)]
    return [w[0][0], w[1][0], w[0][1], w[1][1]]


class Memory:
    """The kernel's tensors as byte buffers with their addresses' offsets
    from a 16-byte boundary; a pointer is ``(buffer, offset)``. Every read
    is checked to lie inside its buffer; the walk counts its routes."""

    def __init__(self):
        self.buf, self.bases, self.routes = {}, {}, {}

    def add(self, name, array):
        self.buf[name] = np.ascontiguousarray(array).reshape(-1)

    def count(self, route):
        self.routes[route] = self.routes.get(route, 0) + 1

    def byte(self, ptr, x):
        name, off = ptr
        assert 0 <= off + x < self.buf[name].size, (name, off, x)
        return int(self.buf[name][off + x])


def kernel_walk(planes, samplings, width, height, fancy, rgb, halos=None,
                bases=None, memory=None):
    """What planes_epilogue_kernel writes, block by block and lane by lane:
    the grid's x the warps along the rows, y the strips of EP_STRIP rows
    (EP_WARPS a block), z the frames; each lane a quad down its strip (a
    lane past the row's end the quad past it, storing nothing), its
    component samples as component_strip finds them (the strip's rows and
    the rows above and below it loaded once, far rows from the window,
    neighbours from the lanes beside it or the edge lanes' own column),
    converted by rgba_quad and stored as a 16-byte vector or word by word
    left of ``width``. ``bases`` puts a
    tensor's address that many bytes past a 16-byte boundary; ``memory``
    (a :class:`Memory`) collects the routes taken. Every pixel must be
    written exactly once."""
    consts = kernel_constants()
    strip, warps_per_block = consts["EP_STRIP"], consts["EP_WARPS"]
    planes = [p if p.ndim == 3 else p[None] for p in planes]
    frames = planes[0].shape[0]
    max_h = max(h for h, _ in samplings)
    max_v = max(v for _, v in samplings)
    factors = [(max_h // h, max_v // v) for h, v in samplings]
    halos = halos or [None] * len(planes)
    mem = memory if memory is not None else Memory()
    mem.bases = bases or {}
    valid = []
    for c, p in enumerate(planes):
        mem.add(("plane", c), p)
        above, below, v = halos[c] or (None, None, None)
        for name, h in (("above", above), ("below", below)):
            if h is not None:
                mem.add((name, c), h.reshape(frames, -1))
        valid.append(-1 if v is None else v)
    out = np.zeros((frames, height, width), np.uint32)
    writes = np.zeros((frames, height, width), np.int64)

    def component_strip(c, f, Y0, lanes, stores):
        """component_any and component_strip for the 32 lanes of a warp:
        s[lane][k] as (lo, hi)."""
        fx, fy = factors[c]
        n, rows_p = 4 // fx, strip // fy
        H, W = planes[c].shape[1:]
        plane = (("plane", c), f * H * W)
        filt = fy == 2 and fancy
        nb = fx == 2 and fancy
        r0 = Y0 // fy
        # component_any: __all_sync, every row's samples of the warp's quads
        # inside the row and aligned
        quads = (width + 3) // 4
        xs = [X0 // fx for X0 in lanes]
        wide = (all(X0 // 4 >= quads or x0 + n <= W
                    for X0, x0 in zip(lanes, xs))
                and W % n == 0
                and (mem.bases.get(plane[0], 0) + plane[1]) % n == 0)
        mem.count("strip wide" if wide else "strip bytewise")

        def load(row, x0, wide_row):
            if wide_row:
                assert x0 + n <= W and (mem.bases.get(row[0], 0)
                                        + row[1] + x0) % n == 0
                mem.count(f"load {n}")
                return sum(mem.byte(row, x0 + j) << 8 * j for j in range(n))
            mem.count(f"load {n} bytewise")
            return sum(mem.byte(row, min(x0 + j, W - 1)) << 8 * j
                       for j in range(n))

        ms, ems = [], []
        for lane, x0 in enumerate(xs):
            xl = min(x0, W - n) if wide else x0  # loaded from
            ecol = min(max(x0 - 1 if lane == 0 else x0 + 2, 0), W - 1)
            edge = nb and ((lane == 0 and x0 > 0) or lane == 31)
            rows = [(plane[0], plane[1] + min(r0 + j, H - 1) * W)
                    for j in range(rows_p)]
            v = [load(row, xl, wide) for row in rows]
            e = [mem.byte(row, ecol) if edge else 0 for row in rows]
            if edge:
                mem.count("edge column")
            up = dn = eup = edn = 0
            limit = rlast = 0
            if filt:
                limit = H if valid[c] < 0 else valid[c] - 1
                rlast = min(r0 + rows_p - 1, H - 1)
                first = (plane[0], plane[1] + r0 * W)
                last = (plane[0], plane[1] + rlast * W)
                above = ((first[0], first[1] - W) if r0 > 0
                         else (("above", c), f * W)
                         if ("above", c) in mem.buf else first)
                below = ((last[0], last[1] + W) if rlast + 1 < H
                         else (("below", c), f * W)
                         if ("below", c) in mem.buf else last)
                mem.count(f"up from {above[0][0]}")
                mem.count(f"down from {below[0][0]}")
                halo_wide = all((mem.bases.get(r[0], 0) + r[1]) % n == 0
                                for r in (above, below))
                up = load(above, xl, wide and halo_wide)
                dn = load(below, xl, wide and halo_wide)
                if edge:
                    eup, edn = mem.byte(above, ecol), mem.byte(below, ecol)
            m_k, em_k = [], []
            for k in range(strip):
                j = k // fy
                bias = 1 + (k & 1)
                m, em = v[j], e[j]
                if filt:
                    r = r0 + j
                    if k & 1:
                        self_, inside = r >= limit, r < rlast
                        fv = v[j] if self_ else v[j + 1] if inside else dn
                        fe = e[j] if self_ else e[j + 1] if inside else edn
                        if stores[lane] and Y0 + k < height:
                            mem.count("far: the row itself" if self_ else
                                      "far: the window" if inside
                                      else "far: the row below")
                    else:
                        fv = up if j == 0 else v[j - 1]
                        fe = eup if j == 0 else e[j - 1]
                        if stores[lane] and Y0 + k < height:
                            mem.count("far: the row above" if j == 0
                                      else "far: the window")
                    m = blend(v[j], fv, bias)
                    em = (3 * e[j] + fe + bias) >> 2
                m_k.append(m)
                em_k.append(em)
            ms.append(m_k)
            ems.append(em_k)
        s = [[None] * strip for _ in lanes]
        for k in range(strip):
            for lane, x0 in enumerate(xs):
                m = ms[lane][k]
                if fx == 1:
                    s[lane][k] = (m & LANES16, m >> 8 & LANES16)
                elif fx == 4:
                    s[lane][k] = (m * 0x10001,) * 2
                elif not nb:
                    s[lane][k] = (byte_perm(m, 0, 0x4140),) * 2
                else:
                    # __shfl_up_sync / __shfl_down_sync: a lane at the
                    # warp's edge gets its own value.
                    lt = ms[max(lane - 1, 0)][k] >> 8 & 0xFF
                    rt = ms[min(lane + 1, 31)][k] & 0xFF
                    if lane == 0:
                        lt = ems[lane][k] if x0 > 0 else m & 0xFF
                    if lane == 31:
                        rt = ems[lane][k]
                    if x0 + 2 >= W:
                        rt = m >> 8 & 0xFF
                    pair = byte_perm(m, 0, 0x4140)
                    s[lane][k] = (blend16(pair, byte_perm(m, lt, 0x2024), 1),
                                  blend16(pair, byte_perm(m, rt, 0x2421), 2))
        return s

    quads = (width + 3) // 4
    rows_per_block = warps_per_block * strip
    vector = width % 4 == 0 and mem.bases.get("out", 0) % 16 == 0
    gray = len(planes) == 1
    for f in range(frames):
        for by in range(-(-height // rows_per_block)):
            for ty in range(warps_per_block):
                Y0 = (by * warps_per_block + ty) * strip
                if Y0 >= height:
                    continue
                for bx in range(-(-quads // 32)):
                    qs = [bx * 32 + lane for lane in range(32)]
                    lanes = [q * 4 for q in qs]
                    stores = [q < quads for q in qs]
                    s = [component_strip(c, f, Y0, lanes, stores)
                         for c in range(len(planes))]
                    for lane, X0 in enumerate(lanes):
                        if not stores[lane]:
                            continue
                        for k in range(strip):
                            Y = Y0 + k
                            if Y >= height:
                                break
                            px = rgba_quad(gray, rgb, s[0][lane][k],
                                           s[0 if gray else 1][lane][k],
                                           s[0 if gray else 2][lane][k])
                            mem.count("store vector" if vector
                                      else "store words")
                            for j in range(4):
                                if vector or X0 + j < width:
                                    out[f, Y, X0 + j] = px[j]
                                    writes[f, Y, X0 + j] += 1
    assert (writes == 1).all(), "a pixel written other than once"
    return out


def test_walk_constants_are_the_kernels():
    """Every selector, mask and folded constant the walk mirrors appears in
    csrc/epilogue.cu or the colour rule it takes from csrc/color.cuh (so an
    edit of one without the other shows here)."""
    text = ""
    for name in ("epilogue.cu", "color.cuh"):
        with open(os.path.join(_build.CSRC, name)) as f:
            text += f.read()
    for const in ("0x4140", "0x2024", "0x2421", "0x5410", "0x7632",
                  "0x00FF00FFu", "0x01FF01FFu", "0xFF4CFF4Cu", "0x02880288u",
                  "0xFE00FE00u", "0xFF1EFF1Eu", "0xFF00FF00u", "0x10001u",
                  "v * 45u", "u * 11u + v * 23u", "u * 113u"):
        assert const in text, const


def test_blend_is_the_filter_in_every_byte():
    """blend's two bytes to a 16-bit lane and blend16's lanes give
    (3 * near + far + bias) >> 2 for every pair of samples."""
    a, b = np.meshgrid(np.arange(256, dtype=np.int64),
                       np.arange(256, dtype=np.int64))
    a, b = a.ravel(), b.ravel()
    for bias in (1, 2):
        want = (3 * a + b + bias) >> 2
        k = bias * 0x10001
        near = a | a << 8 | a << 16 | a << 24
        far = b | b << 8 | b << 16 | b << 24
        lo = ((near & LANES16) * 3 + (far & LANES16) + k) >> 2
        hi = ((near >> 8 & LANES16) * 3 + (far >> 8 & LANES16) + k) >> 2
        word = (lo & LANES16) | (hi & LANES16) << 8
        for pos in range(4):
            assert np.array_equal(word >> 8 * pos & 0xFF, want)
        lanes = ((a | a << 16) * 3 + (b | b << 16) + k) >> 2 & LANES16
        assert np.array_equal(lanes & 0xFFFF, want)
        assert np.array_equal(lanes >> 16, want)
    # the scalar mirrors on a few words against the vectorised check
    for x, y in ((0x01FF7F00, 0xFF0080FE), (0xFFFFFFFF, 0), (0, 0xFFFFFFFF)):
        for bias in (1, 2):
            got = blend(x, y, bias)
            assert all((got >> 8 * i & 0xFF) == (3 * (x >> 8 * i & 0xFF)
                       + (y >> 8 * i & 0xFF) + bias) >> 2 for i in range(4))


def test_rgba_quad_is_bt601_for_every_sample():
    """csrc/color.cuh rgba_quad's two pixels to a word (the terms' constants
    folded so that every lane stays non-negative, one add-min-relu per
    channel) equals the integer BT.601 of rgba_pixel beside it for every
    (y, cb, cr), in the low and the high lane, vectorised the way rgba_quad
    computes."""
    c1, c2 = np.meshgrid(np.arange(256, dtype=np.int64),
                         np.arange(256, dtype=np.int64))
    c1, c2 = c1.ravel(), c2.ravel()

    def dpx(a, b):  # viaddmin_s16x2_relu(a, b, 255 | 255 << 16), vectorised
        out = np.zeros_like(a)
        for i in (0, 1):
            x, y = (v >> 16 * i & 0xFFFF for v in (a, b))
            x, y = (np.where(v & 0x8000, v - 0x10000, v) for v in (x, y))
            out |= (np.clip(x + y, 0, 255) & 0xFFFF) << 16 * i
        return out

    for y in range(256):
        # lane 0 the sample (y, c1, c2), lane 1 (255 - y, c2, c1)
        yy = y | (255 - y) << 16
        u, v = c1 | c2 << 16, c2 | c1 << 16
        rt = (v * 45) >> 5 & 0x01FF01FF
        gt = (u * 11 + v * 23) >> 5 & 0x01FF01FF
        bt = (u * 113) >> 6 & 0x01FF01FF
        r = dpx(yy + rt, 0xFF4CFF4C)
        g = dpx((yy + 0x02880288 - gt) & 0xFFFFFFFF, 0xFE00FE00)
        b = dpx(yy + bt, 0xFF1EFF1E)
        for lane, (ly, lu, lv) in enumerate(((y, c1, c2), (255 - y, c2, c1))):
            cb, cr = lu - 128, lv - 128
            want = [np.clip(ly + ((45 * cr) >> 5), 0, 255),
                    np.clip(ly - ((11 * cb + 23 * cr) >> 5), 0, 255),
                    np.clip(ly + ((113 * cb) >> 6), 0, 255)]
            for got, w in zip((r, g, b), want):
                assert np.array_equal(got >> 16 * lane & 0xFFFF, w), y
    # the scalar mirror (lo and hi words) on a few quads
    for ys, us, vs in (((0, 255, 17, 200), (128, 0, 255, 3),
                        (255, 128, 0, 77)),):
        lo = lambda t: t[0] | t[2] << 16  # noqa: E731
        hi = lambda t: t[1] | t[3] << 16  # noqa: E731
        px = rgba_quad(False, False, (lo(ys), hi(ys)), (lo(us), hi(us)),
                       (lo(vs), hi(vs)))
        for j in range(4):
            cb, cr = us[j] - 128, vs[j] - 128
            rgb_ = [min(max(t, 0), 255) for t in (
                ys[j] + ((45 * cr) >> 5), ys[j] - ((11 * cb + 23 * cr) >> 5),
                ys[j] + ((113 * cb) >> 6))]
            assert px[j] == rgb_[0] | rgb_[1] << 8 | rgb_[2] << 16 | 0xFF << 24


def walk_equals_twin(planes, samplings, width, height, fancy, rgb=False,
                     halos=None, bases=None):
    """The walk over numpy planes (and halos as numpy or torch) against the
    plain twin; returns the walk's Memory for its routes."""
    tp = [torch.from_numpy(np.ascontiguousarray(p)) for p in planes]
    th = None if halos is None else [
        h and tuple(None if x is None or isinstance(x, int)
                    else torch.as_tensor(np.asarray(x)) for x in h[:2])
        + (h[2],) for h in halos]
    want = C.finalize_planes(tp, samplings, width, height, fancy=fancy,
                             rgb=rgb, halos=th).numpy().view(np.uint32)
    nh = None if halos is None else [
        h and tuple(None if x is None else np.asarray(x) for x in h[:2])
        + (h[2],) for h in halos]
    mem = Memory()
    got = kernel_walk([np.asarray(p) for p in planes], samplings, width,
                      height, fancy, rgb, nh, bases, mem)
    assert np.array_equal(got.reshape(want.shape), want)
    return mem


@pytest.mark.parametrize("fancy", [False, True], ids=["nearest", "fancy"])
@pytest.mark.parametrize("kind,rgb", KINDS,
                         ids=[s + ("-rgbid" if r else "") for s, r in KINDS])
def test_kernel_walk_equals_the_plain_twin(kind, rgb, fancy):
    """The walk of csrc/epilogue.cu, at 18 x 38 (a width no multiple of 4,
    the padded edge one chroma column past the image) and over a batch of
    two frames, equals the plain twin."""
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


@pytest.mark.parametrize("kind", ["422", "420", "444", "411"])
@pytest.mark.parametrize("width", [33, 37, 42, 44])
def test_kernel_walk_at_widths_no_multiple_of_16(kind, width):
    """Rows whose last quad is cut (33, 37, 42) or whole but not a 16-pixel
    run (44): the last lane stores word by word left of the width, or the
    whole quad, and loads its right neighbour clamped to the plane."""
    samplings = SAMPLINGS[kind]
    planes = random_planes(samplings, 6, width, seed=width)
    for fancy in (False, True):
        mem = walk_equals_twin(planes, samplings, width, 6, fancy)
        assert mem.routes.get("store vector" if width % 4 == 0
                              else "store words", 0) > 0


@pytest.mark.parametrize("kind", ["422", "420"])
@pytest.mark.parametrize("width", [200, 208])
def test_kernel_walk_with_a_warp_edge_inside_a_row(kind, width):
    """Rows of 50 or 52 quads: the second warp of a row starts at quad 32,
    inside the chroma of the row, so the first warp's last lane and the
    second warp's first lane load the columns of the neighbours x0 + 2 and
    x0 - 1 that the lanes beside them would have shuffled in; the lanes
    past the row's end load inside the plane (the first of them the last
    quad's right neighbour, where the plane runs on to 104 columns; at 208
    pixels the plane ends at the last quad, which takes its own sample), so
    every warp keeps the wide loads."""
    samplings = SAMPLINGS[kind]
    planes = random_planes(samplings, 12, width, seed=5)
    mem = walk_equals_twin(planes, samplings, width, 12, True)
    assert mem.routes["edge column"] > 0
    assert "strip bytewise" not in mem.routes, mem.routes
    assert "load 2 bytewise" not in mem.routes


@pytest.mark.parametrize("kind", ["420", "422"])
def test_kernel_walk_with_chroma_rows_8_mod_16(kind):
    """Chroma planes 72 bytes wide (a 144-pixel frame), so every other
    chroma row starts 8 bytes past a 16-byte boundary: the chroma loads stay
    whole half-words."""
    samplings = SAMPLINGS[kind]
    planes = random_planes(samplings, 16, 144, seed=8)
    assert planes[1].shape[1] % 16 == 8
    for fancy in (False, True):
        mem = walk_equals_twin(planes, samplings, 144, 16, fancy)
        assert mem.routes["load 2"] > 0
        assert not any("bytewise" in r for r in mem.routes), mem.routes


def test_kernel_walk_from_planes_off_a_word():
    """Planes 3, 1 and 2 bytes past a 16-byte boundary and the output a
    word past one: the loads go byte by byte and the stores word by word."""
    samplings = SAMPLINGS["420"]
    planes = random_planes(samplings, 18, 38, seed=4)
    bases = {("plane", 0): 3, ("plane", 1): 1, ("plane", 2): 2, "out": 4}
    for fancy in (False, True):
        mem = walk_equals_twin(planes, samplings, 38, 18, fancy,
                               bases=bases)
        assert mem.routes.get("load 4 bytewise", 0) > 0
        assert mem.routes.get("load 2 bytewise", 0) > 0
        assert mem.routes.get("store words", 0) > 0
        assert "store vector" not in mem.routes


@pytest.mark.parametrize("valid", [1, 2, 3, 4, 5])
def test_kernel_walk_row_window_across_valid_and_halos(valid):
    """A 4:2:0 band of 5 chroma rows (strips of 2 chroma rows) with halo
    rows above and below, its content edge ``valid`` moved through the
    strips, and the same band without it: the far rows come from the
    window, the row itself, the row above or below the strip, the halos,
    and equal the twin."""
    samplings = SAMPLINGS["420"]
    planes = random_planes(samplings, 20, 45, seed=valid, batch=2)
    n = planes[1].shape[-2]
    rng = np.random.default_rng(valid)
    halos = [None] + [(rng.integers(0, 256, (2, p.shape[-1]), np.uint8),
                       rng.integers(0, 256, (2, p.shape[-1]), np.uint8),
                       valid) for p in planes[1:]]
    mem = walk_equals_twin(planes, samplings, 45, 2 * n, True, halos=halos)
    for route in ("far: the window", "far: the row itself",
                  "far: the row above", "up from above"):
        assert mem.routes.get(route, 0) > 0, (route, mem.routes)
    mem = walk_equals_twin(planes, samplings, 45, 2 * n, True,
                           halos=[h and (h[0], h[1], None) for h in halos])
    for route in ("far: the row below", "down from below"):
        assert mem.routes.get(route, 0) > 0, (route, mem.routes)


@pytest.mark.parametrize("kind", ["420", "422", "gray"])
def test_kernel_walk_over_a_batch(kind):
    """Three frames of 21 rows (the last strip cut) in one walk: each
    frame's rows read only its own planes."""
    samplings = SAMPLINGS[kind]
    planes = random_planes(samplings, 21, 30, seed=9, batch=3)
    for fancy in (False, True):
        walk_equals_twin(planes, samplings, 30, 21, fancy)


@pytest.mark.parametrize("samplings", [((1, 1), (2, 1), (1, 2)),
                                       ((1, 2), (2, 2), (1, 1)),
                                       ((2, 2), (1, 1), (2, 1)),
                                       ((4, 2), (1, 1), (1, 1))],
                         ids=["y-upsampled", "y-across", "mixed", "410"])
def test_kernel_walk_with_factors_from_the_parameters(samplings):
    """The kernel takes each component's factors from the parameters, so
    samplings beyond the common ones walk as theirs do: luma upsampled, the
    two chroma planes upsampled differently, 4:1:0 (4 across, 2 down)."""
    planes = random_planes(samplings, 20, 44, seed=12)
    for fancy in (False, True):
        walk_equals_twin(planes, samplings, 44, 20, fancy)


# ---------------------------------------------------------------------------
# The kernel itself, on the card (skips without one): E against its plain
# twin on the same planes, every sampling the wrapper takes.
# ---------------------------------------------------------------------------

CARD_SAMPLINGS = dict(SAMPLINGS, **{
    "y-upsampled": ((1, 1), (2, 1), (1, 2)),
    "y-across": ((1, 2), (2, 2), (1, 1)),
    "mixed": ((2, 2), (1, 1), (2, 1)),
    "410": ((4, 2), (1, 1), (1, 1))})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the planes epilogue E has no CPU "
                    "mode")
    return torch.device("cuda")


def off_a_word(p):
    """``p`` copied into a buffer 3 bytes past a word boundary."""
    buf = torch.zeros(p.numel() + 8, dtype=torch.uint8, device=p.device)
    at = (-buf.data_ptr()) % 4 + 3
    return buf[at:at + p.numel()].view(p.shape).copy_(p)


@pytest.mark.parametrize("kind", sorted(CARD_SAMPLINGS))
def test_kernel_equals_the_twin_on_the_card(cuda, kind):
    """E nearest and fancy (and RGB-ID) == its twin byte for byte at sizes
    whose rows end inside a quad, a warp or a plane (17x37 to 12x200 and a
    row of 513 pixels), one frame and a batch of three, planes aligned and 3
    bytes off a word, and, where a component filters vertically, band
    frames with random halo rows and a content edge."""
    samplings = CARD_SAMPLINGS[kind]
    max_v = max(v for _, v in samplings)
    n = 0
    for seed, (h, w) in enumerate(((17, 37), (18, 38), (24, 40), (21, 30),
                                   (12, 200), (9, 513))):
        for batch in (None, 3):
            planes = [torch.from_numpy(p).to(cuda) for p in
                      random_planes(samplings, h, w, seed, batch)]
            odd = [off_a_word(p) for p in planes]
            for fancy in (False, True):
                for rgb in (False, True) if len(planes) == 3 else (False,):
                    want = C.finalize_planes_reference(planes, samplings, w,
                                                       h, fancy, rgb)
                    for pl in (planes, odd):
                        got = C.finalize_planes(pl, samplings, w, h, fancy,
                                                rgb)
                        assert torch.equal(got, want), (h, w, batch, fancy,
                                                        rgb, pl is odd)
                        n += 1
            if max_v == 1 or len(planes) == 1:
                continue
            rng = np.random.default_rng(seed)
            lead = () if batch is None else (batch,)
            for valid in (None, 1, 2, 3):
                halos = [None if v == max_v else tuple(
                    torch.from_numpy(rng.integers(
                        0, 256, lead + (p.shape[-1],), dtype=np.uint8)).to(
                            cuda) for _ in range(2)) + (valid,)
                    for p, (_, v) in zip(planes, samplings)]
                assert torch.equal(
                    C.finalize_planes(planes, samplings, w, h, True,
                                      halos=halos),
                    C.finalize_planes_reference(planes, samplings, w, h,
                                                True, halos=halos)), valid
                n += 1
    assert n >= 48
