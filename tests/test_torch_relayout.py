"""ops/relayout.py on the CPU: each plain version against the expression the
JAX tool computes its ``want`` with (numpy, exact), at the probes' shapes cut
down to G = 2; P2's inverse-then-forward round trip on a small decode; and
what the wrappers refuse. The CUDA kernels are held to the same answers in
tests/test_torch_kernels.py and chip_smoke.py, on the card."""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from compeg_tpu import encoder  # noqa: E402
from compeg_tpu_torch import Decoder  # noqa: E402
from compeg_tpu_torch.ops import _build  # noqa: E402
from compeg_tpu_torch.ops import relayout as R  # noqa: E402
from compeg_tpu_torch.tools import exp_relayout  # noqa: E402

G, S, RR, X, L = 2, 8, 8, 16, 128


def random_u32(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 1 << 24, shape,
                                                dtype=np.uint32)


def t(a):
    return torch.from_numpy(a.view(np.int32))


def u(x):
    return x.numpy().view(np.uint32)


def test_interleave_is_ref_interleave():
    x = random_u32((G, S, RR, X, L))
    want = x.transpose(0, 1, 2, 4, 3).reshape(G, S, RR, L * X)
    assert np.array_equal(u(R.relayout_interleave(t(x))), want)
    stacked = R.relayout_interleave(t(x), stack_rows=True)
    assert np.array_equal(u(stacked), want.reshape(G, S * RR, L * X))
    # out[g, s*R + r, l*X + x] = in[g, s, r, x, l]
    assert u(stacked)[1, 3 * RR + 5, 7 * X + 2] == x[1, 3, 5, 2, 7]
    # a 2-D matrix and a strided batch
    assert np.array_equal(u(R.relayout_interleave(t(x)[0, 0, 0])),
                          x[0, 0, 0].T.reshape(-1))
    assert np.array_equal(u(R.relayout_interleave(t(x)[0, :, 0])),
                          x[0, :, 0].transpose(0, 2, 1).reshape(S, -1))


def test_swap_crop_is_the_assembly_swap():
    n_tr, rt, n_tc = 2, 64, 2
    slab = random_u32((n_tr, rt, n_tc * X * L))
    h, w = n_tr * rt - 16, 3840
    want = (slab.reshape(n_tr * rt, n_tc, X, L).transpose(0, 1, 3, 2)
            .reshape(n_tr * rt, n_tc * L * X)[:h, :w])
    got = u(R.relayout_swap_crop(t(slab), X, h, w))
    assert np.array_equal(got, want)
    # out[r*RT + t, c*L*X + l*X + x] = slab[r, t, c*X*L + x*L + l]
    assert got[1 * rt + 9, 1 * L * X + 5 * X + 3] == slab[
        1, 9, 1 * X * L + 3 * L + 5]


@pytest.mark.parametrize("sampling,h,w", [("422", 40, 72), ("420", 33, 50)])
def test_swap_crop_round_trip_on_a_decode(sampling, h, w, test_image):
    data = encoder.encode(test_image(h, w, "noise"), sampling=sampling,
                          restart_interval_mcus=1)
    dec = Decoder(device="cpu")
    pf = dec.prepare(data)
    img = dec.decode_prepared(pf)
    g = pf.geom
    mh = 8 * max(v for _, v in g.samplings)
    mw = 8 * max(hh for hh, _ in g.samplings)
    slab = R.swap_crop_inverse(img, g.ri * mw, S * mh)
    assert slab.shape == (-(-h // (S * mh)), S * mh,
                          -(-w // (mw * 128)) * mw * 128)
    assert torch.equal(R.relayout_swap_crop(slab, g.ri * mw, h, w), img)


def test_stack_is_want_stack():
    x = random_u32((G, S, RR, X, L))
    want = x.transpose(0, 3, 1, 2, 4).reshape(G, X, S * RR, L)
    got = u(R.relayout_stack(t(x)))
    assert np.array_equal(got, want)
    assert got[1, 4, 6 * RR + 2, 99] == x[1, 6, 2, 4, 99]


def test_spread_merge_and_copy_are_the_bisect_constructs():
    x = random_u32((S, RR, X, L))
    a, b = t(x)[:, 0, 0, :], t(x)[:, 0, 1, :]
    spread = np.repeat(x[:, 0, 0, :], X, axis=1)
    assert np.array_equal(u(R.relayout_spread(a, X)), spread)
    want = np.where((np.arange(L * X)[None, :] & (X - 1)) == 0, spread,
                    np.repeat(x[:, 0, 1, :], X, axis=1))
    assert np.array_equal(u(R.relayout_spread_merge(a, b, X)), want)
    assert np.array_equal(u(R.relayout_copy(a)), x[:, 0, 0, :])
    assert np.array_equal(u(R.relayout_copy(t(x))), x)
    inter = np.zeros((S, L * X), np.uint32)
    for k in range(X):
        inter[:, k::X] = x[:, 0, k, :]
    assert np.array_equal(u(R.relayout_interleave(t(x)[:, 0])), inter)
    assert np.array_equal(u(R.relayout_stack(t(x)[None])[0, 0]),
                          x[:, :, 0, :].reshape(S * RR, L))


def test_the_tool_checks_every_probe_on_the_cpu():
    results = exp_relayout.probes("cpu", groups=1)
    assert len(results) == 12 and all(r["ok"] for r in results)
    assert {r["name"] for r in results} == {
        "relayout_interleave", "relayout_swap_crop", "relayout_stack",
        "relayout_spread_merge"}
    # a CPU run states no device time
    assert all(r["ms"] is None and r["library_ms"] is None for r in results)
    assert "not measured" in exp_relayout.report(results[0])
    first = results[0]
    assert first["bytes"] == 2 * 1 * S * RR * X * L * 4
    assert first["bound_ms"] == pytest.approx(first["bytes"] / 3.35e12 * 1e3)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = t(random_u32((G, S, RR, X, L)))
    with pytest.raises(ValueError, match="int32"):
        R.relayout_stack(x.float())
    with pytest.raises(ValueError, match="dimensions"):
        R.relayout_stack(x[0])
    with pytest.raises(ValueError, match="stack_rows"):
        R.relayout_interleave(x[0, 0, 0], stack_rows=True)
    with pytest.raises(ValueError, match="whole number"):
        R.relayout_swap_crop(x.reshape(G, 64, -1)[:, :, :100], X, 8, 8)
    with pytest.raises(ValueError, match="outside the slab"):
        R.relayout_swap_crop(x.reshape(G, 64, -1), X, G * 64 + 1, 8)
    with pytest.raises(ValueError, match="share shape"):
        R.relayout_spread_merge(x[0, 0, 0], x[0, 0, 0, :4], X)


# -- the copy's and the spread's choice of kernels, and views -----------------

A = 0x7F0000000000  # a 512-byte aligned base, as the allocator hands out

ROUTES = [
    # a_ptr, out_ptr, n, l, x, in_stride, route
    (A, A, 2160, 3840, 1, 3840, "vec"),        # the 4K raster
    (A + 4, A, 2160, 3840, 1, 3840, "shift"),  # input one word off
    (A + 8, A, 2160, 3840, 1, 3840, "shift"),
    (A + 12, A, 2160, 3840, 1, 3840, "shift"),
    (A + 16, A, 2160, 3840, 1, 3840, "vec"),   # four words off
    (A, A + 4, 2160, 3840, 1, 3840, "shift"),  # output one word off
    (A, A + 8, 2160, 3840, 1, 3840, "shift"),
    (A, A + 12, 2160, 3840, 1, 3840, "shift"),
    (A + 4, A + 4, 2160, 3840, 1, 3840, "shift"),  # both one word off
    (A + 12, A + 8, 2160, 3836, 1, 3840, "shift"),
    (A, A, 1, 4095, 1, 4095, "shift"),         # no multiple of four words
    (A, A, 3, 6, 1, 6, "shift"),               # contiguous, 18 words
    (A, A, 2, 6, 1, 6, "vec"),                 # contiguous, 12 words: one row
    (A, A, 2160, 3836, 1, 3840, "vec"),        # strided rows of whole vectors
    (A, A, 2160, 3838, 1, 3840, "shift"),      # ... of ragged length
    (A, A, 2160, 3836, 1, 3838, "shift"),      # ... a ragged stride apart
    (A + 4, A, 8, 128, 16, 128 * 16 * 8, "vec"),  # a spread reads words
    (A + 4, A + 4, 8, 128, 16, 128, "word"),
    (A, A, 8, 3, 2, 3, "vec"),                 # 48 words in one row
    (A, A, 8, 3, 2, 5, "word"),                # rows of 6 words, strided
    (A, A, 7, 2, 2, 9, "vec"),                 # rows of one vector each
    (A, A + 8, 7, 2, 3, 9, "word"),            # a spread off a boundary
]


@pytest.mark.parametrize("a_ptr,out_ptr,n,l,x,in_stride,route", ROUTES)
def test_route_is_a_function_of_pointers_strides_and_length(
        a_ptr, out_ptr, n, l, x, in_stride, route):
    assert R.spread_merge_route(a_ptr, out_ptr, n, l, x, in_stride) == route


def test_route_of_real_tensors():
    base = torch.zeros(64 * 65 + 8, dtype=torch.int32)
    base = base[(-base.data_ptr() // 4) % 4:]  # 16-byte aligned from here
    assert base.data_ptr() % 16 == 0
    out = base.data_ptr()

    def route(a, x=1):
        n, l = a.shape
        return R.spread_merge_route(a.data_ptr(), out, n, l, x, a.stride(0))

    grid = base[:64 * 64].reshape(64, 64)
    assert route(grid) == "vec"
    for off in (1, 2, 3):
        assert route(base[off:off + 64 * 64].reshape(64, 64)) == "shift"
    assert route(base[4:4 + 64 * 64].reshape(64, 64)) == "vec"
    assert route(grid[:, :60]) == "vec" and route(grid[:, :62]) == "shift"
    assert route(grid[:, 4:]) == "vec" and route(grid[:, 1:61]) == "shift"
    assert route(base[:64 * 65].reshape(64, 65)[:, :64]) == "shift"
    assert route(base[1:1 + 64 * 64].reshape(64, 64), x=4) == "vec"
    assert route(grid[:, :62], x=2) == "vec"
    assert route(base[:64 * 65].reshape(64, 65)[:, :63], x=2) == "word"


VIEWS = [
    ("contiguous", lambda t: t),
    ("one word off", lambda t: t.reshape(-1)[1:1 + 24 * 40].reshape(24, 40)),
    ("column slice", lambda t: t[:, 4:36]),
    ("ragged column slice", lambda t: t[:, 3:30]),
    ("row slice", lambda t: t[5:17]),
    ("every other row", lambda t: t[::2]),
    ("one row", lambda t: t[7:8, 1:]),
]


@pytest.mark.parametrize("x", [1, 2, 16])
@pytest.mark.parametrize("name,view", VIEWS)
def test_copy_spread_and_merge_of_views_equal_numpy(name, view, x):
    a_np, b_np = random_u32((25, 40), 1), random_u32((25, 40), 2)
    a, b = view(t(a_np)), view(t(b_np))
    an, bn = view(a_np), view(b_np)
    assert a.stride(1) == 1
    spread = np.repeat(an, x, axis=1)
    assert np.array_equal(u(R.relayout_spread(a, x)), spread)
    merged = np.repeat(bn, x, axis=1)
    merged[:, ::x] = an
    assert np.array_equal(u(R.relayout_spread_merge(a, b, x)), merged)
    if x == 1:
        got = R.relayout_copy(a)
        assert np.array_equal(u(got), an) and got.is_contiguous()
        assert got.data_ptr() != a.data_ptr()


def test_copy_of_higher_rank_and_what_it_refuses():
    x = random_u32((3, 4, 5, 8))
    assert np.array_equal(u(R.relayout_copy(t(x))), x)
    with pytest.raises(ValueError, match="contiguous"):
        R.relayout_copy(t(x)[:, :, ::2])
    with pytest.raises(ValueError, match="X >= 1"):
        R.relayout_spread(t(x)[0, 0], 0)


# -- the copy's shift route (relayout_copy_shift_kernel), in numpy ------------


def copy_constants():
    """COPY_IN_FLIGHT and the shift kernel's threads a block, as
    csrc/relayout.cu has them."""
    with open(os.path.join(_build.CSRC, "relayout.cu")) as f:
        text = f.read()
    threads = re.search(r"__launch_bounds__\((\d+)\)\s*"
                        r"relayout_copy_shift_kernel\(", text)
    return {"COPY_IN_FLIGHT": int(re.search(
                r"constexpr int COPY_IN_FLIGHT = (\d+);", text)[1]),
            "THREADS": int(threads[1])}


CP = copy_constants()


class ViewMemory:
    """Device memory in words around a view: ``view`` words are the input,
    the rest of ``data`` is other memory. A 16-byte load must be aligned and
    hold at least one word of the view; a word load must be a word of it."""

    def __init__(self, data, base, view):
        self.data, self.base, self.view = data, base, view

    def load(self, addr, vector=False):
        addr = np.asarray(addr)
        if vector:
            assert (addr % 4 == 0).all(), "unaligned 16-byte load"
            words = addr[:, None] + np.arange(4)
            assert self.view[words - self.base].any(axis=1).all(), \
                "a 16-byte load holds no word of the view"
            return self.data[words - self.base]
        assert self.view[addr - self.base].all(), "a word outside the view"
        return self.data[addr - self.base]


def copy_shift_walk(src, dst, n, l, in_stride, row0, max_blocks=16,
                    max_rows=65535, mutate=None):
    """relayout_copy_shift_kernel in numpy with its launch (a grid at most
    ``max_blocks`` wide, a card of ``max_blocks / 16`` multiprocessors: one
    vector a thread while that width holds the copy, else COPY_IN_FLIGHT; a
    row a blockIdx.y, at most ``max_rows`` of them), the threads of one blockIdx.y as a vector, the
    shuffle that hands a lane the next lane's chunk included: the copy of
    ``n`` rows of ``l`` words, ``in_stride`` apart from word address
    ``row0``, into ``dst``. ``mutate`` breaks one step, as a wrong kernel
    would."""
    threads = CP["THREADS"]
    flat = n == 1 or in_stride == l
    rows, lw = (1, n * l) if flat else (n, l)
    nv_max = (lw + 6) // 4
    # one vector a thread while the card's width holds the copy that way
    inflight = (CP["COPY_IN_FLIGHT"] if nv_max * rows > max_blocks * threads
                else 1)
    want_blocks = -(-nv_max // (inflight * threads))
    step = min(want_blocks, max_blocks) * threads
    v0 = np.arange(step)
    for y in range(min(rows, max_rows)):
        for r in range(y, rows, max_rows):
            s = row0 + r * in_stride  # word addresses
            o = dst.base + r * lw
            head = o % 4
            d = (s - head) % 4
            if mutate == "wrong d":
                d = (row0 - dst.base % 4) % 4
            chunks = s - head - d  # chunk q is at chunks + 4 * q
            nv, qa, qb = (lw + head + 3) >> 2, int(head != 0), (lw + head) >> 2
            for v in range(0, nv, inflight * step):
                staged = []
                for k in range(inflight):
                    q = v + v0 + k * step
                    inner = (q >= qa) & (q < qb)
                    lane = v0 % 32
                    lo = np.zeros((step, 4), np.uint32)
                    lo[inner] = src.load(chunks + 4 * q[inner], vector=True)
                    # chunk q + 1: loaded by the warp's last lane and where
                    # the next vector is not the row's, else the next
                    # lane's chunk q, by a shuffle
                    own = inner & ((lane == 31) | (q + 1 >= qb))
                    if mutate == "no load at the warp's end":
                        own &= lane != 31
                    hi = np.zeros((step, 4), np.uint32)
                    if d:
                        hi[own] = src.load(chunks + 4 * q[own] + 4,
                                           vector=True)
                        # __shfl_down_sync(.., 1): lane 31 gets its own
                        nxt = np.where((lane < 31)[:, None],
                                       np.roll(lo, -1, axis=0), lo)
                        shuffled = inner & ~own
                        hi[shuffled, :d] = nxt[shuffled, :d]
                    vec = np.concatenate([lo, hi], axis=1)[inner, d:d + 4]
                    q = q[q < nv]
                    inner = inner[:q.size]
                    edge = q[~inner]
                    words = np.zeros((edge.size, 4), np.uint32)
                    for i in range(4):
                        at = 4 * edge - head + i
                        ok = (at >= 0) & (at < lw)
                        if mutate == "lost head word":
                            ok &= at >= 1
                        words[ok, i] = src.load(s + at[ok])
                    staged.append((q[inner], vec, edge, words))
                for qi, vec, edge, words in staged:
                    dst.store(o - head + 4 * qi, vec.reshape(-1), vector=True)
                    end = lw - 1 if mutate == "dropped tail" else lw
                    for i in range(4):
                        at = 4 * edge - head + i
                        ok = (at >= 0) & (at < end)
                        dst.store(o + at[ok], words[ok, i])


def shift_copy(n, l, in_stride, in_off, out_off, max_blocks=16,
               max_rows=65535, mutate=None):
    """The walk over ``n`` rows of ``l`` words ``in_stride`` apart, the
    first ``in_off`` words and the output ``out_off`` words past a 16-byte
    boundary; the output and the view in numpy."""
    extent = (n - 1) * in_stride + l
    data = random_u32(extent + 16, seed=n * 7919 + l * 31 + in_stride)
    base = 4096
    row0 = base + 4 + in_off
    view = np.zeros(data.size, bool)
    for r in range(n):
        view[row0 - base + r * in_stride:row0 - base + r * in_stride + l] = 1
    src = ViewMemory(data, base, view)
    dst = Memory(np.zeros(n * l, np.uint32), 8192 + out_off)
    copy_shift_walk(src, dst, n, l, in_stride, row0, max_blocks, max_rows,
                    mutate)
    rows = np.stack([data[row0 - base + r * in_stride:
                          row0 - base + r * in_stride + l] for r in range(n)])
    return dst, rows.reshape(-1)


def check_shift_copy(*args, **kwargs):
    dst, want = shift_copy(*args, **kwargs)
    assert (dst.writes == 1).all(), "an output word not written once"
    assert np.array_equal(dst.data, want)


@pytest.mark.parametrize("in_off", [0, 1, 2, 3])
def test_copy_shift_walk_contiguous_equals_numpy(in_off):
    """The contiguous copy of 1 to 4,099 words, input and output 0 to 3
    words past a 16-byte boundary: every output word written once, every
    16-byte load and store aligned, every load holding a word of the input,
    and the input's words in order."""
    assert R.spread_merge_route(16 + 4 * in_off, 16, 1, 4095, 1,
                                4095) == "shift"
    for words in [*range(1, 34), 127, 128, 129, 1023, 1024, 1025, 4093,
                  4095, 4096, 4097, 4099]:
        for out_off in range(4):
            check_shift_copy(1, words, words, in_off, out_off)
    # two rows that are one contiguous run take the flat walk too
    check_shift_copy(3, 130, 130, in_off, 1)
    # past the card's width: COPY_IN_FLIGHT vectors a thread
    for out_off in range(4):
        check_shift_copy(1, 4099, 4099, in_off, out_off, max_blocks=1)


@pytest.mark.parametrize("stride_mod", [0, 1, 2, 3])
def test_copy_shift_walk_strided_rows_equal_numpy(stride_mod):
    """Strided rows of 1 to 130 words, strides of each remainder mod 4:
    each row its own relative word offset, its own head and tail of at most
    three words, written word by word."""
    for l in (1, 2, 3, 4, 5, 7, 8, 13, 64, 127, 128, 129, 130):
        stride = l + 1 + (stride_mod - l - 1) % 4
        assert stride % 4 == stride_mod and stride > l
        for in_off in range(4):
            for out_off in {0, (in_off + l) % 4}:
                check_shift_copy(5, l, stride, in_off, out_off)
        # rows walked by gridDim.y, vectors by the grid's width
        check_shift_copy(9, l, stride, 3, 0, max_blocks=1, max_rows=4)


@pytest.mark.parametrize("mutate,case", [
    ("lost head word", (1, 33, 33, 1, 2)),
    ("dropped tail", (1, 4099, 4099, 2, 0)),
    ("dropped tail", (4, 130, 133, 0, 1)),
    ("wrong d", (5, 64, 67, 1, 0)),
    ("no load at the warp's end", (1, 1000, 1000, 1, 0)),
])
def test_a_mutated_copy_shift_walk_fails(mutate, case):
    check_shift_copy(*case)
    with pytest.raises(AssertionError):
        check_shift_copy(*case, mutate=mutate)


# -- the interleave's choice of kernels ---------------------------------------

INTERLEAVE_ROUTES = [
    # in_ptr, out_ptr, n, x, l, in_stride, route
    (A, A, 4096, 16, 128, 2048, "vec"),        # the probe's shape
    (A + 4, A, 4096, 16, 128, 2048, "word"),   # input one word off
    (A, A + 4, 4096, 16, 128, 2048, "word"),   # output one word off
    (A + 16, A + 32, 4096, 16, 128, 2048, "vec"),
    (A, A, 8, 4, 128, 512, "vec"), (A, A, 8, 8, 128, 1024, "vec"),
    (A, A, 8, 32, 64, 2048, "vec"),
    (A, A, 8, 1, 128, 128, "word"), (A, A, 8, 2, 128, 256, "word"),
    (A, A, 8, 3, 128, 384, "word"),            # X no power of two
    (A, A, 8, 12, 128, 1536, "word"),
    (A, A, 8, 64, 128, 8192, "word"),          # X over 32
    (A, A, 8, 16, 130, 2080, "word"),          # rows of no whole vectors
    (A, A, 8, 16, 126, 2016, "word"),
    (A, A, 8, 16, 4, 64, "vec"),               # one vector a row
    (A, A, 8, 16, 128, 8 * 2048, "vec"),       # a strided batch, t[:, 0]
    (A, A, 8, 16, 128, 2050, "word"),          # ... a ragged stride apart
    (A, A, 1, 16, 128, 2050, "vec"),           # one matrix has no stride
]


@pytest.mark.parametrize("in_ptr,out_ptr,n,x,l,in_stride,route",
                         INTERLEAVE_ROUTES)
def test_interleave_route_is_a_function_of_pointers_strides_and_lengths(
        in_ptr, out_ptr, n, x, l, in_stride, route):
    assert R.interleave_route(in_ptr, out_ptr, n, x, l, in_stride) == route


def test_interleave_route_of_real_tensors():
    base = torch.zeros(4 * 8 * 16 * 128 + 8, dtype=torch.int32)
    base = base[(-base.data_ptr() // 4) % 4:]  # 16-byte aligned from here
    out = base.data_ptr()

    def route(v):
        x, l = v.shape[-2:]
        batch = v.reshape(-1, x, l) if v.is_contiguous() else v
        return R.interleave_route(batch.data_ptr(), out, batch.shape[0], x, l,
                                  batch.stride(0))

    t5 = base[:4 * 8 * 16 * 128].reshape(4, 8, 16, 128)
    assert route(t5) == "vec" and route(t5[:, 0]) == "vec"
    assert route(base[1:1 + 4 * 8 * 16 * 128].reshape(4, 8, 16, 128)) == "word"
    assert route(base[:4 * 8 * 3 * 128].reshape(4, 8, 3, 128)) == "word"
    assert route(base[:4 * 2 * 64 * 128].reshape(4, 2, 64, 128)) == "word"
    assert route(base[:4 * 8 * 16 * 127].reshape(4, 8, 16, 127)) == "word"


@pytest.mark.parametrize("x,l,n", [(16, 128, 5), (4, 8, 3), (32, 64, 2),
                                   (8, 12, 4)])
def test_interleave_vector_walk_equals_numpy(x, l, n):
    """relayout_interleave_vec_kernel's index arithmetic in numpy: thread w
    owns the 4 x 4 block (x4, l4) of matrix m, the X / 4 blocks of one l4
    side by side; four loads along l, four stores of transposed vectors."""
    a = random_u32((n, x, l), seed=x + l)
    want = a.transpose(0, 2, 1).reshape(n, l * x)
    assert R.interleave_route(A, A, n, x, l, x * l) == "vec"
    lxq = (x // 4).bit_length() - 1
    per = (l >> 2) << lxq
    flat, out = a.reshape(-1), np.zeros(n * x * l, np.uint32)
    written = np.zeros(out.size, np.int32)
    for w in range(n * per):
        m, r = divmod(w, per)
        x4, l4 = (r & ((1 << lxq) - 1)) * 4, (r >> lxq) * 4
        src = m * x * l + x4 * l + l4
        v = [flat[src + i * l:src + i * l + 4] for i in range(4)]
        dst = (m * l + l4) * x + x4
        for k in range(4):
            at = dst + k * x
            assert at % 4 == 0  # a 16-byte aligned store
            out[at:at + 4] = [v[i][k] for i in range(4)]
            written[at:at + 4] += 1
    assert (written == 1).all()
    assert np.array_equal(out.reshape(n, l * x), want)


# -- the word tile (P1's word route, P2's) and P2's vector route, in numpy ----


def tile_constants():
    """WT_THREADS, WT_WORDS, WT_CAP and WT_IN_FLIGHT as csrc/relayout.cu
    has them."""
    with open(os.path.join(_build.CSRC, "relayout.cu")) as f:
        text = f.read()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", text)[1])
            for k in ("WT_THREADS", "WT_WORDS", "WT_CAP", "WT_IN_FLIGHT")}


WT = tile_constants()


def word_tile_plan(rows, cols, x, l, in_stride, pitch, keep):
    """word_tile_plan of csrc/relayout.cu: whole matrices, or all X rows of
    a run of lanes, or a run of rows of one lane; about WT_WORDS words and
    at most WT_CAP."""
    words, cap = WT["WT_WORDS"], WT["WT_CAP"]
    xt, lt, mt = x, l, 1
    if x * l <= cap:
        mt = min(cols, words // (x * l) if x * l <= words else 1)
    elif x <= cap:
        lt = min(-(-l // -(-(x * l) // words)), cap // x)
    else:
        xt, lt = -(-x // -(-x // words)), 1
    return dict(rows=rows, cols=cols, in_stride=in_stride, pitch=pitch,
                keep=keep, X=x, L=l, xt=xt, lt=lt, mt=mt,
                tiles_x=-(-x // xt), tiles_l=-(-l // lt),
                tiles_m=-(-cols // mt))


class Memory:
    """Device memory in words: ``data`` placed at word address ``base``;
    every read and write is checked against the tensor's bounds and
    counted, and each 16-byte access against its alignment."""

    def __init__(self, data, base):
        self.data, self.base = data, base
        self.writes = np.zeros(data.size, np.int32)

    def index(self, addr, vector=False):
        addr = np.asarray(addr)
        if vector:
            assert (addr % 4 == 0).all(), "unaligned 16-byte access"
            addr = (addr[..., None] + np.arange(4)).reshape(-1)
        i = addr - self.base
        assert ((i >= 0) & (i < self.data.size)).all(), "outside the tensor"
        return i

    def load(self, addr, vector=False):
        return self.data[self.index(addr, vector)]

    def store(self, addr, values, vector=False):
        i = self.index(addr, vector)
        self.data[i] = values
        np.add.at(self.writes, i, 1)


def word_tile_walk(src: Memory, dst: Memory, q, mutate=None):
    """relayout_word_tile_kernel in numpy, a block (a tile) at a time with
    its threads as a vector: returns the worst bank conflict (distinct
    words in one bank) of the warps' scattered shared-memory stores.
    ``mutate`` breaks one step, as a wrong kernel would."""
    threads, inflight = WT["WT_THREADS"], WT["WT_IN_FLIGHT"]
    tid = np.arange(threads)
    worst = 1
    nblocks = q["rows"] * q["tiles_m"] * q["tiles_l"] * q["tiles_x"]
    for b in range(nblocks):
        tx = b % q["tiles_x"]
        b //= q["tiles_x"]
        tl = b % q["tiles_l"]
        b //= q["tiles_l"]
        tm, row = b % q["tiles_m"], b // q["tiles_m"]
        x0 = tx * q["xt"]
        xc = min(q["xt"], q["X"] - x0)
        l0 = tl * q["lt"]
        lc = min(q["lt"], q["L"] - l0)
        c0 = tm * q["mt"]
        mc = min(q["mt"], q["cols"] - c0)
        col0 = (c0 * q["L"] + l0) * q["X"] + x0
        keep = min(mc * lc * xc, q["keep"] - col0)
        if keep <= 0:
            continue
        out = dst.base + row * q["pitch"] + col0
        head = out % 4
        srcw = (src.base + (row * q["cols"] + c0) * q["in_stride"]
                + x0 * q["L"] + l0)
        aligned = ((mc == 1 or q["in_stride"] % 4 == 0)
                   and (xc == 1 or q["L"] % 4 == 0))
        kc = (srcw % 4 + lc + 3) >> 2 if aligned else (lc + 6) >> 2
        g = min(32, xc & -xc)
        lg, rows_g = g.bit_length() - 1, xc // g
        rot = ((tid & 31) // max(8, g)) & 3
        items = mc * xc * kc
        s = np.zeros(WT["WT_CAP"] + 4, np.uint32)
        for base in range(0, items, threads * inflight):
            loaded = []
            for r in range(inflight):
                f = base + r * threads + tid
                rg = (f >> lg) // kc
                k = (f >> lg) - rg * kc
                m = rg // rows_g
                x = (rg - m * rows_g) * g + (f & (g - 1))
                piece = srcw + m * q["in_stride"] + x * q["L"]
                lt = 4 * k - piece % 4
                p = (m * lc + lt) * xc + x
                live = (f < items) & (lt < lc) & (p < keep)
                chunk = piece + lt
                whole = live & (lt >= 0) & (lt + 4 <= lc)
                v = np.zeros((threads, 4), np.uint32)
                if whole.any():
                    v[whole] = src.load(chunk[whole], vector=True).reshape(
                        -1, 4)
                for i in range(4):
                    one = live & ~whole & (lt + i >= 0) & (lt + i < lc)
                    if mutate == "load loses the head word" and i == 3:
                        one &= lt >= 0
                    v[one, i] = src.load(chunk[one] + i)
                loaded.append((live, lt, p + head, v))
            for r, (live, lt, pos, v) in enumerate(loaded):
                for i in range(4):
                    w = (i + rot) & 3
                    if mutate == "no rotation":
                        w = np.full(threads, i)
                    ltw, p = lt + w, pos + w * xc
                    ok = live & (ltw >= 0) & (ltw < lc) & (p - head < keep)
                    s[p[ok]] = v[ok, w[ok]]
                    for warp in range(threads // 32):
                        lane = ok[warp * 32:(warp + 1) * 32]
                        addr = np.unique(p[warp * 32:(warp + 1) * 32][lane])
                        if addr.size:
                            worst = max(worst,
                                        np.bincount(addr % 32).max())
        chunks = (head + keep + 3) >> 2
        c = np.arange(chunks)
        p = 4 * c - head
        full = (p >= 0) & (p + 4 <= keep)
        if mutate == "store drops the tail":
            keep -= 1
        if full.any():
            dst.store(out - head + 4 * c[full],
                      s[(4 * c[full])[:, None] + np.arange(4)].reshape(-1),
                      vector=True)
        for i in range(4):
            one = ~full & (p + i >= 0) & (p + i < keep)
            dst.store(out + p[one] + i, s[4 * c[one] + i])
    return worst


def place(a: np.ndarray, offset: int, extra: int = 0):
    """``a`` flattened into device memory at a word address that is
    ``offset`` words past a 16-byte boundary."""
    return Memory(np.concatenate([a.reshape(-1), np.zeros(extra, np.uint32)]),
                  4096 + offset)


def interleave_walk(a, n, x, l, in_stride, in_off, out_off, mutate=None):
    src = place(a, in_off)
    dst = Memory(np.zeros(n * x * l, np.uint32), 8192 + out_off)
    q = word_tile_plan(1, n, x, l, in_stride, n * x * l, n * x * l)
    worst = word_tile_walk(src, dst, q, mutate)
    return dst, worst


@pytest.mark.parametrize("l", [1, 126, 130])
@pytest.mark.parametrize("x", [1, 2, 3, 12, 64, 65])
def test_word_tile_walk_equals_numpy(x, l):
    """The word tile's index arithmetic, for input and output 0 to 3 words
    past a 16-byte boundary, contiguous and a ragged batch stride apart:
    every output word written once, every 16-byte access aligned, no read
    or write outside its tensor, and the result the JAX tool's ``want``."""
    n = 3
    for stride in (x * l, x * l + 5):
        a = random_u32(n * stride, seed=x * 1000 + l)
        mats = np.lib.stride_tricks.as_strided(
            a, (n, x, l), (stride * 4, l * 4, 4))
        want = mats.transpose(0, 2, 1).reshape(-1)
        for in_off in range(4):
            for out_off in range(4):
                dst, _ = interleave_walk(a[:(n - 1) * stride + x * l], n, x,
                                         l, stride, in_off, out_off)
                assert (dst.writes == 1).all()
                assert np.array_equal(dst.data, want)


def test_word_tile_walk_over_the_widest_rows_and_the_plan():
    """X past WT_CAP splits the rows; the plan's three forms, tiles of near
    equal size, never more than WT_CAP words, and every chunk of a thread's
    loads in flight at once at the probe's shapes."""
    words, cap = WT["WT_WORDS"], WT["WT_CAP"]
    x, l, n = cap + 3, 3, 2
    a = random_u32((n, x, l), 3)
    dst, _ = interleave_walk(a, n, x, l, x * l, 1, 2)
    assert (dst.writes == 1).all()
    assert np.array_equal(dst.data, a.transpose(0, 2, 1).reshape(-1))
    for (x, l, cols), (xt, lt, mt) in [
            ((3, 128, 4096), (3, 128, words // 384)),
            ((16, 130, 4096), (16, 130, 1)),
            ((16, 260, 4096), (16, 87, 1)),
            ((64, 32, 4096), (64, 32, 1)),
            ((cap + 3, 3, 2), (-(-(cap + 3) // 2), 1, 1)),
            ((16, 128, 1), (16, 128, 1))]:
        q = word_tile_plan(1, cols, x, l, x * l, 0, 0)
        assert (q["xt"], q["lt"], q["mt"]) == (xt, lt, mt)
        assert q["xt"] * q["lt"] * q["mt"] <= cap
    capacity = WT["WT_THREADS"] * WT["WT_IN_FLIGHT"]
    for x, l, mt in [(3, 128, 5), (16, 128, 1), (16, 130, 1), (64, 32, 1)]:
        assert mt * x * ((l + 6) // 4) <= capacity  # chunks of any offset


@pytest.mark.parametrize("x,l,in_off", [(1, 128, 0), (2, 128, 1),
                                        (3, 128, 0), (5, 128, 0),
                                        (12, 128, 0), (16, 128, 1),
                                        (16, 130, 0), (64, 32, 3)])
def test_word_tile_scatter_is_free_of_bank_conflicts(x, l, in_off):
    """The scattered shared-memory stores of each warp fall in 32 distinct
    banks wherever a warp's chunks lie in one group of g rows of one
    alignment (whole rows of whole vectors, as at X = 3 and the probe's
    shapes, or rows of 16 and 64 at any offset), for odd and even X; without
    the lane rotation they would not. A warp that spans two row groups of
    unlike alignment may find a bank twice or three times."""
    n = 4
    a = random_u32((n, x, l), 5)
    _, worst = interleave_walk(a, n, x, l, x * l, in_off, 0)
    assert worst == 1
    for l2, off2 in ((l + 2, 1), (l - 1, 3)):
        b = random_u32((n, x, l2), 6)
        assert interleave_walk(b, n, x, l2, x * l2, off2, 0)[1] <= 3
    if x in (1, 2, 16):
        _, worst = interleave_walk(a, n, x, l, x * l, in_off, 0,
                                   mutate="no rotation")
        assert worst > 1


SWAP_CASES = [
    # x, n_tr, rt, n_tc, h, w
    (16, 2, 8, 2, 13, 3840),   # the 4K slab's shape, rows cut mid-tile
    (16, 2, 8, 2, 16, 2100),   # columns cut inside the second tile
    (8, 1, 8, 3, 5, 2052),
    (4, 2, 4, 2, 7, 516),
    (32, 1, 4, 1, 3, 4092),
]


def swap_want(slab, x, h, w):
    n_tr, rt, cols = slab.shape
    n_tc = cols // (x * 128)
    return (slab.reshape(n_tr * rt, n_tc, x, 128).transpose(0, 1, 3, 2)
            .reshape(n_tr * rt, cols)[:h, :w].reshape(-1))


def swap_vec_walk(src: Memory, dst: Memory, x, h, w, n_tc, mutate=None):
    """relayout_interleave_vec_kernel<Idx, true> (P2's vector route) in
    numpy, all threads at once: thread t owns the 4 x 4 block (x4, l4) of
    matrix m = (row, column); rows at or past h are not launched, vectors
    at or past column w not stored."""
    lxq = (x // 4).bit_length() - 1
    per = (128 >> 2) << lxq
    t = np.arange(h * n_tc * per)
    m, r = t // per, t % per
    x4, l4 = (r & ((1 << lxq) - 1)) * 4, (r >> lxq) * 4
    row, c = m // n_tc, m % n_tc
    col = (c * 128 + l4) * x + x4
    live = col < w if mutate != "no crop" else col >= 0
    srcw = src.base + m * x * 128 + x4 * 128 + l4
    v = [src.load(srcw[live] + i * 128, vector=True).reshape(-1, 4)
         for i in range(4)]
    for k in range(4):
        ok = k * x < w - col[live]
        if mutate == "no crop":
            ok |= True
        vals = np.stack([v[i][:, k] for i in range(4)], 1)[ok]
        dst.store(dst.base + row[live][ok] * w + col[live][ok] + k * x,
                  vals.reshape(-1), vector=True)


@pytest.mark.parametrize("x,n_tr,rt,n_tc,h,w", SWAP_CASES)
def test_swap_crop_vector_walk_equals_numpy(x, n_tr, rt, n_tc, h, w):
    slab = random_u32((n_tr, rt, n_tc * x * 128), seed=x + w)
    assert R.swap_crop_route(4096 * 4, 8192 * 4, x, w) == "vec"
    src, dst = place(slab, 0), Memory(np.zeros(h * w, np.uint32), 8192)
    swap_vec_walk(src, dst, x, h, w, n_tc)
    assert (dst.writes == 1).all()
    assert np.array_equal(dst.data, swap_want(slab, x, h, w))
    # without the crop it writes past rows' ends, over the next rows' words
    with pytest.raises(AssertionError):
        dst = Memory(np.zeros(h * w, np.uint32), 8192)
        swap_vec_walk(src, dst, x, h, w, n_tc, mutate="no crop")
        assert (dst.writes == 1).all()


@pytest.mark.parametrize("x,n_tr,rt,n_tc,h,w", SWAP_CASES + [
    (16, 2, 8, 2, 13, 3838), (3, 2, 4, 2, 7, 700), (12, 1, 5, 1, 5, 1535)])
def test_swap_crop_word_walk_equals_numpy(x, n_tr, rt, n_tc, h, w):
    """P2's word route: the word tile over the slab's [X, 128] tiles into
    rows of pitch w, from slab and raster 0 to 3 words past a boundary."""
    slab = random_u32((n_tr, rt, n_tc * x * 128), seed=x + w + 1)
    want = swap_want(slab, x, h, w)
    for in_off, out_off in [(0, 0), (1, 2), (3, 1), (2, 3)]:
        src = place(slab, in_off)
        dst = Memory(np.zeros(h * w, np.uint32), 8192 + out_off)
        q = word_tile_plan(h, n_tc, x, 128, x * 128, w, w)
        word_tile_walk(src, dst, q)
        assert (dst.writes == 1).all()
        assert np.array_equal(dst.data, want)


@pytest.mark.parametrize("mutate", ["load loses the head word",
                                    "store drops the tail"])
def test_a_mutated_word_tile_walk_fails(mutate):
    x, l, n = 3, 130, 3
    a = random_u32((n, x, l), 9)
    with pytest.raises(AssertionError):
        dst, _ = interleave_walk(a, n, x, l, x * l, 1, 1, mutate=mutate)
        assert (dst.writes == 1).all()
        assert np.array_equal(dst.data, a.transpose(0, 2, 1).reshape(-1))


SWAP_ROUTES = [
    # slab_ptr, out_ptr, x, width, route
    (A, A, 16, 3840, "vec"),            # the 4K slab
    (A, A, 16, 3838, "word"),           # rows of no whole vectors
    (A + 4, A, 16, 3840, "word"),       # slab one word off
    (A, A + 8, 16, 3840, "word"),       # raster two words off
    (A + 16, A + 32, 16, 3840, "vec"),
    (A, A, 4, 512, "vec"), (A, A, 8, 1024, "vec"), (A, A, 32, 4096, "vec"),
    (A, A, 3, 384, "word"),             # X no power of two
    (A, A, 12, 1536, "word"),
    (A, A, 64, 8192, "word"),           # X over 32
    (A, A, 2, 256, "word"), (A, A, 1, 128, "word"),
    (A, A, 16, 4, "vec"),               # one vector a row
]


@pytest.mark.parametrize("slab_ptr,out_ptr,x,width,route", SWAP_ROUTES)
def test_swap_crop_route_is_a_function_of_pointers_x_and_width(
        slab_ptr, out_ptr, x, width, route):
    assert R.swap_crop_route(slab_ptr, out_ptr, x, width) == route


def test_swap_crop_route_of_real_tensors():
    slab = torch.zeros(2 * 8 * 4096 + 8, dtype=torch.int32)
    slab = slab[(-slab.data_ptr() // 4) % 4:]
    out = torch.zeros(16 * 3840 + 8, dtype=torch.int32)
    out = out[(-out.data_ptr() // 4) % 4:]
    assert R.swap_crop_route(slab.data_ptr(), out.data_ptr(), 16, 3840) == "vec"
    assert R.swap_crop_route(slab[1:].data_ptr(), out.data_ptr(), 16,
                             3840) == "word"
    assert R.swap_crop_route(slab.data_ptr(), out[3:].data_ptr(), 16,
                             3840) == "word"
    assert R.swap_crop_route(slab.data_ptr(), out.data_ptr(), 16,
                             3838) == "word"
