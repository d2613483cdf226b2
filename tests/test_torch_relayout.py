"""ops/relayout.py on the CPU: each plain version against the expression the
JAX tool computes its ``want`` with (numpy, exact), at the probes' shapes cut
down to G = 2; P2's inverse-then-forward round trip on a small decode; and
what the wrappers refuse. The CUDA kernels are held to the same answers in
tests/test_torch_kernels.py and chip_smoke.py, on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from compeg_tpu import encoder  # noqa: E402
from compeg_tpu_torch import Decoder  # noqa: E402
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
    assert len(results) == 11 and all(r["ok"] for r in results)
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
    (A + 4, A, 2160, 3840, 1, 3840, "word"),   # input one word off
    (A + 8, A, 2160, 3840, 1, 3840, "word"),
    (A + 16, A, 2160, 3840, 1, 3840, "vec"),   # four words off
    (A, A + 4, 2160, 3840, 1, 3840, "word"),   # output one word off
    (A, A, 1, 4095, 1, 4095, "word"),          # no multiple of four words
    (A, A, 3, 6, 1, 6, "word"),                # contiguous, 18 words
    (A, A, 2, 6, 1, 6, "vec"),                 # contiguous, 12 words: one row
    (A, A, 2160, 3836, 1, 3840, "vec"),        # strided rows of whole vectors
    (A, A, 2160, 3838, 1, 3840, "word"),       # ... of ragged length
    (A, A, 2160, 3836, 1, 3838, "word"),       # ... a ragged stride apart
    (A + 4, A, 8, 128, 16, 128 * 16 * 8, "vec"),  # a spread reads words
    (A + 4, A + 4, 8, 128, 16, 128, "word"),
    (A, A, 8, 3, 2, 3, "vec"),                 # 48 words in one row
    (A, A, 8, 3, 2, 5, "word"),                # rows of 6 words, strided
    (A, A, 7, 2, 2, 9, "vec"),                 # rows of one vector each
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
    assert route(base[1:1 + 64 * 64].reshape(64, 64)) == "word"
    assert route(grid[:, :60]) == "vec" and route(grid[:, :62]) == "word"
    assert route(grid[:, 4:]) == "vec" and route(grid[:, 1:61]) == "word"
    assert route(base[:64 * 65].reshape(64, 65)[:, :64]) == "word"
    assert route(base[1:1 + 64 * 64].reshape(64, 64), x=4) == "vec"


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
