"""compeg_tpu_torch's CUDA kernels against their plain PyTorch versions and
the golden decoder on small streams: K1 (entropy), K2x (exact IDCT) and K3
(planes, integer IDCT) exactly, K2 (fused decode), K3 with the float IDCT
and K2s (scaled) within 1, the f32 IDCT summing in another order. These need
a CUDA device and nvcc (the kernels have no CPU mode) and skip without one;
``python3 chip_smoke.py`` runs the same checks and the 4K frame on the card.

What the CPU can check of the kernels' interface runs here: the launch
parameter block matches the C struct, and a CPU tensor takes the plain
version."""

import ctypes
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from compeg_tpu import encoder, golden  # noqa: E402
from compeg_tpu.tables import ZIGZAG  # noqa: E402
from compeg_tpu_torch.ops import _build  # noqa: E402
from compeg_tpu_torch.ops import color as C  # noqa: E402
from compeg_tpu_torch.ops import entropy as E  # noqa: E402
from compeg_tpu_torch.ops import fused as F  # noqa: E402
from compeg_tpu_torch.ops import idct as D  # noqa: E402
from compeg_tpu_torch.ops import relayout as R  # noqa: E402
from compeg_tpu_torch.parallel import sharding as SH  # noqa: E402
from compeg_tpu_torch.batch import BatchDecoder, StreamDecoder  # noqa: E402
from compeg_tpu_torch.pipeline import Decoder  # noqa: E402
from compeg_tpu_torch.tools import exp_relayout  # noqa: E402
from test_torch_smoke_vectors import golden_planes, zrl_stream  # noqa: E402

CASES = [("422", 1), ("444", 1), ("420", 1), ("440", 1), ("411", 1),
         ("gray", 1), ("422", 2), ("422", 5), ("422", None)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def prepared(device, sampling, ri, test_image, h=24, w=40, **knobs):
    data = encoder.encode(test_image(h, w, "noise"), sampling=sampling,
                          quality=90, restart_interval_mcus=ri)
    dec = Decoder(device=device, **knobs)
    pf = dec.prepare(data)
    return data, pf, dec.upload(pf)


def counted(key, fn, *args, **kwargs):
    """fn(*args) and check that it launched kernel ``key`` exactly once (each
    kernel of a tuple of keys once) and no other."""
    keys = (key,) if isinstance(key, str) else key
    before = dict(_build.LAUNCHES)
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    want = dict(before, **{k: before[k] + 1 for k in keys})
    assert _build.LAUNCHES == want
    return out


def as_rgb(img):
    return F.rgba_to_rgb(img).cpu().numpy()


@pytest.mark.parametrize("sampling,ri", CASES)
def test_k1_equals_plain_and_golden(cuda, sampling, ri, test_image):
    data, pf, rows = prepared(cuda, sampling, ri, test_image)
    g = pf.geom
    args = (rows, pf.nseg, pf.tables, g.ri, g.total_mcus, g.du_to_comp)
    before = _build.LAUNCHES["entropy"]
    got = E.entropy_decode(*args)
    assert _build.LAUNCHES["entropy"] == before + 1
    assert torch.equal(got, E.entropy_decode_reference(*args))
    want = golden.decode_coefficients(pf.image, dequant=False)
    assert np.array_equal(
        E.coefficients_natural_order(got, g.total_mcus).cpu().numpy(), want)


@pytest.mark.parametrize("sampling,ri", CASES)
def test_k2_within_one_of_plain(cuda, sampling, ri, test_image):
    data, pf, rows = prepared(cuda, sampling, ri, test_image, h=17, w=37)
    args = (rows, pf.nseg, pf.tables, pf.op, pf.geom)
    before = _build.LAUNCHES["fused"]
    got = F.fused_decode_rgba(*args)
    assert _build.LAUNCHES["fused"] == before + 1
    want = F.fused_decode_rgba_reference(*args)
    got_rgba = got.cpu().numpy().view(np.uint8).reshape(17, 37, 4)
    want_rgba = want.cpu().numpy().view(np.uint8).reshape(17, 37, 4)
    assert np.abs(got_rgba.astype(int) - want_rgba.astype(int)).max() <= 1
    assert (got_rgba[..., 3] == 255).all()
    gold = golden.decode_rgb(data)
    assert np.abs(got_rgba[..., :3].astype(int) - gold.astype(int)).max() <= 1


@pytest.mark.parametrize("sampling,ri", CASES)
def test_k2x_equals_plain_and_golden(cuda, sampling, ri, test_image):
    data, pf, rows = prepared(cuda, sampling, ri, test_image, h=17, w=37,
                              exact_idct=True)
    args = (rows, pf.nseg, pf.tables, pf.op, pf.geom)
    got = counted("fused_exact", F.fused_decode_rgba_exact, *args)
    assert torch.equal(got, F.fused_decode_rgba_exact_reference(*args))
    assert np.array_equal(as_rgb(got), golden.decode_rgb(data, idct="int"))


@pytest.mark.parametrize("retained", [64, 32])
def test_k2x_compat_equals_golden(cuda, retained):
    """The ZRL stream under zrl_compat: K1 and K2x against golden's compat
    decode."""
    data = zrl_stream()
    dec = Decoder(device=cuda, zrl_compat=True, exact_idct=True,
                  retained_coefficients=retained)
    pf = dec.prepare(data)
    rows = dec.upload(pf)
    g = pf.geom
    k1 = counted("entropy", E.entropy_decode, rows, pf.nseg, pf.tables, g.ri,
                 g.total_mcus, g.du_to_comp)
    assert np.array_equal(
        E.coefficients_natural_order(k1, g.total_mcus).cpu().numpy(),
        golden.decode_coefficients(pf.image, dequant=False, zrl17=True))
    got = counted("fused_exact", F.fused_decode_rgba_exact, rows, pf.nseg,
                  pf.tables, pf.op, g)
    assert np.array_equal(as_rgb(got), golden.decode_rgb(
        data, retained_coefficients=retained, idct="int", zrl17=True))


@pytest.mark.parametrize("sampling,ri", CASES)
@pytest.mark.parametrize("exact", [True, False])
def test_k3_equals_plain_and_golden(cuda, sampling, ri, exact, test_image):
    data, pf, rows = prepared(cuda, sampling, ri, test_image, h=17, w=37,
                              exact_idct=exact)
    args = (rows, pf.nseg, pf.tables, pf.op, pf.geom)
    got = counted("planes", F.fused_decode_planes, *args, exact=exact)
    want = F.fused_decode_planes_reference(*args, exact=exact)
    assert [tuple(p.shape) for p in got] == F.plane_shapes(pf.geom)
    coeffs = golden.decode_coefficients(pf.image, dequant=False)
    pix = (golden.idct_pixels_int(coeffs, pf.image) if exact
           else golden.idct_pixels_raw(coeffs, pf.image))
    gold = golden.assemble_planes(pf.image, pix)
    for p, q, r in zip(got, want, gold):
        if exact:
            assert torch.equal(p, q)
            assert np.array_equal(p.cpu().numpy(), r)
        else:
            assert (p.int() - q.int()).abs().max() <= 1
            assert np.abs(p.cpu().numpy().astype(int) - r).max() <= 1
    ycbcr = Decoder(device=cuda, exact_idct=True).decode_ycbcr(data)
    for p, q in zip(ycbcr, golden_planes(pf.image, golden.idct_pixels_int(
            coeffs, pf.image))):
        assert np.array_equal(p, q)


@pytest.mark.parametrize("sampling,ri", CASES)
@pytest.mark.parametrize("exact", [True, False])
def test_planes_epilogue_equals_plain(cuda, sampling, ri, exact, test_image):
    """E over K3's planes, nearest and fancy, equals its plain twin byte for
    byte: one frame, the frame from planes that start 3 bytes off a word, a
    batch of two frames that differ, and (4:2:0, 4:4:0) a band of the planes
    with halo rows above and below and with ``valid``."""
    data, pf, rows = prepared(cuda, sampling, ri, test_image, h=17, w=37,
                              exact_idct=exact)
    g = pf.geom
    planes = F.fused_decode_planes(rows, pf.nseg, pf.tables, pf.op, g,
                                   exact=exact)
    odd = []
    for p in planes:
        buf = torch.zeros(p.numel() + 8, dtype=torch.uint8, device=cuda)
        at = (-buf.data_ptr()) % 4 + 3
        odd.append(buf[at:at + p.numel()].view(p.shape).copy_(p))
    dec = Decoder(device=cuda, exact_idct=exact)
    pf2 = dec.prepare(encoder.encode(
        test_image(17, 37, "noise", seed=1), sampling=sampling, quality=90,
        restart_interval_mcus=ri))
    batch = [torch.stack([p, q]) for p, q in zip(planes, F.fused_decode_planes(
        dec.upload(pf2), pf2.nseg, pf2.tables, pf2.op, g, exact=exact))]
    for fancy in (False, True):
        kw = dict(samplings=g.samplings, width=g.width, height=g.height,
                  fancy=fancy, rgb=g.rgb)
        want = C.finalize_planes_reference(planes, **kw)
        assert torch.equal(counted("epilogue", C.finalize_planes, planes,
                                   **kw), want)
        assert torch.equal(counted("epilogue", C.finalize_planes, odd, **kw),
                           want)
        assert torch.equal(counted("epilogue", C.finalize_planes, batch, **kw),
                           C.finalize_planes_reference(batch, **kw))
    max_v = max(v for _, v in g.samplings)
    if max_v == 1 or len(planes) == 1:
        return
    # Chroma rows [1, 3) with the rows around them, then [2, n) ending in
    # two rows of content and noise under it.
    n = planes[1].shape[0]
    for lo, hi, valid in ((1, 3, None), (2, n, 2)):
        part = [p[lo * v:hi * v].contiguous() for p, (_, v)
                in zip(planes, g.samplings)]
        halos = [None] + [(p[lo - 1].contiguous(),
                           p[hi].contiguous() if hi < n else None, valid)
                          for p in planes[1:]]
        kw = dict(samplings=g.samplings, width=g.width, height=2 * (hi - lo),
                  fancy=True, rgb=g.rgb, halos=halos)
        assert torch.equal(counted("epilogue", C.finalize_planes, part, **kw),
                           C.finalize_planes_reference(part, **kw))


@pytest.mark.parametrize("sampling,ri", CASES)
@pytest.mark.parametrize("k", [1, 2, 4])
def test_k2s_within_one_of_plain_and_golden(cuda, sampling, ri, k,
                                            test_image):
    data, pf, rows = prepared(cuda, sampling, ri, test_image, h=17, w=37)
    lq_k = D.scaled_operators(D.qz_by_slot_array(pf.image), k, device=cuda)
    args = (rows, pf.nseg, pf.tables, lq_k, pf.geom, k)
    got = as_rgb(counted("scaled", F.fused_decode_scaled, *args)).astype(int)
    want = as_rgb(F.fused_decode_scaled_reference(*args))
    gold = golden.decode_rgb(data, scale_blocks=k)
    assert got.shape == want.shape == gold.shape
    assert np.abs(got - want).max() <= 1
    assert np.abs(got - gold).max() <= 1


# (sampling, ri, h, w): segment counts of 32 j + 1 whose last, short
# interval is a block's first segment (4:2:2 MCUs of 16 x 8: 65 MCUs at
# ri 2, 162 at ri 5), one where it is not (121 MCUs at ri 3, 41 segments),
# 27 segments of 4:2:0 at ri 1, and one segment a frame (no restart
# interval: a row longer than the row cache's 64 words).
K1_CASES = [("422", 2, 40, 208), ("422", 5, 72, 288), ("422", 3, 88, 176),
            ("420", 1, 40, 144), ("422", None, 24, 40), ("gray", None, 24, 40)]


@pytest.mark.parametrize("sampling,ri,h,w", K1_CASES)
def test_k1_writes_every_mcu_and_zero_padding(cuda, sampling, ri, h, w,
                                              test_image):
    """K1 into an output filled with -7 first: every element is written,
    the MCUs past a short final interval with zeros, and the rest equals the
    plain K1 and golden's coefficients."""
    data, pf, rows = prepared(cuda, sampling, ri, test_image, h=h, w=w)
    g = pf.geom
    out = torch.full((pf.nseg, g.ri, len(g.du_to_comp), 64), -7,
                     dtype=torch.int32, device=cuda)
    _build.launch("compeg_entropy_decode", rows, pf.tables.packed, out,
                  params=F._params(rows, pf.nseg, pf.tables, g))
    torch.cuda.synchronize()
    args = (rows, pf.nseg, pf.tables, g.ri, g.total_mcus, g.du_to_comp)
    assert torch.equal(out, E.entropy_decode_reference(*args))
    short = g.total_mcus - (pf.nseg - 1) * g.ri
    assert (out[-1, short:] == 0).all()
    if ri is None:
        assert rows.shape[1] > 64
    else:
        assert pf.nseg % 32 != 0
        assert short < g.ri or ri == 1
    assert np.array_equal(
        E.coefficients_natural_order(out, g.total_mcus).cpu().numpy(),
        golden.decode_coefficients(pf.image, dequant=False))
    got = counted("entropy", E.entropy_decode, *args)
    assert torch.equal(got, out)


@pytest.mark.parametrize("sampling,h,w", [("420", 18, 38), ("422", 18, 38),
                                          ("444", 17, 37), ("411", 18, 38)])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_k2s_on_ragged_rasters(cuda, sampling, h, w, k, test_image):
    """K2s where neither side is a whole number of MCUs, against the plain
    K2s and golden within 1."""
    data, pf, rows = prepared(cuda, sampling, 1, test_image, h=h, w=w)
    lq_k = D.scaled_operators(D.qz_by_slot_array(pf.image), k, device=cuda)
    args = (rows, pf.nseg, pf.tables, lq_k, pf.geom, k)
    got = as_rgb(counted("scaled", F.fused_decode_scaled, *args)).astype(int)
    want = as_rgb(F.fused_decode_scaled_reference(*args))
    gold = golden.decode_rgb(data, scale_blocks=k)
    assert got.shape == want.shape == gold.shape == (-(-h * k // 8),
                                                     -(-w * k // 8), 3)
    assert np.abs(got - want).max() <= 1
    assert np.abs(got - gold).max() <= 1


@pytest.mark.parametrize("w", [36, 38, 40, 129])
@pytest.mark.parametrize("sampling", ["422", "420", "411", "gray"])
def test_rgba_store_at_whole_and_ragged_quads(cuda, sampling, w, test_image):
    """Rasters whose rows are whole 16-byte quads (the vector store) and
    ones that are not (word by word, the right edge checked): K2 and K2s
    within 1 of their plain twins, K2x equal to its own and to golden."""
    data, pf, rows = prepared(cuda, sampling, 1, test_image, h=19, w=w)
    args = (rows, pf.nseg, pf.tables, pf.op, pf.geom)
    got = counted("fused", F.fused_decode_rgba, *args)
    want = F.fused_decode_rgba_reference(*args)
    assert np.abs(as_rgb(got).astype(int) - as_rgb(want)).max() <= 1
    assert ((got.cpu().numpy() >> 24) & 0xFF == 0xFF).all()
    _, pfx, _ = prepared(cuda, sampling, 1, test_image, h=19, w=w,
                         exact_idct=True)
    args = (rows, pfx.nseg, pfx.tables, pfx.op, pfx.geom)
    gotx = counted("fused_exact", F.fused_decode_rgba_exact, *args)
    assert torch.equal(gotx, F.fused_decode_rgba_exact_reference(*args))
    assert np.array_equal(as_rgb(gotx), golden.decode_rgb(data, idct="int"))
    for k in (1, 2, 4):
        lq_k = D.scaled_operators(D.qz_by_slot_array(pf.image), k, device=cuda)
        args = (rows, pf.nseg, pf.tables, lq_k, pf.geom, k)
        gots = as_rgb(counted("scaled", F.fused_decode_scaled, *args))
        wants = as_rgb(F.fused_decode_scaled_reference(*args))
        assert gots.shape == wants.shape
        assert np.abs(gots.astype(int) - wants).max() <= 1


def test_zigzag_table_mirrors_compeg_tables():
    """csrc/int_idct.cuh's kZigzag is compeg_tpu.tables.ZIGZAG."""
    path = os.path.join(_build.CSRC, "int_idct.cuh")
    with open(path) as f:
        body = re.search(r"kZigzag\[64\] = \{(.*?)\};", f.read(), re.S)[1]
    assert [int(v) for v in re.findall(r"\d+", body)] == ZIGZAG.tolist()


def test_entry_points_are_defined_in_the_source():
    """Every C entry point the binding declares exists in csrc/decode.cu,
    csrc/relayout.cu or csrc/epilogue.cu with as many pointer arguments,
    plus its params struct and the stream."""
    src = {}
    for name in ("decode.cu", "relayout.cu", "epilogue.cu"):
        with open(os.path.join(_build.CSRC, name)) as f:
            src[name] = f.read()
    for name, n in _build.ENTRY_POINTS.items():
        if name.startswith("compeg_relayout_"):
            text, struct = src["relayout.cu"], "RelayoutParams"
        elif name == "compeg_planes_epilogue":
            text, struct = src["epilogue.cu"], "EpilogueParams"
        else:
            text, struct = src["decode.cu"], "DecodeParams"
        sig = re.search(name + r"\((.*?)\)", text, re.S)[1]
        args = [a for a in sig.split(",")]
        assert len(args) == n + 2, name
        assert struct in args[n] and "stream" in args[n + 1], name
    # ... and the sources define no entry point the binding lacks.
    defined = set(re.findall(r"^int (compeg_\w+)\(", "".join(src.values()),
                             re.M))
    assert defined == set(_build.ENTRY_POINTS)


def test_params_mirror_the_c_struct():
    """The ctypes block must list the C struct's fields in order: a
    mismatch would misread every launch parameter on the card."""
    path = os.path.join(_build.CSRC, "entropy.cuh")
    with open(path) as f:
        body = re.search(r"struct DecodeParams \{(.*?)\};", f.read(), re.S)[1]
    c_fields = re.findall(r"^\s*int (\w+)(?:\[(\d+)\])?;", body, re.M)
    py_fields = [(n, getattr(t, "_length_", 1)) for n, t in
                 _build.DecodeParams._fields_]
    assert [(n, int(k or 1)) for n, k in c_fields] == py_fields


def test_relayout_params_mirror_the_c_struct():
    with open(os.path.join(_build.CSRC, "relayout.cu")) as f:
        body = re.search(r"struct RelayoutParams \{(.*?)\};", f.read(),
                         re.S)[1]
    c_fields = re.findall(r"^\s*long long (\w+);", body, re.M)
    assert c_fields == [n for n, _ in _build.RelayoutParams._fields_]
    assert all(t is ctypes.c_int64 for _, t in _build.RelayoutParams._fields_)
    assert set(_build.LAUNCHES) >= {"interleave", "swap_crop", "stack",
                                    "spread_merge", "copy_shift"}


def test_params_of_a_batch():
    one = _build.make_params(7, 3, 2, 13, (0, 0, 1, 2),
                             samplings=((2, 1), (1, 1), (1, 1)))
    assert (one.frames, one.frame_rows) == (1, 0)
    four = _build.make_params(7, 3, 2, 13, (0, 0, 1, 2),
                              samplings=((2, 1), (1, 1), (1, 1)), frames=4,
                              frame_rows=1024)
    assert (four.frames, four.frame_rows, four.nseg) == (4, 1024, 7)


def test_params_of_a_banded_launch():
    """A launch carries no gate unless it is banded (bands = 0: every
    frame holds total_mcus); a gate sets the image's MCUs, the bands of a
    frame in the launch and the first one's index, and refuses a launch
    with no bands."""
    one = _build.make_params(7, 3, 2, 13, (0, 0, 1, 2),
                             samplings=((2, 1), (1, 1), (1, 1)))
    assert (one.bands, one.band0, one.image_mcus) == (0, 0, 0)
    gate = F.BandGate(image_mcus=40, bands=2, first=2)
    p = _build.make_params(7, 3, 2, 14, (0, 0, 1, 2),
                           samplings=((2, 1), (1, 1), (1, 1)), frames=6,
                           frame_rows=8, gate=gate)
    assert (p.image_mcus, p.bands, p.band0) == (40, 2, 2)
    # bands of 14 MCUs of a 40-MCU image: 14, 14, 12, then none; a rank
    # holding bands 2 and 3 of three frames
    assert [F.BandGate(40, 4).mcus(14, f) for f in range(4)] == [14, 14, 12, 0]
    assert [gate.mcus(14, f) for f in range(6)] == [12, 0] * 3
    with pytest.raises(ValueError, match="band"):
        _build.make_params(7, 3, 2, 14, (0,), samplings=((1, 1),),
                           gate=F.BandGate(40, 0))


def test_params_layout_of_420():
    p = _build.make_params(7, 3, 2, 13, (0, 0, 0, 0, 1, 2),
                           samplings=((2, 2), (1, 1), (1, 1)), width=40,
                           height=24, width_mcus=3)
    assert (p.dus, p.ncomp) == (6, 3)
    assert (p.zrl17, p.blk, p.zlen) == (0, 8, 64)  # the defaults
    assert list(p.comp_slot) == [0, 4, 5]
    assert list(p.du_to_comp) == [0, 0, 0, 0, 1, 2]
    with pytest.raises(ValueError):
        _build.make_params(1, 1, 1, 1, (0,) * 7, samplings=((1, 1),))


def test_cpu_tensors_take_the_plain_version(test_image):
    data, pf, rows = prepared("cpu", "422", 2, test_image)
    args = (rows, pf.nseg, pf.tables, pf.op, pf.geom)
    before = dict(_build.LAUNCHES)
    assert torch.equal(F.fused_decode_rgba(*args),
                       F.fused_decode_rgba_reference(*args))
    assert _build.LAUNCHES == before  # no kernel launched


def test_wrappers_check_their_inputs(test_image):
    data, pf, rows = prepared("cpu", "422", 1, test_image)
    g = pf.geom
    with pytest.raises(ValueError, match="int32"):
        E.entropy_decode(rows.to(torch.int64), pf.nseg, pf.tables, g.ri,
                         g.total_mcus, g.du_to_comp)
    with pytest.raises(ValueError, match="fewer than"):
        E.entropy_decode(rows[:1], pf.nseg, pf.tables, g.ri, g.total_mcus,
                         g.du_to_comp)
    with pytest.raises(ValueError, match="lq_t"):
        F.fused_decode_rgba(rows, pf.nseg, pf.tables, pf.op[:1], g)


# -- batches, streams and relayouts on the card ------------------------------

BATCH_CASES = [("422", 1, 48, 128), ("422", 5, 16, 48), ("420", 5, 40, 136),
               ("444", 3, 24, 40), ("gray", 1, 17, 37)]


def batch_frames(sampling, ri, h, w, test_image, n=4):
    return [encoder.encode(test_image(h, w, "noise", seed=s),
                           sampling=sampling, quality=90,
                           restart_interval_mcus=ri) for s in range(n)]


@pytest.mark.parametrize("sampling,ri,h,w", BATCH_CASES)
@pytest.mark.parametrize("mode", ["float", "exact", "fancy"])
def test_batched_kernels_equal_the_single_frame_launches(
        cuda, mode, sampling, ri, h, w, test_image):
    """One launch for the batch: every frame equals its own single-frame
    launch bit for bit, segment counts that are no multiple of 32 and short
    last intervals included, and the exact modes equal golden."""
    frames = batch_frames(sampling, ri, h, w, test_image)
    knobs = {"float": {}, "exact": {"exact_idct": True},
             "fancy": {"exact_idct": True, "fancy_upsampling": True}}[mode]
    key = {"float": "fused", "exact": "fused_exact",
           "fancy": ("planes", "epilogue")}[mode]
    bdec = BatchDecoder(device=cuda, **knobs)
    out = counted(key, lambda: bdec.decode_prepared(
        bdec.prepare_batch(frames)))
    dec = Decoder(device=cuda, **knobs)
    for i, f in enumerate(frames):
        assert torch.equal(out[i], dec.decode_prepared(dec.prepare(f))), i
    rgb = bdec.to_rgb(out)
    assert not np.array_equal(rgb[0], rgb[1])
    if mode == "exact":
        for i, f in enumerate(frames):
            assert np.array_equal(rgb[i], golden.decode_rgb(f, idct="int"))
    if mode == "float":
        for i, f in enumerate(frames):
            d = np.abs(rgb[i].astype(int) - golden.decode_rgb(f).astype(int))
            assert d.max() <= 1


@pytest.mark.parametrize("mode", ["float", "exact", "planes"])
def test_banded_kernels_gate_each_frame_like_their_twins(cuda, mode,
                                                         test_image):
    """Two frames of 56 x 48 4:4:4 at Ri = 5 in 3 bands (30, 12 and 0 MCUs
    of the image) with random words in the row of every gated segment, in
    one launch under the band gate: every live MCU row of every band frame
    equals the plain twin given that frame's MCU count (K2 within 1)."""
    from compeg_tpu_torch import analyze

    data = encoder.encode(test_image(56, 48, "noise"), sampling="444",
                          quality=90, restart_interval_mcus=5)
    exact = mode != "float"
    pf = Decoder(device=cuda, exact_idct=exact).prepare(data)
    bf = SH.prepare_banded(analyze(data), 3)
    rows, _ = SH.stack_banded([bf] * 2)
    gated = bf.seg_mcus == 0
    rows[:, gated] = np.random.default_rng(9).integers(
        -2 ** 31, 2 ** 31, rows[:, gated].shape, dtype=np.int64)
    flat = torch.from_numpy(rows.reshape(6, bf.nseg, -1)).to(cuda)
    bg = SH.band_geometry(pf.geom, bf.band_rows)
    gate = SH.band_gate(pf.geom, 3, 0)
    args = (flat, bf.nseg, pf.tables, pf.op, bg)
    if mode == "planes":
        got = counted("planes", F.fused_decode_planes, *args, exact=True,
                      gate=gate)
    elif exact:
        got = counted("fused_exact", F.fused_decode_rgba_exact, *args, gate)
    else:
        got = counted("fused", F.fused_decode_rgba, *args, gate)
    counts = [gate.mcus(bg.total_mcus, f) for f in range(6)]
    assert counts == [30, 12, 0] * 2
    for f, m in enumerate(counts):
        live = m // bg.width_mcus  # MCU rows of the band inside the image
        one = (flat[f], bf.nseg, pf.tables, pf.op, bg)
        if mode == "planes":
            twin = F.fused_decode_planes_reference(*one, True, m)
            for c, (_, v) in enumerate(bg.samplings):
                n = live * 8 * v
                assert torch.equal(got[c][f][:n], twin[c][:n]), (f, c)
        elif exact:
            twin = F.fused_decode_rgba_exact_reference(*one, m)
            assert torch.equal(got[f][:live * 8], twin[:live * 8]), f
        else:
            twin = F.fused_decode_rgba_reference(*one, m)
            d = np.abs(as_rgb(got[f][:live * 8]).astype(int)
                       - as_rgb(twin[:live * 8]).astype(int))
            assert d.size == 0 or d.max() <= 1, f


def test_stream_on_the_card_yields_each_frame_in_order(cuda, test_image):
    """Frames that differ, more of them than staging buffers, through the
    pinned ring, the copy stream and the readback stream."""
    base = batch_frames("422", 1, 48, 128, test_image, n=5)
    frames = [base[i % 5] for i in range(40)]
    dec = Decoder(device=cuda)
    want = [dec.decode(f) for f in base]
    for threads, depth in ((1, 1), (3, 2), (8, 4)):
        sd = StreamDecoder(device=cuda, prepare_threads=threads, depth=depth)
        before = _build.LAUNCHES["fused"]
        got = list(sd.decode_iter_rgb(frames))
        assert _build.LAUNCHES["fused"] == before + 40
        assert len(got) == 40
        for i, g in enumerate(got):
            assert np.array_equal(g, want[i % 5]), (threads, depth, i)
        dev = [sd.to_rgb(o) for o in sd.decode_iter(frames[:7])]
        assert all(np.array_equal(g, want[i % 5]) for i, g in enumerate(dev))


def test_relayout_kernels_equal_numpy_and_count_their_launches(cuda):
    before = dict(_build.LAUNCHES)
    results = exp_relayout.probes(cuda, reps=1, groups=2)
    assert all(r["ok"] for r in results), [r["probe"] for r in results
                                           if not r["ok"]]
    for key in ("interleave", "swap_crop", "stack", "spread_merge"):
        assert _build.LAUNCHES[key] > before[key], key


@pytest.mark.parametrize("x,l,n", [(16, 128, 5), (1, 128, 3), (33, 70, 2),
                                   (64, 31, 4), (7, 5, 9)])
def test_relayout_transposes_at_ragged_sizes(cuda, x, l, n):
    """Sizes that no tile of the plan divides, against the plain versions
    (exact)."""
    v = torch.randint(0, 1 << 24, (n, 3, x, l), dtype=torch.int32,
                      device=cuda)
    got = counted("interleave", R.relayout_interleave, v)
    assert torch.equal(got, R.relayout_interleave_reference(v))
    strided = v[:, 1]
    got = counted("interleave", R.relayout_interleave, strided)
    assert torch.equal(got, R.relayout_interleave_reference(strided))
    stk = v.reshape(n, 3, 1, x, l)
    assert torch.equal(counted("stack", R.relayout_stack, stk),
                       R.relayout_stack_reference(stk))
    a, b = v[0, 0], v[1, 2]
    assert torch.equal(counted("spread_merge", R.relayout_spread_merge, a, b,
                               x),
                       R.relayout_spread_merge_reference(a, b, x))


@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("n,l", [(64, 256), (1, 4095), (33, 70), (3, 6),
                                 (540, 3840)])
def test_copy_and_spread_at_every_alignment(cuda, offset, n, l):
    """The 16-byte kernels, the copy's shift kernel and the spread's word
    kernel, whichever the pointers and lengths select, against torch's own
    copy and the plain spread and merge: inputs that start 0 to 4 words off
    a 16-byte boundary, contiguous and with strided rows, lengths that are
    and are not whole vectors."""
    pad = 4
    base = torch.randint(0, 1 << 24, (2 * n * (l + pad) + 8,),
                         dtype=torch.int32, device=cuda)
    flat = base[offset:offset + n * l].reshape(n, l)
    strided = base[offset:offset + n * (l + pad)].reshape(n, l + pad)[:, :l]
    rest = base[n * (l + pad) + 4:]
    others = (rest[:n * l].reshape(n, l),
              rest[:n * (l + pad)].reshape(n, l + pad)[:, :l])
    for a, other in zip((flat, strided), others):
        vec = R.spread_merge_route(a.data_ptr(), 0, n, l, 1, a.stride(0))
        flat_rows = n == 1 or a.stride(0) == l
        assert (vec == "vec") == (offset % 4 == 0 and (
            (n * l) % 4 == 0 if flat_rows else l % 4 == 0))
        got = counted("spread_merge" if vec == "vec" else "copy_shift",
                      R.relayout_copy, a)
        assert got.is_contiguous() and torch.equal(got, a)
        for x in (2, 16):
            assert torch.equal(
                counted("spread_merge", R.relayout_spread_merge, a, other, x),
                R.relayout_spread_merge_reference(a, other, x))


@pytest.mark.parametrize("h,w", [(2160, 3840), (100, 2048), (65, 2049),
                                 (1, 1)])
def test_swap_crop_kernel_equals_plain_at_partial_edges(cuda, h, w):
    x = 16
    n_tr = -(-h // 64)
    n_tc = -(-w // (x * 128))
    slab = torch.randint(0, 1 << 24, (n_tr, 64, n_tc * x * 128),
                         dtype=torch.int32, device=cuda)
    got = counted("swap_crop", R.relayout_swap_crop, slab, x, h, w)
    assert torch.equal(got, R.relayout_swap_crop_reference(slab, x, h, w))
    assert torch.equal(R.relayout_swap_crop(R.swap_crop_inverse(got, x, 64),
                                            x, h, w), got)


def test_trace_device_ms_times_the_decode_on_the_card(cuda, test_image):
    """The card's busy time, as the JAX package's XLA Ops lane sum: K2 is
    in the total, the pageable upload is a row of its own outside it, and
    the total is below the CUDA-event span around the same calls."""
    from compeg_tpu_torch import profiling

    data, pf, rows = prepared(cuda, "422", 1, test_image, h=48, w=128)
    dec = Decoder(device=cuda)
    pf = dec.prepare(data)
    total, rows_ = profiling.trace_device_ms(
        lambda: dec.decode_prepared(pf), frames=3)
    kernels = [r for r in rows_ if "fused_decode_kernel" in r[2]]
    uploads = [r for r in rows_ if "HtoD" in r[2]]
    assert len(kernels) == 1 and kernels[0][1] == 1 and uploads
    others = sum(ms_ for ms_, _, name in rows_
                 if not any(d in name for d in profiling.HOST_COPIES))
    assert total == pytest.approx(others) and total >= kernels[0][0] > 0
    busy = profiling.trace_device(lambda: dec.decode_prepared(pf), frames=3)
    assert 0 < busy.total_ms < busy.event_ms
    assert busy.counted.get("kernel", 0) + busy.counted.get("Kernel", 0) >= 3
    print("trace_device_ms:", total, rows_[:3], busy.event_ms)
    profiling.hard_sync(dec.decode_prepared(pf))


def test_burst_ms_times_the_card_not_the_host(cuda):
    """Launches enqueued behind the spin kernel run back to back: a copy
    of 33.5 MB reads well under the host's tens of microseconds per wrapper
    call plus the kernel, and more than its bytes over the card's memory
    rate."""
    from compeg_tpu_torch import profiling

    a = torch.randint(0, 1 << 24, (2160, 3840), dtype=torch.int32,
                      device=cuda)
    R.relayout_copy(a)
    ms = min(profiling.burst_ms(lambda i: R.relayout_copy(a)) for _ in range(5))
    assert 2 * a.numel() * 4 / 3.35e12 * 1e3 < ms < 0.1
    print("burst_ms of the 4K copy:", ms)


# -- the staged tier, the plane store's routes and the interleave's, on the card


@pytest.mark.parametrize("sampling,ri", CASES)
@pytest.mark.parametrize("fancy", [False, True])
def test_staged_tier_runs_k1_and_equals_golden(cuda, sampling, ri, fancy,
                                               test_image):
    """Decoder(fused=False): one launch of K1 and one of E and no fused
    kernel; with exact_idct golden's integer RGB (nearest) or the fused
    fancy decode's bytes; the float decode within 1 of golden."""
    data = encoder.encode(test_image(17, 37, "noise"), sampling=sampling,
                          quality=90, restart_interval_mcus=ri)
    dec = Decoder(device=cuda, fused=False, exact_idct=True,
                  fancy_upsampling=fancy)
    got = counted(("entropy", "epilogue"), dec.decode, data)
    if fancy:
        want = Decoder(device=cuda, exact_idct=True,
                       fancy_upsampling=True).decode(data)
    else:
        want = golden.decode_rgb(data, idct="int")
    assert np.array_equal(got, want)
    flt = counted(("entropy", "epilogue"),
                  Decoder(device=cuda, fused=False).decode, data)
    if not fancy:
        assert np.abs(flt.astype(int) - golden.decode_rgb(data)).max() <= 1


def test_staged_batch_on_the_card(cuda, test_image):
    frames = batch_frames("420", 5, 40, 136, test_image)
    bdec = BatchDecoder(device=cuda, fused=False, exact_idct=True)
    before = dict(_build.LAUNCHES)
    got = bdec.decode(frames)
    want = dict(before, entropy=before["entropy"] + len(frames),
                epilogue=before["epilogue"] + len(frames))
    # a K1 and an E launch per frame, no fused kernel
    assert _build.LAUNCHES == want
    for i, f in enumerate(frames):
        assert np.array_equal(got[i], golden.decode_rgb(f, idct="int")), i


@pytest.mark.parametrize("offset,routes", [(0, {"16-byte", "8-byte"}),
                                           (8, {"8-byte"}), (16, None),
                                           (1, {"byte"}), (4, {"byte"})])
@pytest.mark.parametrize("sampling,ri,h,w", [("422", 1, 17, 37),
                                             ("420", 3, 18, 38),
                                             ("411", 1, 24, 40),
                                             ("444", 2, 17, 37)])
@pytest.mark.parametrize("exact", [True, False])
def test_plane_store_at_every_alignment(cuda, exact, sampling, ri, h, w,
                                        offset, routes, test_image):
    """K3 into planes that start 0, 1, 4, 8 and 16 bytes off a 16-byte
    boundary: the 16-byte, 8-byte and byte-wise stores, each equal to the
    planes the wrapper allocates itself and (integer IDCT) to the plain K3,
    and nothing written outside."""
    data, pf, rows = prepared(cuda, sampling, ri, test_image, h=h, w=w,
                              exact_idct=exact)
    args = (rows, pf.nseg, pf.tables, pf.op, pf.geom)
    want = counted("planes", F.fused_decode_planes, *args, exact=exact)
    if exact:
        for p, q in zip(want, F.fused_decode_planes_reference(*args,
                                                              exact=True)):
            assert torch.equal(p, q)
    shapes = F.plane_shapes(pf.geom)
    bufs = [torch.full((hh * ww + 64,), 7, dtype=torch.uint8, device=cuda)
            for hh, ww in shapes]
    out = []
    for b, (hh, ww) in zip(bufs, shapes):
        start = (-b.data_ptr()) % 16 + offset
        out.append(b[start:start + hh * ww].reshape(hh, ww))
    got_routes = {F.plane_store_route(o.data_ptr(), hs)
                  for o, (hs, _) in zip(out, pf.geom.samplings)}
    if routes is not None:
        assert got_routes <= routes | {"8-byte"} and got_routes & routes
    got = counted("planes", F.fused_decode_planes, *args, exact=exact,
                  out=out)
    for g, q in zip(got, want):
        assert torch.equal(g, q)
    for b, o in zip(bufs, out):
        start = o.data_ptr() - b.data_ptr()
        assert (b[:start] == 7).all() and (b[start + o.numel():] == 7).all()


@pytest.mark.parametrize("name,make,route", [
    ("aligned", lambda b: b[:8 * 16 * 128].reshape(8, 16, 128), "vec"),
    ("one word off", lambda b: b[1:1 + 8 * 16 * 128].reshape(8, 16, 128),
     "word"),
    ("X = 3", lambda b: b[:8 * 3 * 128].reshape(8, 3, 128), "word"),
    ("X = 4", lambda b: b[:8 * 4 * 128].reshape(8, 4, 128), "vec"),
    ("X = 32", lambda b: b[:8 * 32 * 64].reshape(8, 32, 64), "vec"),
    ("X = 64", lambda b: b[:8 * 64 * 32].reshape(8, 64, 32), "word"),
    ("L = 130", lambda b: b[:8 * 16 * 130].reshape(8, 16, 130), "word"),
    ("strided batch", lambda b: b[:8 * 4 * 16 * 128].reshape(
        8, 4, 16, 128)[:, 1], "vec"),
    ("5-d", lambda b: b[:2 * 2 * 2 * 16 * 128].reshape(2, 2, 2, 16, 128),
     "vec"),
])
def test_interleave_on_each_route(cuda, name, make, route):
    base = torch.randint(0, 1 << 24, (8 * 4 * 16 * 128 + 8,),
                         dtype=torch.int32, device=cuda)
    v = make(base)
    got = counted("interleave", R.relayout_interleave, v)
    assert torch.equal(got, R.relayout_interleave_reference(v))
    x, l = v.shape[-2:]
    batch = v.reshape(-1, x, l) if v.is_contiguous() else v
    assert R.interleave_route(batch.data_ptr(), got.data_ptr(),
                              batch.shape[0], x, l, batch.stride(0)) == route
    if v.dim() == 5:
        stacked = counted("interleave", R.relayout_interleave, v, True)
        assert torch.equal(stacked, R.relayout_interleave_reference(v, True))


# -- the word tile and the swap's two routes, at every alignment -------------


def launch_at(entry, key, *tensors, **fields):
    """Launch a relayout entry point into its last tensor (any view), as the
    wrapper would but with the destination of the caller's choosing; one
    launch."""
    before = _build.LAUNCHES[key]
    R._launch(entry, key, *tensors, **fields)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == before + 1


@pytest.mark.parametrize("l", [1, 126, 130])
@pytest.mark.parametrize("x", [1, 2, 3, 12, 16, 64, 65, 2051])
def test_word_tile_at_every_alignment(cuda, x, l):
    """P1's word route with input and output 0 to 3 words past a 16-byte
    boundary, contiguous and a ragged batch stride apart, against the plain
    version; the words around the output stay untouched."""
    n = 3
    for stride in (x * l, x * l + 5):
        base = torch.randint(0, 1 << 24, (n * stride + 8,), dtype=torch.int32,
                             device=cuda)
        for in_off in range(4):
            mats = base[in_off:in_off + n * stride].reshape(n, stride)[
                :, :x * l].reshape(n, x, l)
            want = R.relayout_interleave_reference(mats)
            for out_off in range(4):
                buf = torch.full((n * x * l + 8,), 7, dtype=torch.int32,
                                 device=cuda)
                out = buf[out_off:out_off + n * x * l].reshape(n, l * x)
                vec = R.interleave_route(mats.data_ptr(), out.data_ptr(), n,
                                         x, l, stride)
                assert vec == "word"
                launch_at("compeg_relayout_interleave", "interleave", mats,
                          out, n=n, x=x, l=l, in_stride=stride, vec=0)
                assert torch.equal(out, want), (stride, in_off, out_off)
                assert (buf[:out_off] == 7).all()
                assert (buf[out_off + n * x * l:] == 7).all()


@pytest.mark.parametrize("n,l,pad", [(1, 4099, 0), (1, 33, 0), (1, 3, 0),
                                     (7, 130, 0), (5, 130, 1), (9, 3, 2),
                                     (2160, 3837, 3), (33, 64, 3),
                                     (1, 2160 * 3840 + 3, 0)])
def test_copy_shift_at_every_alignment(cuda, n, l, pad):
    """The copy's shift route with input and output 0 to 3 words past a
    16-byte boundary, contiguous and rows ``l + pad`` words apart, equal to
    clone(); the words around the output stay untouched. Small copies take
    a vector a thread, the 4K rows and the 4K raster several."""
    stride = l + pad
    base = torch.randint(0, 1 << 24, (n * stride + 8,), dtype=torch.int32,
                         device=cuda)
    for in_off in range(4):
        a = base[in_off:in_off + n * stride].reshape(n, stride)[:, :l]
        for out_off in range(4):
            if (in_off, out_off, pad % 4) == (0, 0, 0) and l % 4 == 0:
                continue  # the 16-byte kernel's
            buf = torch.full((n * l + 8,), 7, dtype=torch.int32, device=cuda)
            out = buf[out_off:out_off + n * l].reshape(n, l)
            assert R.spread_merge_route(a.data_ptr(), out.data_ptr(), n, l, 1,
                                        a.stride(0)) == "shift"
            launch_at("compeg_relayout_spread_merge", "copy_shift", a, a,
                      out, n=n, l=l, x=1, in_stride=a.stride(0), vec=0)
            assert torch.equal(out, a), (in_off, out_off)
            assert (buf[:out_off] == 7).all()
            assert (buf[out_off + n * l:] == 7).all()


@pytest.mark.parametrize("x,h,w,route", [
    (16, 2160, 3840, "vec"), (16, 100, 2052, "vec"), (8, 65, 1028, "vec"),
    (4, 7, 4, "vec"), (32, 9, 4092, "vec"),
    (16, 2160, 3838, "word"), (16, 65, 2049, "word"), (3, 33, 700, "word"),
    (12, 5, 1535, "word"), (1, 3, 1, "word")])
def test_swap_crop_on_each_route(cuda, x, h, w, route):
    """P2 on the route swap_crop_route names, against the plain version:
    whole and cropped edge tiles, and (word route) slab and raster 1 to 3
    words past a 16-byte boundary."""
    n_tr, n_tc = -(-h // 64), -(-w // (x * 128))
    cols = n_tc * x * 128
    big = torch.randint(0, 1 << 24, (n_tr * 64 * cols + 4,),
                        dtype=torch.int32, device=cuda)
    slab = big[:n_tr * 64 * cols].reshape(n_tr, 64, cols)
    want = R.relayout_swap_crop_reference(slab, x, h, w)
    got = counted("swap_crop", R.relayout_swap_crop, slab, x, h, w)
    assert R.swap_crop_route(slab.data_ptr(), got.data_ptr(), x, w) == route
    assert torch.equal(got, want)
    if route == "word":
        for off in (1, 2, 3):
            moved = big[off:off + n_tr * 64 * cols].reshape(n_tr, 64, cols)
            buf = torch.full((h * w + 8,), 7, dtype=torch.int32, device=cuda)
            out = buf[off:off + h * w].reshape(h, w)
            launch_at("compeg_relayout_swap_crop", "swap_crop", moved, out,
                      n=n_tr * 64 * n_tc, x=x, l=R.LANES, tiles=n_tc, h=h,
                      w=w, vec=0)
            assert torch.equal(
                out, R.relayout_swap_crop_reference(moved, x, h, w)), off
            assert (buf[:off] == 7).all() and (buf[off + h * w:] == 7).all()
