"""The port's banded decode (compeg_tpu_torch.parallel) on the CPU.

In one process on device="cpu" (the kernels' plain twins, the 1 x 1
LocalMesh) the banded decode must equal the port's unbanded decode byte for
byte in every mode and cut — the cases of tests/test_sharding.py:53-198 at
64 x 64 or smaller: nearest, exact, fancy, fancy + exact, 4:2:0, an odd
height, empty trailing bands, several bands per shard, and the Ri fallback
cut (Ri not dividing the MCU-row width, a short final interval), and
segments longer than the lanes' T, which the banded decode runs one lane
each, building no lane table. The
halo-aware fancy filter is held to the unsplit one with halos taken by hand.
Two comparisons with the JAX package's decode_batch_sharded on the virtual
CPU mesh of tests/conftest.py (interpret mode), one two-process gloo job
through tools/dryrun_multiproc.py, and multihost's helpers.

The band gate: each band's MCU count equals the JAX package's seg_mcus
summed over the band on both of its layouts (segment by segment on the
linear one), and so does every frame's count of a rank's launch; the plain
twins read no bit of a gated segment, give its MCUs zero coefficients, and
garbage there changes no kept pixel."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from compeg_tpu import encoder  # noqa: E402
import compeg_tpu_torch as T  # noqa: E402
from compeg_tpu_torch.ops import color as C  # noqa: E402
from compeg_tpu_torch.ops import entropy as E  # noqa: E402
from compeg_tpu_torch.ops import fused as F  # noqa: E402
from compeg_tpu_torch.ops import lanes as LN  # noqa: E402
from compeg_tpu_torch.parallel import multihost as MH  # noqa: E402
from compeg_tpu_torch.parallel import sharding as SH  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rgb_of(out: torch.Tensor) -> np.ndarray:
    return out.numpy().view(np.uint8).reshape(*out.shape, 4)[..., :3]


def banded(data, n_bands, batch=2, **knobs):
    """The banded decode of ``batch`` copies of ``data`` on the 1 x 1 mesh,
    as RGB, beside the port's unbanded Decoder with the same knobs. The
    banded decode builds no lane table, however long its segments."""
    made = []
    index = LN.lane_index
    with pytest.MonkeyPatch.context() as m:
        m.setattr(LN, "lane_index", lambda *a: made.append(a) or index(*a))
        out = SH.decode_frames_sharded(
            [data] * batch, SH.make_mesh(1, 1, "cpu"), n_bands,
            decoder=T.BatchDecoder(device="cpu", **knobs))
    assert not made
    return rgb_of(out), T.Decoder(device="cpu", **knobs).decode(data)


CASES = {
    # name: (h, w, sampling, ri, n_bands, kind, knobs)
    "nearest 422": (32, 48, "422", 1, 2, "gradient", {}),
    "odd height": (40, 32, "422", 1, 2, "edges", {}),
    "empty trailing bands": (24, 32, "422", 1, 4, "gradient", {}),
    "420": (32, 32, "420", 1, 2, "gradient", {}),
    "exact 420": (32, 48, "420", 1, 2, "noise", {"exact_idct": True}),
    "fancy 420, 4 bands": (64, 32, "420", 1, 4, "gradient",
                           {"fancy_upsampling": True}),
    "fancy content edge": (48, 32, "420", 1, 4, "gradient",
                           {"fancy_upsampling": True}),
    "fancy + exact, content edge": (48, 32, "420", 1, 4, "noise",
                                    {"fancy_upsampling": True,
                                     "exact_idct": True}),
    "fancy 440": (48, 24, "440", 1, 3, "noise", {"fancy_upsampling": True}),
    "ri=5 fallback": (56, 48, "444", 5, 2, "gradient", {}),
    "ri=5 fallback exact": (56, 48, "444", 5, 3, "noise",
                            {"exact_idct": True}),
    "ri=5 fallback fancy 420": (56, 48, "420", 5, 3, "noise",
                                {"fancy_upsampling": True}),
    "ri=5 aligned": (56, 64, "444", 5, 2, "gradient", {}),
    "gray, ri=3": (40, 24, "gray", 3, 2, "noise", {}),
    # segments of 32 MCUs, which the unbanded decode runs as lanes
    "ri=32, segments past T": (128, 128, "420", 32, 2, "noise",
                               {"fancy_upsampling": True,
                                "exact_idct": True}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_banded_equals_unbanded(name, test_image):
    h, w, sampling, ri, n_bands, kind, knobs = CASES[name]
    data = encoder.encode(test_image(h, w, kind), sampling=sampling,
                          quality=85, restart_interval_mcus=ri)
    assert (ri > LN.split_mcus(2 * n_bands)) == (name == "ri=32, "
                                                 "segments past T")
    got, want = banded(data, n_bands, **knobs)
    assert got.shape == (2, h, w, 3)
    for frame in got:
        assert np.array_equal(frame, want), np.argwhere(frame != want)[:5]


def test_band_rows_follow_the_jax_fallback(test_image):
    """prepare_banded's band height is the JAX package's fallback rule:
    ceil(hm / n_bands) rounded up to Ri / gcd(Ri, wm) MCU rows; its rows are
    the frame's segments cut at restart boundaries."""
    from compeg_tpu import analyze as jax_analyze
    from compeg_tpu.parallel import sharding as JSH

    for h, w, sampling, ri in ((56, 48, "444", 5), (64, 96, "422", 4),
                               (40, 80, "420", 3)):
        data = encoder.encode(test_image(h, w, "noise"), sampling=sampling,
                              restart_interval_mcus=ri)
        img = T.analyze(data)
        assert img.width_mcus % ri  # the JAX fallback layout
        for n_bands in (1, 2, 3, 4, 7):
            jbf = JSH.prepare_banded(jax_analyze(data), n_bands)
            assert jbf.tiling is None
            bf = SH.prepare_banded(img, n_bands)
            assert bf.band_rows == jbf.band_rows, (h, w, ri, n_bands)
            assert bf.rows.shape[:2] == (n_bands, bf.band_rows
                                         * img.width_mcus // ri)
            flat = bf.rows.reshape(-1, bf.rows.shape[2])
            nseg = img.total_restart_intervals
            dec = T.Decoder(device="cpu")
            whole = dec._pack(img)[0].view(np.int32)
            assert np.array_equal(flat[:nseg], whole[:nseg])
            assert not flat[nseg:].any()


GATE_CASES = {
    # name: (h, w, sampling, ri, n_bands); the JAX layout follows from
    # whether Ri divides the MCU-row width
    "tiled 422 Ri 1": (32, 48, "422", 1, 2),
    "tiled 422 Ri 1, an empty band": (24, 32, "422", 1, 4),
    "tiled 420 Ri 2, 5 bands, an empty one": (64, 64, "420", 2, 5),
    "linear 422 Ri 7, short last interval": (64, 160, "422", 7, 3),
    "linear 444 Ri 5, 1 band": (56, 48, "444", 5, 1),
    "linear 444 Ri 5, 3 bands, an empty one": (56, 48, "444", 5, 3),
    "linear 420 Ri 3, 5 bands": (48, 80, "420", 3, 5),
}


@pytest.mark.parametrize("name", list(GATE_CASES))
def test_band_mcus_equal_the_jax_seg_mcus(name, test_image):
    """Every band's MCU count (band_mcus, BandedFrame.band_mcus) is the
    JAX package's seg_mcus summed over the band, on its tiled and its
    linear layout, empty bands included; on the linear layout the port's
    per-segment view equals seg_mcus segment by segment. A rank's launch
    gate gives each of its band frames its band's count, at every seq
    coordinate of every mesh that divides the bands."""
    from compeg_tpu import analyze as jax_analyze
    from compeg_tpu.parallel import sharding as JSH

    h, w, sampling, ri, n_bands = GATE_CASES[name]
    data = encoder.encode(test_image(h, w, "noise"), sampling=sampling,
                          quality=85, restart_interval_mcus=ri)
    img = T.analyze(data)
    jbf = JSH.prepare_banded(jax_analyze(data), n_bands)
    assert (jbf.tiling is not None) == name.startswith("tiled")
    want = jbf.seg_mcus.reshape(n_bands, -1)
    bf = SH.prepare_banded(img, n_bands)
    assert bf.band_rows == jbf.band_rows
    assert np.array_equal(SH.band_mcus(img, n_bands), want.sum(1))
    assert np.array_equal(bf.band_mcus, want.sum(1))
    assert bf.band_mcus.sum() == img.total_mcus
    if "empty" in name:
        assert bf.band_mcus[-1] == 0
    if "short" in name:
        assert img.total_mcus % ri and bf.band_mcus[1] % ri
    if jbf.tiling is None:
        assert np.array_equal(bf.seg_mcus, want[:, :bf.nseg])
        assert not want[:, bf.nseg:].any()
    geom = T.Decoder(device="cpu").prepare(data).geom
    band_total = SH.band_geometry(geom, bf.band_rows).total_mcus
    for n_seq in (k for k in (1, 2, n_bands) if n_bands % k == 0):
        nb_l = n_bands // n_seq
        for s in range(n_seq):
            gate = SH.band_gate(geom, nb_l, s)
            got = [gate.mcus(band_total, f) for f in range(2 * nb_l)]
            assert got == 2 * bf.band_mcus[s * nb_l:(s + 1) * nb_l].tolist()


GATED_MODES = {"nearest": {}, "exact": {"exact_idct": True},
               "fancy": {"fancy_upsampling": True}}


@pytest.mark.parametrize("mode", list(GATED_MODES))
def test_plain_twins_read_no_bits_of_a_gated_segment(mode, test_image,
                                                      monkeypatch):
    """56 x 48 4:4:4 at Ri = 5 in 3 bands of 30 MCUs: the second band
    holds 12 (its third segment 2 of 5 MCUs), the third none. With random
    words in the rows of every gated segment, the banded decode on the CPU
    (the plain twins) decodes each band frame with its own MCU count, reads
    symbols of its live segments only, leaves the gated MCUs' coefficients
    zero, and gives the same pixels as zero rows there and as the unbanded
    decode."""
    knobs = GATED_MODES[mode]
    data = encoder.encode(test_image(56, 48, "noise"), sampling="444",
                          quality=85, restart_interval_mcus=5)
    bf = SH.prepare_banded(T.analyze(data), 3)
    assert bf.band_mcus.tolist() == [30, 12, 0]
    assert bf.seg_mcus[1].tolist() == [5, 5, 2, 0, 0, 0]
    rows, _ = SH.stack_banded([bf] * 2)
    gated = bf.seg_mcus == 0
    junk = rows.copy()
    junk[:, gated] = np.random.default_rng(3).integers(
        -2 ** 31, 2 ** 31, junk[:, gated].shape, dtype=np.int64)
    assert (junk[:, gated] != 0).mean() > 0.99
    pf = T.Decoder(device="cpu", **knobs).prepare(data)

    read, frames = [], []
    symbol, coefficients = E._symbol, F.entropy_decode_reference

    def spy_symbol(flat, width, idx, *args, **kwargs):
        read.append(idx)
        return symbol(flat, width, idx, *args, **kwargs)

    def spy_coefficients(rows, nseg, tables, ri, total_mcus, du_to_comp):
        read.clear()
        out = coefficients(rows, nseg, tables, ri, total_mcus, du_to_comp)
        segs = torch.cat(read).unique().tolist() if read else []
        frames.append((total_mcus, segs, out))
        return out

    monkeypatch.setattr(E, "_symbol", spy_symbol)
    monkeypatch.setattr(F, "entropy_decode_reference", spy_coefficients)

    def decode(r):
        return SH.decode_batch_sharded(
            torch.from_numpy(r), bf.nseg, pf.tables, pf.op,
            mesh=SH.make_mesh(1, 1, "cpu"), geom=pf.geom,
            band_rows=bf.band_rows, exact_idct="exact_idct" in knobs,
            fancy_upsample="fancy_upsampling" in knobs)

    got = decode(junk)
    assert [f[0] for f in frames] == [30, 12, 0] * 2
    for (_, segs, out), mc in zip(frames, np.tile(bf.seg_mcus, (2, 1))):
        assert segs == np.nonzero(mc)[0].tolist()
        for k, m in enumerate(mc):
            assert not out[k, m:].any(), (k, m)
    assert torch.equal(got, decode(rows))
    want = T.Decoder(device="cpu", **knobs).decode(data)
    assert all(np.array_equal(frame, want) for frame in rgb_of(got))


@pytest.mark.parametrize("packer", ["native", "python"])
def test_batch_packs_and_uploads_whole_bands(packer, test_image, monkeypatch):
    """BatchDecoder packs a batch into the rows of whole bands (zero past
    the segments, with either packer) and uploads one rank's band of every
    frame; the stream's tables and IDCT operand are made once and found
    again on the next batch."""
    from compeg_tpu_torch import native

    data = encoder.encode(test_image(56, 48, "noise"), sampling="444",
                          restart_interval_mcus=5)
    img = T.analyze(data)
    n_bands = 3
    nseg_b = SH.band_segments(img, SH.band_rows_for(img, n_bands))
    want = torch.from_numpy(SH.prepare_banded(img, n_bands).rows.reshape(
        n_bands * nseg_b, -1))
    if packer == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip("the native packer is not built here")
    bd = T.BatchDecoder(device="cpu")
    pfs = bd.prepare_batch([data] * 3, n_bands * nseg_b)
    assert pfs[0].packer == packer
    for lo, hi in ((0, nseg_b), (nseg_b, 3 * nseg_b), (2, 2 * nseg_b + 1)):
        got = bd.upload(hi - lo, lo=lo)
        assert got.shape == (3, hi - lo, want.shape[1])
        assert all(torch.equal(frame, want[lo:hi]) for frame in got)
    assert not bd.upload(lo=n_bands * nseg_b).any()
    assert bd.prepare_batch([data] * 2)[0].tables is pfs[0].tables
    assert bd.prepare_batch([data] * 2)[0].op is pfs[0].op


def test_halo_filter_equals_the_unsplit_filter():
    """upsample_fancy_v on slices of a plane, with the rows above and below
    each slice taken by hand, equals the filter over the whole plane; the
    content-edge clamp makes rows past the content invisible to it."""
    rng = np.random.default_rng(5)
    plane = torch.from_numpy(rng.integers(0, 256, (12, 7)).astype(np.int32))
    whole = C.upsample_fancy_v(plane)
    for cuts in ((4, 8), (1, 11), (6,), (3, 4, 5)):
        edges = (0,) + cuts + (12,)
        parts = []
        for lo, hi in zip(edges[:-1], edges[1:]):
            above = plane[lo - 1] if lo > 0 else None
            below = plane[hi] if hi < 12 else None
            parts.append(C.upsample_fancy_v(plane[lo:hi], above, below))
        assert torch.equal(torch.cat(parts), whole), cuts
    # Content ends at row 9 of a 12-row plane whose last rows are garbage:
    # with valid, the content rows equal the filter over the content alone.
    junk = plane.clone()
    junk[9:] = 255 - junk[9:]
    content = C.upsample_fancy_v(plane[:9])
    assert torch.equal(C.upsample_fancy_v(junk, valid=9)[:18], content)
    # ... and so does a slice that holds the content's end, its top halo
    # taken from the slice above.
    got = C.upsample_fancy_v(junk[6:], above=plane[5], valid=3)
    assert torch.equal(got[:6], content[12:])
    # A slice wholly past the content: every row clamps to itself below.
    assert torch.equal(C.upsample_fancy_v(junk[9:], above=plane[8], valid=0)
                       [1::2], (3 * junk[9:] + junk[9:] + 2) >> 2)
    assert not torch.equal(C.upsample_fancy_v(junk)[:18], content)


def _jax_sharded(data, mesh_shape, fancy):
    import jax.numpy as jnp
    from compeg_tpu import analyze as jax_analyze
    from compeg_tpu.ops.fused import rgba_to_rgb_array
    from compeg_tpu.parallel import sharding as JSH
    from compeg_tpu.pipeline import FrameGeometry as JaxGeometry

    meta = jax_analyze(data)
    n_data, n_seq = mesh_shape
    bf = JSH.prepare_banded(meta, n_seq)
    words, seg = JSH.stack_banded([bf] * n_data)
    out = JSH.decode_batch_sharded(
        jnp.asarray(words), jnp.asarray(seg), jnp.asarray(bf.qz_by_slot),
        bf.plan, mesh=JSH.make_mesh(n_data, n_seq),
        geom=JaxGeometry.from_image(meta), band_rows=bf.band_rows,
        tiling=bf.tiling, interpret=True, fancy_upsample=fancy)
    return rgba_to_rgb_array(np.asarray(out))


@pytest.mark.parametrize("case", ["tiled nearest (1, 2)",
                                  "fancy halo (2, 2)"])
def test_banded_equals_the_jax_packages_sharded_decode(case, test_image):
    """The JAX package's decode_batch_sharded on its virtual CPU mesh
    (interpret mode) against the port's banded decode of the same bands:
    within 1 (the float IDCT, as the port's pipeline tests hold it to the
    JAX decode)."""
    if case.startswith("tiled"):
        h, w, sampling, mesh_shape, fancy = 32, 48, "422", (1, 2), False
    else:
        h, w, sampling, mesh_shape, fancy = 64, 32, "420", (2, 2), True
    data = encoder.encode(test_image(h, w, "gradient"), sampling=sampling,
                          quality=85, restart_interval_mcus=1)
    want = _jax_sharded(data, mesh_shape, fancy)
    got, single = banded(data, mesh_shape[1], batch=mesh_shape[0],
                         fancy_upsampling=fancy)
    assert got.shape == want.shape == (mesh_shape[0], h, w, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert all(np.array_equal(f, single) for f in got)


def test_stack_budget_and_refusals(test_image):
    """stack_banded stacks a batch; the device budget is checked for the
    rank's band frames; a mesh larger than one needs a process group, and
    the default device a card."""
    data = encoder.encode(test_image(32, 32, "noise"), sampling="420",
                          restart_interval_mcus=1)
    bf = SH.prepare_banded(T.analyze(data), 4)
    rows, mcus = SH.stack_banded([bf] * 3)
    assert rows.shape == (3, 4) + bf.rows.shape[1:]
    assert np.array_equal(rows[2], bf.rows)
    assert mcus.shape == (3, 4) and np.array_equal(mcus[2], bf.band_mcus)
    with pytest.raises(T.CompegError, match="budget"):
        SH.decode_frames_sharded(
            [data] * 2, SH.make_mesh(1, 1, "cpu"), 2,
            decoder=T.BatchDecoder(device="cpu", max_device_bytes=1 << 10))
    with pytest.raises(T.CompegError, match="process group"):
        SH.make_mesh(2, 1)
    SH.dryrun(1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SH.decode_frames_sharded([data], SH.make_mesh(1, 1))


def test_two_process_gloo_dryrun():
    """A real two-process torch.distributed job (gloo, the CPU): the mesh
    across processes, the halo exchange between ranks, every rank's rows
    equal to a one-process decode."""
    r = subprocess.run(
        [sys.executable, "-m", "compeg_tpu_torch.tools.dryrun_multiproc",
         "--nproc", "2", "--device", "cpu", "--timeout", "240"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, (r.stdout, r.stderr[-3000:])
    assert "multiproc dryrun: OK" in r.stdout
    assert r.stdout.count(": ok") == 2


def test_cuda_ranks_need_a_card_each():
    """--device cuda (the default) runs one NCCL rank a card: the tool and
    init_distributed refuse more ranks than cards instead of falling back
    to the CPU."""
    from compeg_tpu_torch.tools import dryrun_multiproc

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    ranks = max(2, cards + 1)
    with pytest.raises(RuntimeError, match="card"):
        dryrun_multiproc.main(["--nproc", str(ranks)])
    with pytest.raises(RuntimeError, match="card"):
        MH.init_distributed("127.0.0.1:1", ranks, 0)


def test_measure_scaling_shape():
    """measure_scaling drives the decode fn with proportional batches."""
    calls = []

    def decode_fn(n, x):
        calls.append((n, tuple(x.shape)))
        return x * 1

    res = MH.measure_scaling(decode_fn,
                             lambda n: (torch.zeros((2 * n, 4)),), [1, 2],
                             iters=1)
    assert [r[0] for r in res] == [1, 2]
    assert res[0][2] == 1.0  # efficiency baseline
    assert calls[0] == (1, (2, 4)) and calls[-1] == (2, (4, 4))


def test_init_distributed_noop():
    import torch.distributed as dist

    MH.init_distributed()  # single process: must be a no-op
    MH.init_distributed(num_processes=1)
    assert not dist.is_initialized()
    assert isinstance(MH.global_mesh(), SH.LocalMesh)
