"""Lanes inside a restart segment: the lane index (``ops/lanes.py``, kernel
L of csrc/decode.cu) and the fused kernels' LANES launch.

On the CPU: the plain lane table is the state the encoder recorded at every
L-th MCU (bit and DC predictors), on the benchmark's restart-less frames,
frames with no DRI and with a 120-MCU interval, MCU counts that are no
multiple of L, one MCU, gray, 4:2:2 and 4:4:4; a numpy walk of the kernel's
three passes (guess, repair and scan, index) gives that table on every frame,
``zrl_compat``, a truncated and a random scan included, at the kernel's
subsequence length and at short ones where the guesses fail; decoding lane
by lane from the table gives the whole segment's coefficients, planes and
the benchmark reference's pixels; ``Decoder.decode_rows`` and
``Decoder.decode_ycbcr`` route a segment into lanes by its length alone. On
the card (skipped without one), kernel L gives the plain table bit for bit,
K2, K2x and K3 on lanes give the pixels of the one-lane launch, and both
entry points give the benchmark reference's pixels and planes.

This file imports neither jax nor ``compeg_tpu``: on the card, run it alone
(``python -m pytest tests/test_torch_lanes.py --noconftest``)."""

import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from compeg_tpu_torch import Decoder  # noqa: E402
from compeg_tpu_torch import profiling as P  # noqa: E402
from compeg_tpu_torch.ops import _build  # noqa: E402
from compeg_tpu_torch.ops import entropy as E  # noqa: E402
from compeg_tpu_torch.ops import fused as F  # noqa: E402
from compeg_tpu_torch.ops import lanes as LN  # noqa: E402
from perfbench.inputs import encoder as PE  # noqa: E402
from perfbench.inputs import frames as FR  # noqa: E402
from perfbench.reference import jpeg as R  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "perfbench", "configs",
                      "cv1080_420_q95_nodri.json")
SEED = 2**31 + 23


def config(**kw) -> dict:
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg.update(kw)
    return cfg


def mcu_runs(h: int, w: int):
    """Frame 0 of the benchmark's restart-less source at ``h`` x ``w``
    (runs of 8 MCUs spliced at the bit level) and its truth: the bit and
    the predictors at the start of every run."""
    cfg = config(width=w, height=h, base=dict(config()["base"], width=w,
                                              height=h))
    src = FR.source(cfg)
    assert isinstance(src, FR.McuRuns)
    hints = src.lanes(SEED, 0)
    mcus = np.concatenate([[0], np.cumsum(hints.mcus)])
    truth = {int(m): (int(b), [int(v) for v in p]) for m, b, p in zip(
        mcus[:-1], hints.bits[:-1], hints.preds[:-1])}
    return src.frame(SEED, 0), truth


def indexed(h: int, w: int, sampling: str = "420", ri=None, seed=11):
    """A frame of the benchmark's kind of content, and the encoder's own
    record of the state before every MCU: its bit in its segment's row and
    the DC predictors (reset at every restart)."""
    data, ix = PE.encode_indexed(FR.base_image(h, w, seed), sampling=sampling,
                                 quality=95, restart_interval_mcus=ri)
    bits, last = ix["mcu_bit"], ix["dc_last"]
    total = len(bits) - 1
    ri = ri or total
    truth = {}
    for m in range(total):
        first = m - m % ri
        preds = last[m - 1] if m > first else np.zeros(last.shape[1])
        truth[m] = (int(bits[m] - bits[first]), [int(v) for v in preds])
    return data, truth


# name -> (bytes, truth or None, Decoder knobs)
def case(name: str):
    if name == "mcu_runs 64x64":
        return (*mcu_runs(64, 64), {})
    if name == "mcu_runs 96x128":
        return (*mcu_runs(96, 128), {})
    if name == "no DRI 80x112":  # 35 MCUs, no multiple of 2, 4, 8 or 16
        return (*indexed(80, 112), {})
    if name == "ri 120, 128x256":  # a segment of 120 MCUs and one of 8
        return (*indexed(128, 256, ri=120), {})
    if name == "one MCU":
        return (*indexed(16, 16), {})
    if name in ("gray", "422", "444"):
        return (*indexed(40, 72, sampling=name, seed=5), {})
    if name == "zrl_compat":
        return indexed(64, 96, seed=7)[0], None, {"zrl_compat": True}
    raise KeyError(name)


CASES = ["mcu_runs 64x64", "mcu_runs 96x128", "no DRI 80x112",
         "ri 120, 128x256", "one MCU", "gray", "422", "444", "zrl_compat",
         "padded", "zeroed half", "truncated", "random"]
GARBLED = ("padded", "zeroed half", "truncated", "random")


def prepared(name: str):
    """``(rows [nseg, W] int32, PreparedFrame, truth, bytes, knobs)`` of a
    case; the padded row has twice its width of zero words after it (a
    resident batch's narrower frames), the zeroed half keeps only the first
    half of its words (the MCUs go on into zeros), the truncated scan keeps
    the first half of the row, the random one has random words in the place
    of a frame's."""
    base = "no DRI 80x112" if name in GARBLED else name
    data, truth, knobs = case(base)
    pf = Decoder(device="cpu", **knobs).prepare(data)
    rows = pf.rows[:pf.nseg].view(np.int32)
    if name == "padded":
        rows = np.concatenate([rows, np.zeros_like(rows), np.zeros_like(rows)],
                              axis=1)
    elif name == "zeroed half":
        rows = rows.copy()
        rows[:, rows.shape[1] // 2:] = 0
        truth = None
    elif name == "truncated":
        rows = rows[:, :rows.shape[1] // 2]
        truth = None
    elif name == "random":
        rows = np.random.default_rng(3).integers(
            -2**31, 2**31, rows.shape, dtype=np.int64).astype(np.int32)
        truth = None
    return (torch.from_numpy(np.ascontiguousarray(rows)), pf, truth, data,
            knobs)


def wrap(v: int) -> int:
    return (v + 2**31) % 2**32 - 2**31


@pytest.mark.parametrize("name", [c for c in CASES if c not in (
    "zrl_compat", "zeroed half", "truncated", "random")])
@pytest.mark.parametrize("L", [1, 2, 4, 8, 16])
def test_plain_table_is_the_encoders_state(name, L):
    rows, pf, truth, _, _ = prepared(name)
    g = pf.geom
    if pf.nseg > 1 and min(g.ri, g.total_mcus) % L:
        pytest.skip("lanes must divide the restart interval")
    table = LN.lane_index_reference(rows, pf.nseg, pf.tables, g, L).numpy()
    assert table.shape == (-(-g.total_mcus // L), 4)
    seen = 0
    for m, (bit, preds) in truth.items():
        if m % L == 0:
            want = [bit] + [wrap(p) for p in preds] + [0] * (3 - len(preds))
            assert table[m // L].tolist() == want, m
            seen += 1
    assert seen > 0
    if len(truth) == g.total_mcus:  # the encoder's record of every MCU
        assert seen == len(table)


def kernel_walk(rows: np.ndarray, nseg: int, tables, geom, L: int,
                sub_bits: int, lead: int = 1, rounds: int = LN.ROUNDS,
                starts: int = LN.STARTS):
    """csrc/decode.cu's lane_sync_kernel, lane_round_kernel (``rounds``
    of them, each reading the exits the round before left), lane_fix_kernel
    (the serial repair, the scan, the entries at the MCU starts each
    subsequence kept, ``starts`` at most) and lane_index_kernel (the
    subsequences that kept fewer than they had, and the last active one),
    in numpy: the lane table, the subsequences the rounds decoded again,
    those the serial repair did and those the index pass did. Past the
    first pass only a segment's active subsequences take part: up to the
    last that holds a word other than zero."""
    windows = LN.table_windows(tables)
    seg_ri = min(geom.ri, geom.total_mcus)
    nsub = -(-rows.shape[1] * 32 // sub_bits)
    table = np.full((-(-geom.total_mcus // L), 4), -7, np.int64)
    redone = repaired = indexed_ = 0
    for s in range(nseg):
        step = LN.stepper(rows[s], windows, geom, tables.zrl17)
        first = s * seg_ri
        nm = min(seg_ri, geom.total_mcus - first)

        def sub(t, entry):
            """lane_sub: [entry, exit, MCUs, DC sums, kept starts]."""
            bit, kind = entry
            d, pos = kind >> 6, (kind & 63) - 1
            mcus, dc, kept = 0, [0, 0, 0], []
            while bit < (t + 1) * sub_bits:
                if d == 0 and pos < 0:
                    if mcus < starts:
                        kept.append((bit, list(dc)))
                    mcus += 1
                bit, d, pos = step(bit, d, pos, dc)
            return [entry, (bit, d * 64 + pos + 1), mcus, dc, kept]

        per = sub_bits // 32  # words a subsequence
        nact = 1 + max([t for t in range(nsub)
                        if rows[s][t * per:(t + 1) * per].any()], default=0)
        subs = []
        for t in range(nsub):  # sync: a guess `lead` subsequences back
            bit, d, pos = 0 if t <= lead else (t - lead) * sub_bits, 0, -1
            while bit < t * sub_bits:
                bit, d, pos = step(bit, d, pos, [0, 0, 0])
            subs.append(sub(t, (bit, d * 64 + pos + 1)))
        for _ in range(rounds):
            exits = [x[1] for x in subs]
            changed = [t for t in range(1, nact) if exits[t - 1] != subs[t][0]]
            for t in changed:
                subs[t] = sub(t, exits[t - 1])
            redone += len(changed)
            if not changed:
                break
        for t in range(nact - 1):  # repair, in order down the row
            if subs[t][1] != subs[t + 1][0]:
                subs[t + 1] = sub(t + 1, subs[t][1])
                repaired += 1
        m, dp = 0, [0, 0, 0]
        for t in range(nact):  # the scan and the kept starts
            (bit, kind), _, mcus, dc, kept = subs[t]
            for k, (at, part) in enumerate(kept):
                if m + k < nm and (first + m + k) % L == 0:
                    table[(first + m + k) // L] = [
                        at, *(wrap(a + b) for a, b in zip(dp, part))]
            base_m, base_dp = m, list(dp)
            m += mcus
            dp = [a + b for a, b in zip(dp, dc)]
            if base_m >= nm or (t < nact - 1 and mcus <= starts):
                continue
            indexed_ += 1  # the index pass: more starts than kept, or last
            d, pos = kind >> 6, (kind & 63) - 1
            while t == nact - 1 or bit < (t + 1) * sub_bits:
                if d == 0 and pos < 0:
                    if base_m >= nm:
                        break
                    j = first + base_m
                    if j % L == 0:
                        table[j // L] = [bit, *map(wrap, base_dp)]
                    base_m += 1
                bit, d, pos = step(bit, d, pos, base_dp)
    return table, redone, repaired, indexed_


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("sub_bits,rounds,starts", [
    (LN.SUB_BITS, LN.ROUNDS, LN.STARTS), (LN.SUB_BITS, LN.ROUNDS, 1),
    (64, LN.ROUNDS, 1), (32, 2, 0)])
def test_kernel_walk_gives_the_plain_table(name, sub_bits, rounds, starts):
    rows, pf, _, _, _ = prepared(name)
    g = pf.geom
    L = 4
    want = LN.lane_index_reference(rows, pf.nseg, pf.tables, g, L).numpy()
    got, redone, repaired, indexed_ = kernel_walk(
        rows.numpy().view(np.uint32), pf.nseg, pf.tables, g, L, sub_bits,
        rounds=rounds, starts=starts)
    assert np.array_equal(got, want)
    if sub_bits == 32 and g.total_mcus > 8:  # guesses that miss
        assert redone > 0 and repaired > 0
    if starts == 0 or (starts == 1 and sub_bits == LN.SUB_BITS
                       and g.total_mcus >= 16 and name != "random"):
        assert indexed_ > 0  # subsequences with more starts than kept


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("L", [1, 4])
def test_lane_decode_equals_the_whole_segment(name, L):
    rows, pf, _, data, knobs = prepared(name)
    g = pf.geom
    seg_ri = min(g.ri, g.total_mcus)
    table = LN.lane_index_reference(rows, pf.nseg, pf.tables, g, L)
    whole = E.entropy_decode_reference(rows, pf.nseg, pf.tables, g.ri,
                                       g.total_mcus, g.du_to_comp)
    lanes = E.entropy_decode_reference(
        rows, len(table), pf.tables, L, g.total_mcus, g.du_to_comp,
        lanes=table, seg_ri=seg_ri)
    dus = len(g.du_to_comp)
    flat = lanes.reshape(-1, dus, 64)
    assert torch.equal(flat[:g.total_mcus],
                       whole.reshape(-1, dus, 64)[:g.total_mcus])
    assert not flat[g.total_mcus:].any()  # the last lane's padding MCUs
    for exact in (True, False):
        op = Decoder(device="cpu", exact_idct=exact, **knobs).prepare(data).op
        lt = LN.LaneTable(table, L)
        assert all(torch.equal(a, b) for a, b in zip(
            F.fused_decode_planes(rows, pf.nseg, pf.tables, op, g,
                                  exact=exact, lanes=lt),
            F.fused_decode_planes(rows, pf.nseg, pf.tables, op, g,
                                  exact=exact)))


@pytest.mark.parametrize("name", ["mcu_runs 96x128", "no DRI 80x112",
                                  "ri 120, 128x256", "422"])
@pytest.mark.parametrize("mode", [("islow", "fancy"), ("islow", "nearest")])
def test_a_split_decode_equals_the_reference(name, mode):
    data, _, _ = case(name)
    fancy = mode[1] == "fancy"
    dec = Decoder(device="cpu", exact_idct=True, fancy_upsampling=fancy)
    P.reset_stats()
    got = dec.decode(data)
    c, mcus = P.get_counts(), dec.prepare(data).geom.total_mcus
    assert c[P.MCUS_LAUNCHED] == mcus  # every segment on lanes
    assert c[P.LANES_LAUNCHED] == -(-mcus // LN.LANE_MCUS)
    ref = R.decode(data, *mode)
    assert got.shape == ref.shape
    assert int((got != ref).sum()) == 0


def test_random_and_truncated_rows_decode_alike_on_lanes():
    """The fused wrappers' plain twins on lanes of garbage rows: equal to the
    one-lane decode, for K2's float IDCT and K2x's integer one."""
    for name in GARBLED:
        rows, pf, _, data, _ = prepared(name)
        g = pf.geom
        table = LN.lane_index(rows, pf.nseg, pf.tables, g, 4)
        for decode, op in (
                (F.fused_decode_rgba, pf.op),
                (F.fused_decode_rgba_exact,
                 Decoder(device="cpu", exact_idct=True).prepare(data).op)):
            assert torch.equal(decode(rows, pf.nseg, pf.tables, op, g,
                                      lanes=table),
                               decode(rows, pf.nseg, pf.tables, op, g))


# the restart intervals of the routing test; with no DRI a segment holds
# the frame's 128 MCUs
ROUTES = {"ri 1": 1, "ri 4": 4, "ri 16": 16, "ri 120": 120, "no DRI": None}


@pytest.fixture
def counts():
    P.reset_stats()
    yield
    P.reset_stats()


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("frames, entry", [(1, "decode_rows"),
                                           (3, "decode_rows"),
                                           (1, "decode_ycbcr")],
                         ids=["1", "3", "decode_ycbcr"])
def test_decode_rows_routes_by_the_segments_length(route, frames, entry,
                                                   counts, monkeypatch):
    """``decode_rows`` of resident rows and ``decode_ycbcr`` of the bytes
    take one route: a lane table where a segment is longer than T, equal
    to one lane a segment."""
    ri = ROUTES[route]
    split = min(ri or 128, 128) > LN.split_mcus(frames)
    assert split == (route in ("ri 120", "no DRI")) or route == "ri 16"
    data = PE.encode(FR.base_image(128, 256, 11), sampling="420", quality=95,
                     restart_interval_mcus=ri)
    dec = Decoder(device="cpu", exact_idct=True, fancy_upsampling=True)
    pf = dec.prepare(data)
    one = torch.from_numpy(pf.rows[:pf.nseg].view(np.int32))
    rows = one if frames == 1 else torch.stack([one] * frames)

    def decode():
        if entry == "decode_ycbcr":
            return [torch.from_numpy(p) for p in dec.decode_ycbcr(data)]
        return [dec.decode_rows(pf, rows)]

    made = []
    index = LN.lane_index
    monkeypatch.setattr(LN, "lane_index",
                        lambda *a: made.append(a[-1]) or index(*a))
    before = dict(_build.LAUNCHES)
    P.reset_stats()
    out = decode()
    c = P.get_counts()
    mcus = pf.geom.total_mcus
    assert _build.LAUNCHES == before  # the CPU launches no kernel
    assert c[P.MCUS_LAUNCHED] == mcus * frames
    if split:
        L = made[0]
        assert made == [L] and L == LN.lane_length(min(ri or mcus, mcus),
                                                   pf.nseg, frames)
        assert c[P.LANES_LAUNCHED] == -(-mcus // L) * frames
        assert mcus % L or c[P.MCUS_LAUNCHED] / c[P.LANES_LAUNCHED] == L
    else:
        assert not made
        assert c[P.LANES_LAUNCHED] == pf.nseg * frames
    monkeypatch.setattr(LN, "SPLIT_MCUS", ((1, 10**9),))  # one lane
    whole = decode()
    assert len(made) == split  # the one-lane decode made no table
    assert len(out) == len(whole)
    assert all(torch.equal(a, b) for a, b in zip(out, whole))


def test_lane_length_follows_the_segment_alone():
    """The segment's length and the launch's frames, nothing else: T is
    at least 8 (the 1- and 4-MCU intervals keep one lane) and never falls
    as a launch holds more frames."""
    ts = [LN.split_mcus(frames) for frames in range(1, 130)]
    assert ts == sorted(ts) and 8 <= ts[0]
    for frames in (1, 2, 3, 16, 64, 129):
        T = LN.split_mcus(frames)
        assert LN.lane_length(T, 1, frames) is None
        assert LN.lane_length(T + 1, 1, frames) == LN.LANE_MCUS
        for ri in (T + 1, 120, 127, 8160):
            L = LN.lane_length(ri, 2, frames)
            assert ri % L == 0 and 1 <= L <= LN.LANE_MCUS


@pytest.mark.parametrize("name", ["SUB_BITS", "ROUNDS", "STARTS"])
def test_the_scratch_follows_the_kernels_constants(name):
    with open(os.path.join(_build.CSRC, "decode.cu")) as f:
        src = f.read()
    got = re.search(r"constexpr int %s = (\d+);" % name, src)
    assert int(got[1]) == getattr(LN, name)


def test_lane_index_checks_its_cut():
    rows, pf, _, _, _ = prepared("ri 120, 128x256")
    with pytest.raises(ValueError):
        LN.lane_index(rows, pf.nseg, pf.tables, pf.geom, 7)
    with pytest.raises(ValueError):
        F.fused_decode_planes(rows, pf.nseg, pf.tables, pf.op, pf.geom,
                              lanes=LN.lane_index(rows, pf.nseg, pf.tables,
                                                  pf.geom, 4),
                              gate=F.BandGate(10**6, 2))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel L and the LANES launch have "
                    "no CPU mode")
    return torch.device("cuda")


def nodri_frames(k: int):
    """``k`` frames of the benchmark's ``cv1080_420_q95_nodri`` at 1080p,
    each with the hints by which the reference decodes it in lanes."""
    src = FR.source(config())
    return [(src.frame(SEED + 1, j), src.lanes(SEED + 1, j))
            for j in range(k)]


def nodri_batch(dec, k: int):
    """The frames of :func:`nodri_frames` prepared by ``dec``, their rows
    as one ``[k, 1, W]`` batch as the resident cell holds them."""
    frames = nodri_frames(k)
    pfs = [dec.prepare(d) for d, _ in frames]
    w = max(p.rows.shape[1] for p in pfs)
    rows = torch.zeros((k, pfs[0].nseg, w), dtype=torch.int32)
    for b, p in enumerate(pfs):
        rows[b, :, :p.rows.shape[1]] = torch.from_numpy(
            p.rows[:p.nseg].view(np.int32))
    return frames, pfs[0], rows


@pytest.mark.parametrize("name", CASES + ["cv1080 frames"])
def test_card_lane_index_equals_the_plain_table(cuda, name):
    if name == "cv1080 frames":
        _, pf, rows = nodri_batch(
            Decoder(device="cpu", **config()["decoder"]), 2)
    else:
        rows, pf, _, _, _ = prepared(name)
    g = pf.geom
    tables = E.EntropyTables(*(t.to(cuda) for t in (
        pf.tables.limits, pf.tables.delta, pf.tables.values,
        pf.tables.max_len, pf.tables.num_values)), zrl17=pf.tables.zrl17)
    seg_ri = min(g.ri, g.total_mcus)
    every = LN.lane_index_reference(rows, pf.nseg, pf.tables, g, 1)
    for L in (1, 2, 4, 8, 16):
        if pf.nseg > 1 and seg_ri % L:
            continue
        want = every[..., ::L, :]  # lane v of L starts at MCU v * L
        before = _build.LAUNCHES["lanes"]
        got = LN.lane_index(rows.to(cuda), pf.nseg, tables, g, L)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["lanes"] == before + 1
        assert torch.equal(got.table.cpu(), want), L


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("kernel", ["K2", "K2x", "K3 int", "K3 float"])
@pytest.mark.parametrize("L", [1, 4])
def test_card_lane_launch_equals_the_one_lane_launch(cuda, name, kernel, L):
    rows, pf, _, data, knobs = prepared(name)
    exact = kernel in ("K2x", "K3 int")
    pfc = Decoder(device=cuda, exact_idct=exact, **knobs).prepare(data)
    rows = rows.to(cuda)
    g = pfc.geom
    lanes = LN.lane_index(rows, pf.nseg, pfc.tables, g, L)
    if kernel.startswith("K3"):
        def run(**kw):
            return F.fused_decode_planes(rows, pf.nseg, pfc.tables, pfc.op,
                                         g, exact=exact, **kw)
        plain = F.fused_decode_planes_reference(
            rows.cpu(), pf.nseg, pf.tables, pfc.op.cpu(), g, exact)
    else:
        decode = F.fused_decode_rgba_exact if exact else F.fused_decode_rgba

        def run(**kw):
            return (decode(rows, pf.nseg, pfc.tables, pfc.op, g, **kw),)
        ref = (F.fused_decode_rgba_exact_reference if exact
               else F.fused_decode_rgba_reference)
        plain = (ref(rows.cpu(), pf.nseg, pf.tables, pfc.op.cpu(), g),)
    got, one = run(lanes=lanes), run()
    torch.cuda.synchronize()
    for a, b, c in zip(got, one, plain):
        assert torch.equal(a, b)
        if exact:
            assert torch.equal(a.cpu(), c)
        else:  # the f32 IDCT sums in another order than the plain twin
            diff = (a.cpu().view(torch.uint8).int()
                    - c.view(torch.uint8).int()).abs()
            assert int(diff.max()) <= 1


def test_card_decoder_on_cv1080_frames_equals_the_reference(cuda):
    """Two 1080p restart-less frames as a resident batch through
    ``decode_rows``: one L and one K3 and one E launch, pixels equal to the
    benchmark reference's; and each through ``decode_ycbcr``: one L and one
    K3 launch, planes equal to the reference's integer IDCT planes."""
    cfg = config()
    dec = Decoder(device=cuda, **cfg["decoder"])
    frames, pf, rows = nodri_batch(dec, 2)
    before = dict(_build.LAUNCHES)
    out = dec.decode_rows(pf, rows.to(cuda))
    torch.cuda.synchronize()
    assert _build.LAUNCHES == dict(before, lanes=before["lanes"] + 1,
                                   planes=before["planes"] + 1,
                                   epilogue=before["epilogue"] + 1)
    for b, (d, hints) in enumerate(frames):
        ref = R.decode(d, cfg["reference"]["idct"], cfg["reference"]["chroma"],
                       lanes=hints)
        got = F.rgba_to_rgb(out[b]).cpu().numpy()
        assert int((got != ref).sum()) == 0
    for d, hints in frames:
        f = R.parse(d)
        quant = np.stack([f.qtables[f.comps[c][2]] for c in f.du_comps])
        want = R.planes(f, R.idct_int(R.entropy_decode(f, hints), quant))
        before = dict(_build.LAUNCHES)
        got = dec.decode_ycbcr(d)
        assert _build.LAUNCHES == dict(before, lanes=before["lanes"] + 1,
                                       planes=before["planes"] + 1)
        assert len(got) == len(want) == 3
        for p, w in zip(got, want):
            assert np.array_equal(p, w[:p.shape[0], :p.shape[1]])
