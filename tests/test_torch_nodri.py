"""Restart-less frames, as ``cv2.imwrite`` writes them by default (quality
95, 4:2:0, the standard tables in a DHT segment, no DRI: one restart
segment a frame), decoded as ``cv2.imread`` and ``djpeg`` do by default
(``Decoder(exact_idct=True, fancy_upsampling=True)``, the benchmark's
``cv1080_420_q95_nodri``), against the benchmark's plain reference
(``perfbench/reference/jpeg.py``: numpy and plain PyTorch, nothing of the
program) with no sample apart; and the counters of what a decode asks of
the card: the lanes and MCUs ``decode_rows`` launches and the zero rows
``prepare`` packs past a frame's last segment.

This file imports neither jax nor ``compeg_tpu``."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from compeg_tpu_torch import Decoder  # noqa: E402
from compeg_tpu_torch import profiling as P  # noqa: E402
from compeg_tpu_torch.pipeline import row_capacity  # noqa: E402
from perfbench.inputs import encoder as PE  # noqa: E402
from perfbench.inputs import frames as F  # noqa: E402
from perfbench.reference import jpeg as R  # noqa: E402

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "perfbench", "configs", "cv1080_420_q95_nodri.json")
KNOBS = dict(exact_idct=True, fancy_upsampling=True, pack_threads=1)


def config(**kw) -> dict:
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg.update(kw)
    return cfg


def encoded(h: int, w: int, seed: int = 11, ri=None) -> bytes:
    """An ``[h, w]`` frame of the benchmark's kind of content, encoded as
    the configuration states it, with restart interval ``ri``."""
    cfg = config()
    return PE.encode(F.base_image(h, w, seed), sampling=cfg["sampling"],
                     quality=cfg["quality"], restart_interval_mcus=ri,
                     emit_dht=cfg["emit_dht"])


def mcu_runs_frame():
    """Frame 0 of a seed from the benchmark's restart-less source at a
    64 x 64 size and base: two runs of 8 MCUs spliced at the bit level, and
    the hints by which the reference decodes it in two lanes."""
    cfg = config(width=64, height=64, base=dict(
        config()["base"], width=64, height=64))
    src = F.source(cfg)
    assert isinstance(src, F.McuRuns)
    lanes = src.lanes(2**31 + 23, 0)
    assert len(lanes.mcus) == 2
    return src.frame(2**31 + 23, 0), lanes


def frame(case: str):
    if case == "mcu_runs":
        return mcu_runs_frame()
    h, w = {"48x32": (32, 48), "40x24": (24, 40), "control": (32, 48)}[case]
    return encoded(h, w, seed=12 if case == "control" else 11), None


@pytest.mark.parametrize("case", ["48x32", "40x24", "mcu_runs", "control"])
def test_a_restart_less_frame_decodes_as_the_reference(case):
    data, lanes = frame(case)
    f = R.parse(data)
    assert f.ri == 0 and b"\xff\xdd" not in data  # no DRI
    assert b"\xff\xc4" in data  # the tables in the frame
    got = Decoder(device="cpu", **KNOBS).decode(data)
    ref = R.decode(data, "islow", "fancy", lanes=lanes)
    assert got.shape == ref.shape == (f.height, f.width, 3)
    assert int((got != ref).sum()) == 0
    if case == "control":  # the comparison is tight enough to fail it
        ctl = R.decode(data, "islow", "fancy", "int8", lanes)
        assert int((ctl != ref).sum()) > 0


@pytest.fixture
def counts():
    P.reset_stats()
    yield
    P.reset_stats()


def test_count_adds_its_amount(counts):
    P.count(P.PACK_PAD_BYTES, 5)
    P.count(P.PACK_PAD_BYTES)
    P.count(P.LANES_LAUNCHED, 0)
    assert P.get_counts() == {P.PACK_PAD_BYTES: 6, P.LANES_LAUNCHED: 0}


# (frame height, width, restart interval): segments and MCUs a frame
STREAMS = {"restart-less": (32, 48, None, 1, 6),
           "a restart every 4 MCUs": (32, 64, 4, 2, 8)}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_a_decode_counts_its_lanes_mcus_and_padding(stream, counts):
    h, w, ri, nseg, mcus = STREAMS[stream]
    data = encoded(h, w, ri=ri)
    dec = Decoder(device="cpu", **KNOBS)
    width = dec.prepare(data).rows.shape[1]
    P.reset_stats()
    dec.decode(data)
    assert P.get_counts() == {
        P.LANES_LAUNCHED: nseg, P.MCUS_LAUNCHED: mcus,
        P.PACK_PAD_BYTES: (row_capacity(nseg) - nseg) * width * 4}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_a_batch_of_resident_rows_counts_each_frame(stream, counts):
    h, w, ri, nseg, mcus = STREAMS[stream]
    data = encoded(h, w, ri=ri)
    dec = Decoder(device="cpu", **KNOBS)
    pf = dec.prepare(data)
    one = torch.from_numpy(pf.rows[:nseg].view(np.int32))
    B = 3
    P.reset_stats()
    out = dec.decode_rows(pf, torch.stack([one] * B))
    assert P.get_counts() == {P.LANES_LAUNCHED: B * nseg,
                              P.MCUS_LAUNCHED: B * mcus}
    assert P.get_stats()["launch"].count == 1
    single = dec.decode_rows(pf, one)
    for b in range(B):
        assert torch.equal(out[b], single)
