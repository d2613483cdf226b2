"""The frame sources that the configuration's restart interval chooses:
today's runs of eight segments, byte for byte as they were; single
segments where a frame's segments come in no whole runs of eight; runs of
MCUs spliced at the bit level where the frame has no restart markers. The
reference decodes a restart-less frame in the lanes its source reports,
as a single lane does, and fails on a hint that is off; the resident loop
takes its row width from the pool's own frames."""

import hashlib
import json
import os
import time

import numpy as np
import pytest
import torch

from perfbench.harness import bench
from perfbench.harness.loops import LOOPS
from perfbench.inputs import frames as F
from perfbench.reference import jpeg as R

from .small import SMALL
from .test_perfbench_inputs import CONFIGS, small_config

# SHA-256 of each configuration's base JPEGs, and of frames 0-3 of seeds 0
# and -5, as the frame source made them before it had other sources.
PINNED = {
    "uvc4k_422": {
        "bases": ["028198baf76fb3773bbe3cf3e7c5cfd41fc501370e0af0dabd9221c15d1e09ab",
                  "f9a3a5854bc3c039b2444a85515584a949822b26e5fa643eef1eb4b82917073e"],
        0: ["9acee68712a6fabba987c0be771da5e237894a2ad230acecfc8b0fcedc09b713",
            "ce79c2057f58cd27fc701949e9e4cb83f126fd67563c8439aa6219cc6c591240",
            "6e6e575de5da8433cfbc7a63daa0836179adac8953fbedb12512f6d49946f750",
            "1042cb2cebea7f3f73bb5b516d575a2c3e80fee8ac1fbfadfe8d6b32d356c1b3"],
        -5: ["b12f5281c80622756edd85c9405b27d64e67d334b22e90fe527c55895aa24b89",
             "d5d1d22f579403c665b0873fba4cbd15e3d564d7dc2ffadfdf70a033621a92b9",
             "ad384ea0bebb1eff9352993d1530578ba2e729f453e7a1e7e25dad988458cfbd",
             "201993b12993478bb4a04f0c8fd1e1c695a600f9146f68bf23c00b67776949b5"],
    },
    "cam1080_420_exact_fancy": {
        "bases": ["3a95d36d244570041f932db81bfcfce2c57643e89a80a64dc83f92a748cd1e34",
                  "5ffed299484f951f9b375bc9bc8cf7b9126a56efc52922e199581b233b4e22b5"],
        0: ["8a83f441a44af7efb3cc5509d6d0ee90d835d115e39c802de1f265c5f92b1ee7",
            "196baa33a4c3f8cdb9e9670a400bb5db6f77e8931c055adbecbd727c5eb433b9",
            "60abe7a696d6aa67b4cb79d17b6dd655f2033b5c0ef29006fae63b227aec6970",
            "c8d6bad33437df0ec1d943c8d3ef2dd304edc495453b0a8eced63d1b8faca0cf"],
        -5: ["4a798da212963645ee5f3fbb97be288715c67f6cefe4fda2cfb4fd9240cef923",
             "3407326051a1118dd1b3bb30e7d2d1f2291eee1ae4f2fce029f8195946995ade",
             "d03f9d861e2cb04b1d84f9f6232c5746cea624d75b9455bcf7f7e03fd6fca6ed",
             "62afa46079cf4b064cf6e74a4054369abba096cc69a78e18d167f242b5da76e2"],
    },
}


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_configurations_frames_are_as_pinned(name):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        cfg = json.load(f)
    src = F.source(cfg)
    assert isinstance(src, F.RunsOfEight)
    assert [sha(b) for b in F.base_jpegs(cfg)] == PINNED[name]["bases"]
    for seed in (0, -5):
        assert [sha(src.frame(seed, j)) for j in range(4)] == \
            PINNED[name][seed]


def new_config(sampling, ri, **kw):
    """The 1080p configuration's decoder, reference and limits on small
    frames of ``sampling`` with restart interval ``ri`` (None: no DRI)."""
    cfg = small_config("cam1080_420_exact_fancy", width=128, height=112,
                       sampling=sampling, quality=95,
                       restart_interval_mcus=ri, emit_dht=True)
    cfg.update(kw)
    return cfg


# a restart every MCU row: 7 segments at 4:2:0, 14 at 4:2:2
SOURCES = [("420", None), ("422", None), ("420", 8), ("422", 8)]


@pytest.mark.parametrize("sampling,ri", SOURCES)
def test_new_sources_make_distinct_valid_frames(sampling, ri):
    cfg = new_config(sampling, ri)
    src = F.source(cfg)
    assert isinstance(src, F.McuRuns if ri is None else F.Segments)
    frames = F.pool(cfg, 2**31 + 21, 4)
    assert len(set(frames)) == 4
    assert F.pool(cfg, 2**31 + 21, 4) == frames
    for j, data in enumerate(frames):
        f = R.parse(data)
        assert (f.width, f.height) == (128, 112)
        _, starts, lens = R.split_segments(f.scan)  # RST0..RST7 in order
        assert len(starts) == src.segments
        assert src.row_bytes(2**31 + 21, j) == lens.max()
        if ri is None:
            assert f.ri == 0 and b"\xff\xdd" not in data
            s = np.frombuffer(f.scan, np.uint8)
            after_ff = s[1:][s[:-1] == 0xFF]
            assert (after_ff == 0).all()  # stuffing only: no RST
        else:
            assert f.ri == ri
        R.entropy_decode(f, src.lanes(2**31 + 21, j))


def test_an_interval_that_does_not_divide_the_frame_is_refused():
    with pytest.raises(ValueError):
        F.source(new_config("420", 5))


@pytest.mark.parametrize("sampling", ["420", "422"])
def test_lanes_decode_as_one_lane_does(sampling):
    src = F.source(new_config(sampling, None))
    for j in range(2):
        f = R.parse(src.frame(-9, j))
        lanes = src.lanes(-9, j)
        assert len(lanes.mcus) > 1
        assert np.array_equal(R.entropy_decode(f, lanes), R.entropy_decode(f))


def corrupted(lanes, what):
    bits, mcus, preds = (lanes.bits.copy(), lanes.mcus.copy(),
                         lanes.preds.copy())
    if what == "bit":
        bits[2] += 1
    elif what == "pred":
        preds[3, 1] += 1
    elif what == "mcus":
        mcus[1] += 1
        mcus[2] -= 1
    else:
        bits[-1] -= 8
    return R.Lanes(bits=bits, mcus=mcus, preds=preds)


@pytest.mark.parametrize("what", ["bit", "pred", "mcus", "end"])
def test_a_corrupted_hint_raises(what):
    src = F.source(new_config("420", None))
    data = src.frame(4, 0)
    with pytest.raises(R.JpegError):
        R.decode(data, "islow", "fancy",
                 lanes=corrupted(src.lanes(4, 0), what))


def test_lanes_on_a_scan_with_markers_raise():
    src = F.source(new_config("420", None))
    lanes = src.lanes(4, 0)
    data = F.source(new_config("420", 8)).frame(4, 0)
    with pytest.raises(R.JpegError):
        R.decode(data, lanes=lanes)


# The port's plain PyTorch decode on the CPU takes about a second an MCU
# row of a restart-less frame: where the program decodes, such frames are
# 64 x 64 (2 lanes at 4:2:0, 4 at 4:2:2).
SMALL_NODRI = {"width": 64, "height": 64}


@pytest.mark.parametrize("sampling,ri", SOURCES)
def test_the_resident_row_width_comes_from_the_pool(sampling, ri):
    from compeg_tpu_torch import Decoder

    cfg = new_config(sampling, ri, **(SMALL_NODRI if ri is None else {}))
    traffic = dict(SMALL["traffic"], loop="resident")
    loop = LOOPS["resident"](cfg, traffic, torch.device("cpu"), 31)
    loop.setup()
    frames = [loop.frame(j) for j in range(traffic["pool_frames"])]
    dec = Decoder(device="cpu")
    assert loop.rows.shape[2] == max(dec.prepare(f).rows.shape[1]
                                     for f in frames)
    if ri is None:  # a base's one segment is a whole frame's, of its size
        assert loop.rows.shape[1:] == (1, loop.rows.shape[2])


@pytest.mark.parametrize("cell", ["cam1080_420_exact_fancy.oneshot",
                                  "cam1080_420_exact_fancy.resident"])
@pytest.mark.parametrize("sampling,ri", [("420", None), ("422", 8)])
def test_a_run_of_new_frames_is_correct_and_a_broken_one_is_not(
        cell, sampling, ri, monkeypatch, capsys):
    from compeg_tpu_torch import pipeline

    size = SMALL_NODRI if ri is None else {"width": 128, "height": 112}
    overrides = {"config": dict(SMALL["config"], sampling=sampling,
                                quality=95, restart_interval_mcus=ri,
                                emit_dht=True, **size),
                 # as many frames compared as a slow CPU decode delivers
                 "traffic": dict(SMALL["traffic"], check_frames=1,
                                 check_batches=1, check_expected=(
                                     4 if cell.endswith("resident") else 1))}

    def run():
        rc = bench.run(["--workload", cell, "--seed", str(2**31 + 99),
                        "--seconds", "0.3", "--trace", "0"],
                       time.perf_counter(), bench.os.path.dirname(
                           bench.PERFBENCH), device="cpu",
                       overrides=overrides)
        out = capsys.readouterr().out.strip().splitlines()
        assert rc == 0
        return json.loads(out[-1])

    assert run()["correct"] is True
    orig = pipeline.Decoder.decode_rows

    def altered(self, pf, rows):
        out = orig(self, pf, rows).clone()
        out[..., 7, 9] ^= 0x00FFFFFF
        return out

    monkeypatch.setattr(pipeline.Decoder, "decode_rows", altered)
    assert run()["correct"] is False


@pytest.mark.parametrize("sampling,ri", [("420", None), ("422", 8)])
def test_the_control_fails_on_new_frames(sampling, ri):
    from perfbench.harness import check

    cfg = new_config(sampling, ri)
    src = F.source(cfg)
    got = check.compare(cfg, lambda j: src.frame(6, j),
                        [(j, None) for j in range(3)], 3,
                        control=cfg["reference"]["control"],
                        lanes=lambda j: src.lanes(6, j))
    assert got["diff_samples"][0] > got["diff_samples"][1]
