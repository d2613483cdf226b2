"""The restart-less configuration's cells and the readers of the program's
counters: ``lane_mcus`` and ``pack_pad_mb.oneshot`` give None where the
program has counted no such thing (as before it had them) and the means of
the counts where it does; both new cells run correct on the CPU at a small
size, and their traced lines carry the counters' readings."""

import json
import os
import time

import pytest

from compeg_tpu_torch import profiling as P
from perfbench.harness import bench

from .small import SMALL

ROOT = os.path.dirname(bench.PERFBENCH)
READERS = ("lane_mcus", "pack_pad_mb.oneshot")
CELLS = ("cv1080_420_q95_nodri.resident", "cv1080_420_q95_nodri.oneshot")


@pytest.fixture
def counts():
    P.reset_stats()
    yield
    P.reset_stats()


@pytest.mark.parametrize("name", READERS)
def test_a_reader_gives_none_without_counters(name, counts):
    read = bench.reader(name)
    assert read(None) is None
    with P.stage_timer("prepare"):  # spans alone are not a counter
        pass
    assert read(None) is None


def test_lane_mcus_is_mcus_over_lanes(counts):
    P.count("lanes_launched", 2040 * 64)
    P.count("mcus_launched", 8160 * 64)
    P.count("lanes_launched", 1 * 16)
    P.count("mcus_launched", 8160 * 16)
    assert bench.reader("lane_mcus")(None) == pytest.approx(
        8160 * 80 / (2040 * 64 + 16))


def test_pack_pad_is_megabytes_a_prepare(counts):
    for pad in (802_000_000, 801_000_000, 803_000_000):
        with P.stage_timer("prepare"):
            P.count("pack_pad_bytes", pad)
    assert bench.reader("pack_pad_mb.oneshot")(None) == pytest.approx(802.0)


def test_the_new_entries_are_where_they_belong():
    spec = bench.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    assert cells[CELLS[0]]["traffic"] == "resident_p512_b16"
    assert cells[CELLS[1]]["traffic"] == "oneshot_w16"
    for cell in CELLS:
        assert cells[cell]["config"] == "cv1080_420_q95_nodri"
        assert cells[cell]["chips"] == 1
    traced = {c: {m["name"] for m in bench.cell_metrics(spec, c, True)}
              for c in CELLS}
    assert "lane_mcus" in traced[CELLS[0]]
    assert "pack_pad_mb.oneshot" in traced[CELLS[1]]
    assert "device_idle_pct.resident" not in traced[CELLS[0]]
    assert "prepare_ms.oneshot" not in traced[CELLS[1]]


# 48 x 32: one lane of 6 MCUs a frame, about 0.4 s a frame on the CPU
NODRI = {"width": 48, "height": 32}


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_small_run_is_correct_and_reads_the_counters(
        cell, counts, capsys):
    from compeg_tpu_torch import Decoder

    resident = cell.endswith("resident")
    overrides = {"config": dict(SMALL["config"], **NODRI),
                 "traffic": dict(SMALL["traffic"], check_frames=1,
                                 check_batches=1,
                                 check_expected=4 if resident else 1)}
    rc = bench.run(["--workload", cell, "--seed", str(2**31 + 23),
                    "--seconds", "0.5", "--trace", "1"],
                   time.perf_counter(), ROOT, device="cpu",
                   overrides=overrides)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    line = json.loads(out[-1])
    assert line["correct"] is True
    got = {k: v["value"] for k, v in line["metrics"].items()}
    if resident:
        assert got["lane_mcus"] == 6
        assert "pack_pad_mb.oneshot" not in got
    else:
        from perfbench.inputs import frames as F

        cfg = bench.load_json(os.path.join(
            ROOT, "perfbench", "configs", "cv1080_420_q95_nodri.json"))
        cfg.update(overrides["config"])
        src = F.source(cfg)
        # each prepare packs 1,023 zero rows at the row width it packs at,
        # the widest frame's so far
        widths = [Decoder(device="cpu").prepare(src.frame(2**31 + 23, j))
                  .rows.shape[1] for j in range(SMALL["traffic"]
                                                ["pool_frames"])]
        assert (1023 * min(widths) * 4 / 1e6 <= got["pack_pad_mb.oneshot"]
                <= 1023 * max(widths) * 4 / 1e6)
        assert "lane_mcus" not in got
