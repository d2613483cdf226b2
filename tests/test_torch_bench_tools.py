"""The port's measurement tools (compeg_tpu_torch/tools: bench, bench_host,
bench_stream, bench_scaling, trace_ops, trace_sharded) and the repaired
``profiling.trace_device_ms``.

The busy-time arithmetic runs here on hand-built event lists: the card's
own work (kernels, device-to-device copies, memsets) is summed, host
transfers are rows outside the total, both spellings of torch.profiler's
categories count, and a copy that overlaps a kernel on another stream
counts once in the union. Each tool runs in process on ``--device cpu`` at
64 x 128: its JSON line parses with the JAX tool's keys (bench.py's and
bench_scaling.py's read from their sources), and every device-time field is
null, since a CPU clock is no device time. Without a card each tool fails on
its default device. ``python3 chip_smoke.py`` phase m runs them on the
card."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from compeg_tpu_torch import profiling as P  # noqa: E402
from compeg_tpu_torch.parallel import sharding as SH  # noqa: E402
from compeg_tpu_torch.tools import (  # noqa: E402
    bench, bench_host, bench_scaling, bench_stream, trace_ops,
    trace_sharded)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = [bench, bench_host, bench_scaling, bench_stream, trace_ops,
         trace_sharded]
# torch.profiler's category names in newer and older Kineto releases
SPELLINGS = {"new": ("kernel", "gpu_memcpy", "gpu_memset"),
             "old": ("Kernel", "Memcpy", "Memset")}
H2D = "Memcpy HtoD (Pageable -> Device)"
D2H = "Memcpy DtoH (Device -> Pinned)"
D2D = "Memcpy DtoD (Device -> Device)"


def events(spelling, frames=1):
    """``frames`` frames of: an upload [0, 40) on the copy stream beside a
    kernel [30, 50) on the compute stream, a device copy [60, 65), a
    memset [65, 67), a readback [80, 90), and host events all along; a
    frame every 1000 us."""
    kernel, memcpy, memset = SPELLINGS[spelling]
    out = []
    for f in range(frames):
        t = 1000.0 * f
        out += [(H2D, memcpy, t, 40.0),
                ("decode_kernel", kernel, t + 30, 20.0),
                (D2D, memcpy, t + 60, 5.0),
                ("Memset (Device)", memset, t + 65, 2.0),
                (D2H, memcpy, t + 80, 10.0),
                ("aten::copy_", "cpu_op", t, 95.0),
                ("cudaLaunchKernel", "cuda_runtime", t + 25, 3.0)]
    return out


@pytest.mark.parametrize("spelling", sorted(SPELLINGS))
@pytest.mark.parametrize("frames", [1, 3])
def test_device_busy_sums_the_cards_own_work(spelling, frames):
    busy = P.device_busy(events(spelling, frames), frames)
    # kernel 20 + device copy 5 + memset 2 per frame; transfers are out
    assert busy.total_ms == pytest.approx(0.027)
    kernel, memcpy, memset = SPELLINGS[spelling]
    assert busy.counted == {kernel: frames, memcpy: frames, memset: frames}
    rows = {name: (ms, count) for ms, count, name in busy.rows}
    assert rows == {H2D: (pytest.approx(0.04), 1),
                    "decode_kernel": (pytest.approx(0.02), 1),
                    D2D: (pytest.approx(0.005), 1),
                    "Memset (Device)": (pytest.approx(0.002), 1),
                    D2H: (pytest.approx(0.01), 1)}
    assert [r[2] for r in busy.rows][:2] == [H2D, "decode_kernel"]
    # the union counts the upload under the kernel once: [0, 50), [60, 67),
    # [80, 90) a frame; the span runs from the first event to the last
    assert busy.intervals[:3] == [(0.0, 50.0), (60.0, 67.0), (80.0, 90.0)]
    assert busy.union_ms == pytest.approx(0.067 * frames)
    assert busy.span_ms == pytest.approx((1000.0 * (frames - 1) + 90) / 1e3)
    assert busy.event_ms is None


@pytest.mark.parametrize("only", [
    [], [("aten::mul", "cpu_op", 0.0, 5.0)],
    [(H2D, "gpu_memcpy", 0.0, 5.0), (D2H, "Memcpy", 9.0, 1.0)],
    [("PyTorch Profiler (0)", "Trace", 0.0, 50.0),
     ("kernel-like name", "cuda_runtime", 1.0, 2.0)]],
    ids=["empty", "host only", "transfers only", "no device category"])
def test_device_busy_raises_without_device_work(only):
    with pytest.raises(RuntimeError, match="no device kernel"):
        P.device_busy(only, 1)


def chrome(name, cat, ts, dur, corr=None):
    """One complete event of a chrome trace, as torch.profiler writes it."""
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launches(calls, per_call=2):
    """``calls`` calls of a kernel launched ``per_call`` times and a device
    copy, each launch with its device record, and a host function that
    leaves none."""
    out, corr = [], 0
    for c in range(calls):
        t = 100.0 * c
        calls = [("cudaLaunchKernel", "kernel", "k")] * per_call + [
            ("cudaMemcpyAsync", "gpu_memcpy", D2D)]
        for name, kind, dev in calls:
            corr += 1
            out += [chrome(name, "cuda_runtime", t + corr, 1.0, corr),
                    chrome(dev, kind, t + corr + 2, 1.0, corr)]
        out.append(chrome("cudaLaunchHostFunc", "cuda_runtime", t + 50, 1.0,
                          10_000 + c))
    return out


@pytest.mark.parametrize("loss", ["none", "every call", "one a call",
                                  "a copy"])
def test_unmatched_launches_are_the_lost_device_records(loss):
    """Each launch must have its device record: a kernel lost in every call
    (never in the trace) and one of two launches lost in each call (a count
    that is still a multiple of the calls) are found as well."""
    ev = launches(3)
    dev = [i for i, e in enumerate(ev) if e["cat"] in P.DEVICE_CATEGORIES]
    drop = {"none": [], "every call": [i for i in dev if ev[i]["name"] == "k"],
            "one a call": [i for i in dev if ev[i]["name"] == "k"][::2],
            "a copy": [i for i in dev if ev[i]["name"] == D2D][-1:]}[loss]
    kept = [e for i, e in enumerate(ev) if i not in drop]
    want = {"none": {}, "every call": {"cudaLaunchKernel": 6},
            "one a call": {"cudaLaunchKernel": 3},
            "a copy": {"cudaMemcpyAsync": 1}}[loss]
    assert P.unmatched_launches(kept) == want


def test_idle_gaps_name_the_host_events_in_each_gap():
    ev = events("new", 2) + [("PyTorch Profiler (0)", "Trace", 0.0, 2000.0),
                             ("aten::empty", "cpu_op", 300.0, 500.0),
                             ("gpu_user", "gpu_user_annotation", 0.0, 2000.0)]
    busy = P.device_busy(ev, 2)
    gaps = bench_stream.idle_gaps(ev, busy.intervals, top=3)
    # per frame [50, 60), [67, 80), and [90, 1000) to the next frame
    assert [g["ms"] for g in gaps] == pytest.approx([0.91, 0.013, 0.013])
    first = gaps[0]
    assert first["start_ms"] == pytest.approx(0.09)
    assert first["host"] == ["aten::empty", "aten::copy_"]
    assert gaps[1]["start_ms"] == pytest.approx(1.067)  # the later first
    assert gaps[1]["host"] == ["aten::copy_"]
    assert bench_stream.idle_gaps(ev, busy.intervals[:1]) == []


def test_device_trace_writes_what_read_trace_reads(tmp_path):
    with P.device_trace(None):
        pass
    logdir = str(tmp_path / "trace")
    with P.device_trace(logdir):
        torch.ones(64).mul(3).sum()
    ev = P.read_trace(logdir)
    assert os.path.exists(os.path.join(logdir, P.TRACE_FILE))
    assert any(name == "aten::mul" and cat == "cpu_op" and dur >= 0
               for name, cat, _, dur in ev)
    assert all(isinstance(ts, float) for _, _, ts, _ in ev)
    with pytest.raises(RuntimeError, match="no device kernel"):
        P.device_busy(ev, 1)  # a CPU trace holds no device time


def test_read_trace_keeps_what_the_window_launched(tmp_path):
    """Inside ``record_function(WINDOW)``: host events by time, device
    events by the correlation id of the host call that launched them (a
    copy launched inside may run after the span ends; a warm-up kernel
    launched before it is left out)."""
    ev = chrome

    trace = {"traceEvents": [
        {"ph": "M", "name": "process_name", "args": {"name": "python"}},
        ev(P.WINDOW, "user_annotation", 100.0, 100.0),
        ev(P.WINDOW, "gpu_user_annotation", 150.0, 200.0),
        ev("cudaLaunchKernel", "cuda_runtime", 50.0, 5.0, 1),
        ev("warm_kernel", "kernel", 60.0, 10.0, 1),
        ev("cudaLaunchKernel", "cuda_runtime", 150.0, 5.0, 2),
        ev("decode_kernel", "kernel", 155.0, 20.0, 2),
        ev("cudaMemcpyAsync", "cuda_runtime", 160.0, 5.0, 3),
        ev(D2D, "gpu_memcpy", 300.0, 8.0, 3),
        ev("aten::empty", "cpu_op", 120.0, 1.0),
        ev("aten::copy_", "cpu_op", 20.0, 1.0)]}
    with open(tmp_path / P.TRACE_FILE, "w") as f:
        json.dump(trace, f)
    every = P.read_trace(str(tmp_path))
    assert len(every) == 10
    kept = P.read_trace(str(tmp_path), P.WINDOW)
    assert sorted(name for name, *_ in kept) == sorted([
        P.WINDOW, P.WINDOW, "cudaLaunchKernel", "decode_kernel",
        "cudaMemcpyAsync", D2D, "aten::empty"])
    busy = P.device_busy(kept, 1)
    assert busy.total_ms == pytest.approx(0.028)
    with pytest.raises(RuntimeError, match="spans named"):
        P.read_trace(str(tmp_path), "another span")
    # the copy launched inside the window loses its device record
    trace["traceEvents"] = [e for e in trace["traceEvents"]
                            if e["name"] != D2D]
    with open(tmp_path / P.TRACE_FILE, "w") as f:
        json.dump(trace, f)
    with pytest.raises(P.LostEvents, match="cudaMemcpyAsync"):
        P.read_trace(str(tmp_path), P.WINDOW)


def jax_keys(script):
    """The keys of the dict literal that ``script`` (bench.py or
    bench_scaling.py) prints with ``json.dumps`` last."""
    with open(os.path.join(ROOT, script)) as f:
        tree = ast.parse(f.read())
    dumps = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", None) == "dumps"
             and n.args and isinstance(n.args[0], ast.Dict)]
    return {k.value for k in dumps[-1].args[0].keys}


def run_tool(mod, argv, capsys):
    assert mod.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def test_bench_on_the_cpu(capsys):
    res = run_tool(bench, ["--device", "cpu", "--frames", "2", "--rounds",
                           "1"], capsys)
    assert jax_keys("bench.py") - {"vs_baseline"} <= res.keys()
    assert "vs_baseline" not in res
    device_fields = ("value", "exact_fps", "trace_ms", "exact_trace_ms",
                     "trace_fps", "exact_trace_fps", "trace_event_ms",
                     "e2e_fps", "thumbnail_trace_ms", "thumbnail_fps",
                     "link_h2d_MBps", "device")
    assert all(res[k] is None for k in device_fields), res
    assert res["host_ms"] > 0 and res["host_feed_fps"] > 0
    assert res["unit"] == "frames/s" and "per_card" in res["metric"]


@pytest.mark.parametrize("argv", [[], ["--exact"], ["--fancy"]])
def test_trace_ops_on_the_cpu(argv, capsys):
    res = run_tool(trace_ops, argv + ["--device", "cpu"], capsys)
    assert res["mode"] == ("exact" if argv == ["--exact"] else "default") + (
        " fancy" if argv == ["--fancy"] else "")
    assert all(res[k] is None for k in ("trace_ms", "fps", "trace_event_ms",
                                        "tail_ms", "device"))
    assert res["rows"] == []


def test_bench_host_on_the_cpu(capsys):
    res = run_tool(bench_host, ["--device", "cpu"], capsys)
    # 64 x 128 4:2:2 at one MCU a segment: 8 x 8 MCUs
    assert res["segments"] == 64 and res["rows"] == 1024
    assert res["device"] is None
    assert set(res["ms"]) == {"analyze (native parse)", "scan_info",
                              "pack_rows (pooled)",
                              "prepare (parse+pack, steady state)",
                              "parse_segments (Python parser)"}


def test_bench_host_counts_are_the_jax_packages():
    """The counts of bench4k.jpg as tools/bench_host.py computes them
    (compeg_tpu.native.scan_info, compeg_tpu.scan._words_per_segment)."""
    from compeg_tpu import analyze, native
    from compeg_tpu import scan as S

    with open(os.path.join(ROOT, "bench_assets", "bench4k.jpg"), "rb") as f:
        data = f.read()
    img = analyze(data)
    n = img.total_restart_intervals
    _, mx = native.scan_info(img.scan_data)
    got = bench_host.counts(data)
    assert (got["segments"], got["words_per_segment"], got["blocks"]) == (
        n, S._words_per_segment(mx), -(-n // S.SEGMENTS_PER_BLOCK))
    assert got["scan_bytes"] == len(img.scan_data)
    assert (n, got["words_per_segment"]) == (64800, 9)


def test_bench_stream_on_the_cpu(capsys):
    res = run_tool(bench_stream, ["--device", "cpu", "--frames", "3"],
                   capsys)
    assert set(res["prepare_fps"]) == {"pooled pack", "1-thread pack"}
    assert all(set(r) == {"1", "2", "4", "6"}
               for r in res["prepare_fps"].values())
    assert res["host_feed_fps"] > 0
    assert res["card_fps"] is None and res["verdict"] is None
    assert res["device"] is None
    stream = res["stream"]
    assert stream["frames"] == 3
    assert all(stream[k] is None for k in ("wall_s", "fps", "busy_ms",
                                           "span_ms", "idle_share", "gaps"))


@pytest.mark.parametrize("bands", ["1", "2"])
def test_trace_sharded_on_the_cpu(bands, capsys):
    res = run_tool(trace_sharded, [bands, "--device", "cpu"], capsys)
    assert res["equal"] is True and res["n_bands"] == int(bands)
    assert all(res[k] is None for k in ("unbanded_ms", "banded_ms", "ratio",
                                        "device"))
    assert res["target"] == 1.10


def test_trace_sharded_fails_on_an_altered_band(monkeypatch, capsys):
    real = SH.decode_frames_sharded

    def altered(*args, **kwargs):
        out = real(*args, **kwargs).clone()
        out[0, -1, -1] ^= 1  # one bit of the last band's last pixel
        return out

    monkeypatch.setattr(SH, "decode_frames_sharded", altered)
    assert trace_sharded.main(["2", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-2])["equal"] is False
    assert "FAIL" in out.strip().splitlines()[-1]


def test_bench_scaling_on_two_gloo_ranks(capsys):
    """The mesh curve at n = 1, 2 (gloo processes, each rank checking its
    frames against Decoder), the independent-process control at 1 and 2
    and the probe; no rate or efficiency is printed from the CPU."""
    res = run_tool(bench_scaling, ["--device", "cpu", "--max-ranks", "2"],
                   capsys)
    assert jax_keys("bench_scaling.py") - {"vs_baseline"} <= res.keys()
    assert res["counts"] == [1, 2]
    assert all(res[k] is None for k in (
        "value", "mesh_efficiency_raw", "machine_ceiling_independent_procs",
        "dispatch_overhead_ms", "all_counts", "frames_per_s", "devices",
        "control_spread", "valid"))
    assert res["metric"] == "sharded_decode_scaling_efficiency"


@pytest.mark.parametrize("eff, c1, ck, want", [
    (1.0, 13105.0, [13105.0], (1.0, 0.0, True)),  # one card
    # four cards: mesh 0.974, control 12,923 and 4 x ~12,994 (ceiling 1.006)
    (0.974, 12923.0, [12994.0] * 4, (0.974 / (12994 / 12923), 12994 / 12923
                                     - 1, True)),
    # a slow n = 1 baseline: the mesh reads 1.228 against a ceiling of 0.99
    (1.228, 13189.0, [13057.0, 13100.0, 13000.0, 13072.0],
     (1.228 / (52229 / (4 * 13189)), 13189 / 13000 - 1, False))],
    ids=["one card", "four cards", "slow baseline"])
def test_bench_scaling_value_is_uncapped(eff, c1, ck, want):
    value, spread, valid = bench_scaling.attributable(eff, c1, ck)
    assert (value, spread) == pytest.approx(want[:2]) and valid is want[2]


@pytest.mark.parametrize("mod", TOOLS, ids=[m.__name__.rsplit(".", 1)[-1]
                                            for m in TOOLS])
def test_each_tool_fails_without_a_card(mod):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_a_tool_exits_non_zero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run(
        [sys.executable, "-m", "compeg_tpu_torch.tools.bench"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "{" not in res.stdout
    assert "no CUDA device" in res.stderr


def test_the_rotated_frames_differ():
    from compeg_tpu_torch.tools import _common as K

    data = K.workload(torch.device("cpu"))
    frames = bench_stream.rotated(data, 9)
    assert frames[0] == data and frames[8] == data  # 8 MCU rows: a full turn
    assert len(set(frames[:8])) == 8
    assert np.frombuffer(frames[3], np.uint8).size == len(data)
