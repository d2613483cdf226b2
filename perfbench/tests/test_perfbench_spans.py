"""The readers of the program's spans (``perfbench/harness/spans.py`` and
the six metrics that use it) on hand-built events with known overlaps; the
spans' records on the device lanes leave the trace arithmetic as it was;
traced runs on the CPU report the new metrics, and a program without spans
leaves them out."""

import json
import types

import pytest

from perfbench.harness import bench, spans, trace

from .small import run_small

ONESHOT = ("prepare_span_ms.oneshot", "readback_span_ms.oneshot",
           "idle_in_prepare_pct.oneshot", "idle_in_upload_pct.oneshot",
           "idle_in_readback_pct.oneshot")
RESIDENT = ("launch_span_ms.resident",)

# A 100 us stretch. The card is busy over 10-20, 40-60 and 70-75 (35 us),
# idle for the other 65.
DEVICE = [("k1", "kernel", 10.0, 10.0),
          ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 40.0, 20.0),
          ("k2", "kernel", 70.0, 5.0)]
HOST = [("compeg.prepare", "user_annotation", 0.0, 12.0),  # idle 0-10
        ("compeg.upload", "user_annotation", 12.0, 4.0),  # busy all along
        ("compeg.launch", "user_annotation", 16.0, 2.0),
        ("compeg.readback", "user_annotation", 20.0, 42.0),  # 20-40, 60-62
        ("compeg.launch", "user_annotation", 62.0, 2.0),
        ("compeg.prepare", "user_annotation", 75.0, 15.0),  # idle 75-90
        ("compeg.upload", "user_annotation", 90.0, 5.0),  # idle 90-95
        ("aten::copy_", "cpu_op", 20.0, 42.0)]
# What a span leaves on the device lanes under CUDA profiling, and the
# stretch's own mark there.
LANES = [("compeg.readback", "gpu_user_annotation", 40.0, 20.0),
         ("compeg.prepare", "gpu_user_annotation", 0.0, 90.0),
         (trace.WINDOW, "gpu_user_annotation", 10.0, 65.0)]
EXPECTED = {
    "prepare_span_ms.oneshot": 13.5e-3,
    "readback_span_ms.oneshot": 42e-3,
    "idle_in_prepare_pct.oneshot": 25.0,
    "idle_in_upload_pct.oneshot": 5.0,
    "idle_in_readback_pct.oneshot": 22.0,
    "launch_span_ms.resident": 2e-3,
}


def ctx_of(events, lo=0.0, hi=100.0):
    return types.SimpleNamespace(
        stretch=trace.Stretch(list(events), lo, hi),
        intervals=trace.device_intervals(events))


@pytest.mark.parametrize("lanes", [[], LANES], ids=["host", "with_lanes"])
@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_readers_give_exact_values(name, lanes):
    ctx = ctx_of(DEVICE + HOST + lanes)
    assert bench.reader(name)(ctx) == pytest.approx(EXPECTED[name],
                                                    abs=1e-12)


def test_the_shares_and_the_remainder_split_the_idle_time():
    ctx = ctx_of(DEVICE + HOST)
    shares = sum(EXPECTED[n] for n in ONESHOT if n.startswith("idle_in"))
    idle = 100.0 * (1 - trace.busy_s(ctx.intervals) / 100e-6)
    assert idle == pytest.approx(65.0)
    assert idle - shares == pytest.approx(13.0)  # 18-20, 64-70, 95-100


@pytest.mark.parametrize("name", sorted(EXPECTED))
@pytest.mark.parametrize("events", [DEVICE, DEVICE + LANES], ids=[
    "no_span", "lanes_only"])
def test_no_span_reads_none(name, events):
    assert bench.reader(name)(ctx_of(events)) is None
    assert bench.reader(name)(types.SimpleNamespace(stretch=None,
                                                    intervals=[])) is None


def test_spans_on_two_threads_count_once_and_are_clipped_to_the_stretch():
    host = [("compeg.prepare", "user_annotation", 0.0, 30.0),
            ("compeg.prepare", "user_annotation", 5.0, 10.0),  # 2nd thread
            ("compeg.prepare", "user_annotation", 95.0, 20.0)]  # past hi
    ctx = ctx_of(DEVICE + host)
    # idle in 0-10, 20-30 and 95-100
    assert spans.idle_in_pct(ctx, "prepare") == pytest.approx(25.0)
    assert spans.mean_ms(ctx, "prepare") == pytest.approx(20e-3)


def test_interval_helpers():
    assert spans.union([(5, 8), (0, 2), (1, 3), (3, 3)]) == [(0, 3), (5, 8)]
    assert spans.idle([(10, 20), (40, 60)], 0, 50) == [(0, 10), (20, 40)]
    assert spans.idle([], 0, 5) == [(0, 5)]
    assert spans.idle([(0, 5)], 0, 5) == []
    assert spans.overlap_us([(0, 10), (20, 30)], [(5, 25)]) == 10.0


def test_lane_records_leave_the_trace_arithmetic_as_it_was(tmp_path):
    base = DEVICE + HOST
    lanes = base + LANES
    assert trace.device_intervals(lanes) == trace.device_intervals(base)
    iv = trace.device_intervals(base)
    assert trace.busy_s(trace.device_intervals(lanes)) == trace.busy_s(iv)
    assert (trace.idle_gaps(lanes, iv, 0.0, 100.0)
            == trace.idle_gaps(base, iv, 0.0, 100.0))
    first, second = (g[0] for g in trace.idle_gaps(base, iv, 0.0, 100.0,
                                                    top=2))
    assert first == "at 0.075 ms: compeg.prepare, compeg.upload"
    assert second == "at 0.020 ms: compeg.readback, aten::copy_"

    def chrome(events, corr):
        out = [{"ph": "X", "name": trace.WINDOW, "cat": "user_annotation",
                "ts": 0.0, "dur": 100.0}]
        for i, (n, c, ts, dur) in enumerate(events):
            e = {"ph": "X", "name": n, "cat": c, "ts": ts, "dur": dur}
            if corr and c in trace.DEVICE_CATEGORIES:
                e["args"] = {"correlation": i}
                out.append({"ph": "X", "name": "cudaLaunchKernel",
                            "cat": "cuda_runtime", "ts": ts - 1.0,
                            "dur": 0.5, "args": {"correlation": i}})
            elif c == "gpu_user_annotation":
                e["args"] = {"correlation": 1000 + i}
            out.append(e)
        return out

    for corr in (False, True):
        raw = chrome(lanes, corr)
        assert trace.unmatched_launches(raw) == trace.unmatched_launches(
            chrome(base, corr)) == {}
        path = tmp_path / f"trace{corr}.json"
        path.write_text(json.dumps({"traceEvents": raw}))
        st = trace.read_trace(str(path))  # one window: the lanes' is not it
        assert (st.lo_us, st.hi_us) == (0.0, 100.0)
        kept = {(n, c) for n, c, _, _ in st.events}
        # device records are kept by the correlation ids of their launches
        want = HOST + (DEVICE if corr else [])
        assert {(n, c) for n, c, _, _ in want} <= kept


@pytest.mark.parametrize("cell,names", [
    ("cam1080_420_exact_fancy.oneshot", ONESHOT),
    ("uvc4k_422.resident", RESIDENT),
])
def test_a_traced_run_reports_the_span_metrics(cell, names, capsys):
    line, rc = run_small(cell, capsys, trace=1)
    assert rc == 0 and line["correct"] is True
    for n in names:
        assert line["metrics"][n]["value"] is not None, n
        assert line["metrics"][n]["value"] >= 0
    if cell.endswith("oneshot"):
        assert 0 < line["metrics"]["prepare_span_ms.oneshot"]["value"]
        assert all("compeg." in label
                   for label, _ in line["breakdown"]["idle_gaps"])


def test_a_program_without_spans_leaves_the_metrics_out(monkeypatch, capsys):
    """The parent's tree: the same run, the program's spans never traced."""
    from compeg_tpu_torch import profiling

    monkeypatch.setattr(profiling, "_autograd_profiler",
                        types.SimpleNamespace(**{
                            profiling.PROFILER_FLAG: False}))
    line, rc = run_small("cam1080_420_exact_fancy.oneshot", capsys, trace=1)
    assert rc == 0 and line["correct"] is True
    assert not set(ONESHOT) & set(line["metrics"])
    assert "device_idle_pct.oneshot" in line["metrics"]
