"""The harness's arithmetic on hand-built inputs: the busy union, idle
gaps, lost launches and the traced stretch of a chrome trace; the
percentiles and rates over all frames; the roofline's byte counts against
the kernels' bounds recorded in PERF.md."""

import json

import numpy as np
import pytest

from perfbench.harness import roofline, trace
from perfbench.harness.loops import Reservoir


def ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def write(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_union_counts_overlaps_once():
    events = [("k1", "kernel", 0.0, 10.0), ("copy", "gpu_memcpy", 5.0, 10.0),
              ("k2", "kernel", 30.0, 5.0), ("host", "cpu_op", 0.0, 100.0)]
    iv = trace.device_intervals(events)
    assert iv == [(0.0, 15.0), (30.0, 35.0)]
    assert trace.busy_s(iv) == pytest.approx(20e-6)
    assert trace.top_ops(events) == [["k1", 1e-5], ["copy", 1e-5],
                                     ["k2", 5e-6]]


def test_idle_gaps_name_the_host_events_inside():
    events = [("k1", "kernel", 10.0, 10.0), ("k2", "kernel", 50.0, 10.0),
              ("cudaStreamSynchronize", "cuda_runtime", 22.0, 20.0),
              ("aten::copy_", "cpu_op", 40.0, 5.0)]
    iv = trace.device_intervals(events)
    gaps = trace.idle_gaps(events, iv, 0.0, 100.0, top=2)
    assert [g[1] for g in gaps] == [pytest.approx(40e-6),
                                    pytest.approx(30e-6)]
    assert gaps[1][0].startswith("at 20.000 ms") is False  # us -> ms
    assert "cudaStreamSynchronize, aten::copy_" in gaps[1][0]


def test_read_trace_keeps_the_marked_stretch(tmp_path):
    events = [
        ev(trace.WINDOW, "user_annotation", 100.0, 100.0),
        ev("cudaLaunchKernel", "cuda_runtime", 50.0, 2.0, 1),  # before
        ev("k_before", "kernel", 105.0, 10.0, 1),
        ev("cudaLaunchKernel", "cuda_runtime", 120.0, 2.0, 2),
        ev("k_in", "kernel", 190.0, 30.0, 2),  # runs past the span
        ev("cudaMemcpyAsync", "cuda_runtime", 150.0, 2.0, 3),
        ev("Memcpy HtoD", "gpu_memcpy", 160.0, 5.0, 3),
    ]
    st = trace.read_trace(write(tmp_path, events))
    names = {e[0] for e in st.events}
    assert "k_in" in names and "k_before" not in names
    assert (st.lo_us, st.hi_us) == (100.0, 220.0)


def test_read_trace_refuses_a_lost_device_record(tmp_path):
    events = [ev(trace.WINDOW, "user_annotation", 0.0, 100.0),
              ev("cudaLaunchKernel", "cuda_runtime", 10.0, 2.0, 7)]
    with pytest.raises(trace.LostEvents):
        trace.read_trace(write(tmp_path, events))


def test_oneshot_rate_is_over_all_calls_and_the_whole_window():
    """The one-shot loop counts every call it made over the whole wall of
    the window: with one call in ten 6 ms slow, the rate is the calls over
    the wall, slow calls included."""
    import time

    import torch

    from perfbench.harness.loops import OneShotLoop

    from .test_perfbench_inputs import small_config

    class Slow:
        calls = 0

        def decode(self, data):
            self.calls += 1
            time.sleep(0.006 if self.calls % 10 == 0 else 0.0005)
            return np.zeros((2, 2, 3), np.uint8)

    loop = OneShotLoop(small_config("cam1080_420_exact_fancy"),
                       {"pool_frames": 4, "check_frames": 1},
                       torch.device("cpu"), 3)
    loop.frames = [b""] * 4
    loop.dec = Slow()
    loop.sampler = Reservoir(1, 3, 2)
    loop.served = 0
    t0 = time.perf_counter()
    loop.run(0.5)
    wall = time.perf_counter() - t0
    r = loop.result
    assert r["attempted"] == loop.dec.calls and r["failed"] == 0
    assert r["fps"] == pytest.approx(r["attempted"] / wall, rel=0.05)
    assert r["fps"] < 1 / (0.9 * 0.0005 + 0.1 * 0.006)


def test_reservoir_is_uniform_and_seeded():
    counts = np.zeros(20)
    for seed in range(2000):
        r = Reservoir(2, seed, 2)
        for i in range(20):
            r.offer(i)
        for i in r.items:
            counts[i] += 1
        if seed == 0:
            first = list(r.items)
    r = Reservoir(2, 0, 2)
    for i in range(20):
        r.offer(i)
    assert r.items == first
    assert counts.min() > 0.7 * 200 and counts.max() < 1.3 * 200


# PERF.md's bounds at 3.35 TB/s, bench4k.jpg: 64,800 segments of 9 words,
# 3840 x 2160 4:2:2, four data units an MCU.
S422 = ((2, 1), (1, 1), (1, 1))
FLOAT_OP = roofline.operand_bytes(4, exact=False)
INT_OP = roofline.operand_bytes(4, exact=True)


@pytest.mark.parametrize("fn, args, bound_ms", [
    (roofline.k2_bytes, (64800, 9, 2160, 3840, FLOAT_OP), 0.01062),
    (roofline.k2_bytes, (64800, 9, 2160, 3840, INT_OP), 0.01060),
    (roofline.k3_bytes, (64800, 9, 2160, 3840, S422, INT_OP), 0.00565),
    (roofline.k3_bytes, (64800, 9, 2160, 3840, S422, FLOAT_OP), 0.00567),
    (roofline.e_bytes, (2160, 3840, ((2, 1), (1, 1), (1, 1))), 0.01486),
    (roofline.e_bytes, (2160, 3840, ((2, 2), (1, 1), (1, 1))), 0.01362),
])
def test_byte_counts_give_the_recorded_bounds(fn, args, bound_ms):
    assert roofline.bound_s(fn(*args)) * 1e3 == pytest.approx(bound_ms,
                                                              abs=5e-6)


def test_decode_counts_the_work_not_the_kernels():
    """The whole decode reads the entropy-coded data once and writes RGBA
    once: the program's packed rows and K3 + E's planes in between are not
    counted."""
    scan = 1_700_000
    assert roofline.decode_bytes(scan, 2160, 3840) == \
        scan + roofline.rgba_bytes(2160, 3840)
    assert roofline.decode_bytes(scan, 2160, 3840) < roofline.k2_bytes(
        64800, 9, 2160, 3840)
    s = ((2, 2), (1, 1), (1, 1))
    assert roofline.decode_bytes(scan, 2160, 3840) < (
        roofline.k3_bytes(64800, 9, 2160, 3840, s)
        + roofline.e_bytes(2160, 3840, s))


def test_scan_bytes_leave_out_markers_and_stuffing():
    app = b"\xff\xe0\x00\x04ab"
    sos = b"\xff\xda\x00\x03\x01"
    scan = b"\x12\xff\x00\x34\xff\xd0\x56\xff\xd1\x78"
    jpeg = b"\xff\xd8" + app + sos + scan + b"\xff\xd9"
    assert roofline.scan_bytes(jpeg) == len(scan) - 2 * 2 - 1


def test_scan_bytes_of_a_drawn_frame_count_its_segments_data():
    """On a frame of the benchmark's own: the scan less two bytes for each
    marker between its segments and one for each stuffed zero, counted
    byte by byte."""
    from perfbench.inputs import frames as F

    from .test_perfbench_inputs import small_config

    src = F.source(small_config("uvc4k_422"))
    data = src.frame(11, 0)
    body = data[len(src.header):-2]
    stuffed = sum(1 for a, b in zip(body, body[1:]) if a == 0xFF and b == 0)
    assert roofline.scan_bytes(data) == \
        len(body) - 2 * (src.segments - 1) - stuffed
