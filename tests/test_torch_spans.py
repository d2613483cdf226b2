"""The port's spans (``profiling.stage_timer``): nested ``compeg.*`` spans
in a ``torch.profiler`` trace while a session records, no ``record_function``
at all while none does, exact counts under concurrent threads, and the
stream's waits counted."""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from compeg_tpu_torch import Decoder, StreamDecoder
from compeg_tpu_torch import profiling as P
from compeg_tpu_torch.encoder import encode

STAGES = ("decode", "prepare", "parse", "preprocess", "upload", "launch",
          "readback")


def frame(seed=0, h=32, w=48):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    return encode(img, sampling="420", quality=85, restart_interval_mcus=1)


def spans(path):
    """The ``compeg.*`` complete events of a chrome trace, by name."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name", "").startswith(P.SPAN_PREFIX):
            out.setdefault(e["name"][len(P.SPAN_PREFIX):], []).append(e)
    return out


def inside(child, parent):
    return (parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


@pytest.mark.parametrize("method", ["decode", "decode_rgba"])
def test_a_traced_decode_nests_its_stages_on_one_thread(method, tmp_path):
    dec = Decoder(device="cpu")
    data = frame()
    getattr(dec, method)(data)  # header cache and row width, untraced
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        getattr(dec, method)(data)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    got = spans(path)
    assert set(STAGES) <= set(got)
    one = {k: v[0] for k, v in got.items()}
    assert all(len(got[k]) == 1 for k in STAGES)
    for k in STAGES[1:]:
        assert inside(one[k], one["decode"]), k
    for k in ("parse", "preprocess"):
        assert inside(one[k], one["prepare"]), k
    for k in ("upload", "launch", "readback"):
        assert not inside(one[k], one["prepare"]), k
    assert len({(one[k]["pid"], one[k]["tid"]) for k in STAGES}) == 1
    assert {one[k]["cat"] for k in STAGES} == {"user_annotation"}


@pytest.mark.parametrize("method", ["decode", "decode_rgba"])
def test_no_session_no_record_function_and_every_stage_counted(
        method, monkeypatch):
    made = []

    def counting(name):
        made.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(P, "record_function", counting)
    dec = Decoder(device="cpu")
    data = frame(1)
    P.reset_stats()
    getattr(dec, method)(data)
    assert made == []
    stats = P.get_stats()
    assert {k: stats[k].count for k in STAGES} == dict.fromkeys(STAGES, 1)
    # the patched name is the one the spans use
    with profile(activities=[ProfilerActivity.CPU]):
        getattr(dec, method)(data)
    assert sorted(made) == sorted(P.SPAN_PREFIX + k for k in STAGES)
    assert P.get_stats()["decode"].count == 2
    P.reset_stats()


def test_concurrent_spans_count_exactly():
    threads, each = 8, 5000
    P.reset_stats()
    start = threading.Barrier(threads)

    def work():
        start.wait(timeout=60)
        for _ in range(each):
            with P.stage_timer("x"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    s = P.get_stats()["x"]
    assert s.count == threads * each
    assert 0 <= s.max_s <= s.total_s
    P.reset_stats()
    assert P.get_stats() == {}


def test_a_span_that_raises_is_counted_and_the_error_passes():
    P.reset_stats()
    with pytest.raises(KeyError):
        with profile(activities=[ProfilerActivity.CPU]):
            with P.stage_timer("fails"):
                raise KeyError("x")
    assert P.get_stats()["fails"].count == 1
    P.reset_stats()


@pytest.mark.parametrize("threads,waits", [
    (2, {"ring_wait", "stream_wait_prepare"}),
    (1, {"ring_wait"}),
])
def test_the_streams_waits_are_counted(threads, waits):
    frames = [frame(i) for i in range(6)]
    sd = StreamDecoder(device="cpu", depth=2, prepare_threads=threads)
    P.reset_stats()
    outs = list(sd.decode_iter(frames))
    assert len(outs) == 6
    stats = P.get_stats()
    assert waits <= set(stats)
    assert stats["ring_wait"].count == 6
    if "stream_wait_prepare" in waits:
        assert stats["stream_wait_prepare"].count == 6
    else:
        assert "stream_wait_prepare" not in stats
    assert stats["upload"].count == stats["launch"].count == 6
    P.reset_stats()


@pytest.mark.parametrize("how", ["with", "start"])
def test_the_bridges_flag_is_torchs_and_follows_a_session(how):
    flag = P.PROFILER_FLAG
    mod = torch.autograd.profiler
    assert hasattr(mod, flag)
    assert getattr(mod, flag) is False
    if how == "with":
        with profile(activities=[ProfilerActivity.CPU]):
            assert getattr(mod, flag) is True
    else:
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        try:
            assert getattr(mod, flag) is True
        finally:
            prof.stop()
    assert getattr(mod, flag) is False
