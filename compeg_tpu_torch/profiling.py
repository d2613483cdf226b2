"""Timing / tracing instrumentation.

The reference instruments its host path with per-stage wall timers logged at
trace level (``t_preprocess``, ``t_enqueue_writes`` in ``enqueue``,
``t_poll`` in ``decode_blocking``; reference src/lib.rs:391-412,472-475,
516-522). This module (the port's copy of compeg_tpu/profiling.py) provides
the same facility for this engine plus device-side timing on a CUDA card:

    with stage_timer("preprocess"):  # a span: counted always, and traced
        ...                          # while a torch.profiler session records
    count(PINNED_READBACKS)         # an event with no span of its own
    count(LANES_LAUNCHED, n)        # an amount with no span of its own
    log_stats()                     # dump accumulated stats and counts

    ms, rows = trace_device_ms(lambda: dec.decode_prepared(pf))

    with device_trace(logdir):      # torch.profiler trace to logdir
        decoder.decode(...)
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import re
import tempfile
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

log = logging.getLogger("compeg_tpu_torch.profiling")

# The module global of torch.autograd.profiler that a torch.profiler session
# sets while it records (``with profile(...)`` and ``profile().start()``
# alike) and clears when it stops. It is private, so a span reads it by this
# name alone, and a test fails where a torch release moves it.
PROFILER_FLAG = "_is_profiler_enabled"
# The prefix of every span's name in a profiler trace.
SPAN_PREFIX = "compeg."


@dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    @property
    def mean_ms(self) -> float:
        return self.total_s / self.count * 1e3 if self.count else 0.0


_stats: Dict[str, StageStats] = {}
_counts: Dict[str, int] = {}
_lock = threading.Lock()  # spans end on several threads at once

# The count of one-shot readbacks that went into a block of torch's
# pinned-memory cache (``pipeline.to_host``). Beside it the cache's own
# count of new page-locked blocks (:func:`host_allocs`) gives the cache's
# hit share, 1 - new blocks / pinned readbacks.
PINNED_READBACKS = "readback_pinned"
# What a decode launch asks of the card, counted once a launch
# (``pipeline.count_launch``): the decode lanes it launches (one a restart
# segment of each frame, or the lanes a long segment is cut into) and the
# MCUs of its frames. Their quotient is the serial depth of one lane, in
# MCUs.
LANES_LAUNCHED = "lanes_launched"
MCUS_LAUNCHED = "mcus_launched"
# The bytes of zero rows that ``Decoder.prepare`` packs past a frame's last
# segment (its buffer holds ``row_capacity(nseg)`` rows), counted once a
# prepare.
PACK_PAD_BYTES = "pack_pad_bytes"


class stage_timer:
    """A span of a named pipeline stage: its wall time is added to the
    stage's :class:`StageStats` (like the reference's ``time()`` helper,
    src/lib.rs:532-536), and while a ``torch.profiler`` session records it
    is also a ``record_function`` span ``compeg.<name>``, on the calling
    thread and the trace's clock, nested in the span that encloses it. With
    no session it never touches ``record_function``, whose enter and exit
    cost tens of microseconds."""

    __slots__ = ("name", "_t0", "_span")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        self._span = None
        if getattr(_autograd_profiler, PROFILER_FLAG):
            self._span = record_function(SPAN_PREFIX + self.name)
            self._span.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self._t0
        if self._span is not None:
            self._span.__exit__(*exc)
        with _lock:
            s = _stats.get(self.name)
            if s is None:
                s = _stats[self.name] = StageStats()
            s.count += 1
            s.total_s += dt
            if dt > s.max_s:
                s.max_s = dt


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the count of ``name``: events, or an amount, that have
    no span of their own."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def get_stats() -> Dict[str, StageStats]:
    """A copy of every stage's stats, taken at one instant."""
    with _lock:
        return {k: dataclasses.replace(v) for k, v in _stats.items()}


def get_counts() -> Dict[str, int]:
    """A copy of every :func:`count`, taken at one instant."""
    with _lock:
        return dict(_counts)


def reset_stats() -> None:
    """Clear the stages' stats and the counts."""
    with _lock:
        _stats.clear()
        _counts.clear()


def host_allocs() -> int:
    """The page-locked blocks torch's pinned-memory cache has made in this
    process (``num_host_alloc`` of ``torch.cuda.host_memory_stats()``; a
    request the cache serves from a block it holds adds nothing), 0 before
    CUDA is initialised."""
    import torch

    if not torch.cuda.is_initialized():
        return 0
    return torch.cuda.host_memory_stats()["num_host_alloc"]


def log_stats(level: int = logging.INFO) -> None:
    for name, s in sorted(get_stats().items()):
        log.log(
            level,
            "%s: n=%d mean=%.3f ms max=%.3f ms",
            name,
            s.count,
            s.mean_ms,
            s.max_s * 1e3,
        )
    counts = get_counts()
    for name, n in sorted(counts.items()):
        log.log(level, "%s: n=%d", name, n)
    pinned = counts.get(PINNED_READBACKS)
    if pinned:
        # The blocks are the process's, from every user of the cache and
        # from before the last reset: the share is a lower bound.
        allocs = host_allocs()
        log.log(level, "pinned-memory cache: %d page-locked blocks made, "
                "%d pinned readbacks (hit share >= %.4f)", allocs, pinned,
                1 - allocs / pinned)


def hard_sync(x) -> None:
    """Wait until the device work that produces tensor ``x`` (or the last of
    a tuple or list of tensors) has completed: ``torch.cuda.synchronize`` on
    the tensor's device. A CPU tensor is complete already."""
    import torch

    if isinstance(x, (tuple, list)):
        x = x[-1]
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


SPIN_CYCLES = 3_000_000  # about 1.7 ms of an H100's clock


def burst_ms(fn, burst: int = 8) -> float:
    """The card's time per call, in ms, of ``burst`` calls ``fn(0)`` ..
    ``fn(burst - 1)`` between two CUDA events on the current stream.

    The calls are enqueued while the card still spins in a kernel launched
    just before the first event, so they run back to back and the time is
    the card's, whatever the host takes to launch a call (tens of
    microseconds through a Python wrapper, more than a short kernel runs).
    A burst whose enqueueing outlasts the spin times the host again."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    spin = getattr(torch.cuda, "_sleep", None)
    if spin is not None:
        spin(SPIN_CYCLES)
    a.record()
    for i in range(burst):
        fn(i)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / burst


# torch.profiler's chrome-trace categories of the card's own work, in the
# spellings of newer and of older Kineto releases.
DEVICE_CATEGORIES = {
    "kernel": "kernel", "Kernel": "kernel",
    "gpu_memcpy": "memcpy", "Memcpy": "memcpy",
    "gpu_memset": "memset", "Memset": "memset",
}
# Copies that touch host memory ("Memcpy HtoD (Pageable -> Device)", ...):
# transfers, which the JAX package's XLA Ops lane does not hold either.
HOST_COPIES = ("HtoD", "DtoH", "HtoH")
TRACE_FILE = "trace.json"
# The record_function span that marks the traced calls inside a trace
# window, and how many calls warm the window up before it. A torch.profiler
# session started long after the last one (tens of seconds, in a process
# that has done other work) can lose its first few device records; calls
# made before the marked span take that loss, and only device work launched
# inside the span is read (:func:`read_trace`).
WINDOW = "compeg_traced_calls"
WARM_CALLS = 5
# The host calls that enqueue work on the card, each of which leaves a
# device record with its correlation id (cudaLaunchHostFunc, which runs a
# host function, does not match).
LAUNCH_CALL = re.compile(
    r"cu(da)?(LaunchKernel|LaunchCooperativeKernel|Memcpy|Memset)")
# Trace sessions :func:`trace_device` makes before it gives up on a
# profiler that keeps losing device records.
TRACE_ATTEMPTS = 3


class LostEvents(RuntimeError):
    """The trace holds a launch whose device record the profiler lost."""


@dataclass
class DeviceBusy:
    """What a trace says the card did (:func:`device_busy`).

    ``total_ms`` and ``rows`` are per frame, the rest over the whole window.
    ``event_ms`` is set by :func:`trace_device` only."""

    total_ms: float  # kernels, device-to-device copies and memsets
    rows: List[Tuple[float, int, str]]  # (ms, count, name), transfers too
    union_ms: float  # every device interval, overlaps counted once
    span_ms: float  # the first device event's start to the last one's end
    intervals: List[Tuple[float, float]]  # the union, (start_us, end_us)
    counted: Dict[str, int]  # events summed into total_ms, by category
    event_ms: Optional[float] = None  # CUDA-event spans around each call


def device_busy(events: Iterable[Tuple[str, str, float, float]],
                frames: int = 1) -> DeviceBusy:
    """The card's busy time in ``events``, ``(name, category, start_us,
    dur_us)`` as :func:`read_trace` gives them, over ``frames`` frames.

    ``total_ms`` sums the durations of the work the card does itself
    (kernels, device-to-device copies, memsets), which is what the JAX
    package sums from its XLA Ops lane: busy time, with no host gaps and no
    host transfers. Host-to-device and device-to-host copies still appear
    in ``rows`` under their own names, and in the union and the span, where
    a copy on one stream that overlaps a kernel on another counts once.
    Raises when the events hold no such work."""
    agg: Dict[str, float] = defaultdict(float)
    cnt: Dict[str, int] = defaultdict(int)
    counted: Dict[str, int] = defaultdict(int)
    spans = []
    total = 0.0
    for name, cat, ts, dur in events:
        kind = DEVICE_CATEGORIES.get(cat)
        if kind is None:
            continue
        agg[name] += dur
        cnt[name] += 1
        spans.append((ts, ts + dur))
        if kind == "memcpy" and any(d in name for d in HOST_COPIES):
            continue
        total += dur
        counted[cat] += 1
    if total == 0.0:
        raise RuntimeError("trace contains no device kernel, "
                           "device-to-device copy or memset events")
    merged: List[Tuple[float, float]] = []
    for lo, hi in sorted(spans):
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    rows = sorted(((v / frames / 1e3, cnt[k] // frames, k)
                   for k, v in agg.items()), reverse=True)
    return DeviceBusy(
        total_ms=total / frames / 1e3, rows=rows,
        union_ms=sum(hi - lo for lo, hi in merged) / 1e3,
        span_ms=(merged[-1][1] - merged[0][0]) / 1e3, intervals=merged,
        counted=dict(counted))


def unmatched_launches(events: Iterable[dict]) -> Dict[str, int]:
    """The host calls among the chrome-trace ``events`` that enqueue work
    on the card (:data:`LAUNCH_CALL`) but whose correlation id no device
    event carries, counted by name: the device records the profiler lost."""
    done = {e["args"]["correlation"] for e in events
            if e.get("cat") in DEVICE_CATEGORIES
            and "correlation" in e.get("args", {})}
    lost: Dict[str, int] = defaultdict(int)
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if (corr is not None and corr not in done
                and e.get("cat") not in DEVICE_CATEGORIES
                and LAUNCH_CALL.match(e.get("name", ""))):
            lost[e["name"]] += 1
    return dict(lost)


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None) -> Iterator[None]:
    """A ``torch.profiler`` trace (CPU and, where there is a card, CUDA
    activities) of the block, written as ``logdir/trace.json`` (chrome
    trace format, :func:`read_trace`); no-op when no logdir is given. The
    card is synchronized before the profiler stops, so that the block's
    device work is in the trace. Mark the calls to be read with
    ``torch.profiler.record_function(WINDOW)`` after a few warm-up calls
    (:data:`WINDOW`)."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def read_trace(logdir: str, window: Optional[str] = None
               ) -> List[Tuple[str, str, float, float]]:
    """The complete events of :func:`device_trace`'s trace in ``logdir``:
    ``(name, category, start_us, dur_us)``, host and device alike, on one
    clock. With ``window``, the name of a ``record_function`` span in the
    trace, only the host events inside that span and the device events
    that host calls inside it launched (by the profiler's correlation ids)
    are kept. Raises :class:`LostEvents` where a launch among the kept
    events has no device record (:func:`unmatched_launches`)."""
    with open(os.path.join(logdir, TRACE_FILE)) as f:
        trace = json.load(f)
    events = [e for e in trace["traceEvents"]
              if e.get("ph") == "X" and "ts" in e]
    if window is not None:
        spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                 for e in events if e.get("name") == window
                 and not e.get("cat", "").startswith("gpu_")]
        if len(spans) != 1:
            raise RuntimeError(f"the trace holds {len(spans)} spans named "
                               f"{window!r}, not one")
        lo, hi = spans[0]

        def inside(e):
            return lo <= float(e["ts"]) <= hi

        launched = {e["args"]["correlation"] for e in events
                    if e.get("cat") not in DEVICE_CATEGORIES and inside(e)
                    and "correlation" in e.get("args", {})}
        events = [e for e in events if (
            e.get("args", {}).get("correlation") in launched
            if e.get("cat") in DEVICE_CATEGORIES else inside(e))]
    lost = unmatched_launches(events)
    if lost:
        raise LostEvents(f"the trace lost the device records of "
                         f"{sum(lost.values())} launches: {lost}")
    return [(e.get("name", ""), e.get("cat", ""), float(e["ts"]),
             float(e.get("dur", 0))) for e in events]


def trace_device(run_frame, frames: int = 5) -> DeviceBusy:
    """:func:`device_busy` of ``frames`` calls of ``run_frame()`` (launch
    the frame's device work on the current stream, return the output
    tensor) under :func:`device_trace`, after one call outside the trace
    and :data:`WARM_CALLS` inside it that are not read, with ``event_ms``:
    the CUDA-event span around each call, per frame, which counts the gaps
    the host leaves and the transfers too. The trace goes to a temporary
    directory that is deleted. A trace that lost device records
    (:class:`LostEvents`) is taken again, up to :data:`TRACE_ATTEMPTS`
    sessions. Raises without a CUDA device (a host clock is no device time),
    where the profiler shows no device work, and where every session lost
    records."""
    import torch

    out = run_frame()  # warm-up: builds, caches, allocator
    last = out[-1] if isinstance(out, (tuple, list)) else out
    if not last.is_cuda:
        raise RuntimeError("trace_device_ms needs tensors on a CUDA device")
    hard_sync(out)
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        spans = 0.0
        with tempfile.TemporaryDirectory(prefix="compeg_trace_") as logdir:
            with device_trace(logdir):
                for _ in range(WARM_CALLS):
                    hard_sync(run_frame())
                with record_function(WINDOW):
                    for _ in range(frames):
                        a = torch.cuda.Event(enable_timing=True)
                        b = torch.cuda.Event(enable_timing=True)
                        a.record()
                        out = run_frame()
                        b.record()
                        b.synchronize()
                        spans += a.elapsed_time(b)
            try:
                events = read_trace(logdir, WINDOW)
                break
            except LostEvents as e:
                if attempt == TRACE_ATTEMPTS:
                    raise
                log.warning("trace session %d of %d: %s; tracing again",
                            attempt, TRACE_ATTEMPTS, e)
    busy = device_busy(events, frames)
    busy.event_ms = spans / frames
    return busy


def trace_device_ms(run_frame, frames: int = 5):
    """Device time per frame over ``frames`` calls of ``run_frame()``:
    ``(total_ms_per_frame, rows)`` of :func:`trace_device`, rows =
    ``[(ms_per_frame, count_per_frame, name)]``. The total is the card's
    busy time (kernels, device-to-device copies, memsets), as the JAX
    package's is the sum of its XLA Ops lane; host transfers are rows but
    not in the total."""
    busy = trace_device(run_frame, frames)
    return busy.total_ms, busy.rows
