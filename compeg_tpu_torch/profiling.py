"""Timing / tracing instrumentation.

The reference instruments its host path with per-stage wall timers logged at
trace level (``t_preprocess``, ``t_enqueue_writes`` in ``enqueue``,
``t_poll`` in ``decode_blocking``; reference src/lib.rs:391-412,472-475,
516-522). This module (the port's copy of compeg_tpu/profiling.py) provides
the same facility for this engine plus device-side timing on a CUDA card:

    with stage_timer("preprocess"):
        ...
    log_stats()                     # dump accumulated stats at trace level

    ms, rows = trace_device_ms(lambda: dec.decode_prepared(pf))
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterator

log = logging.getLogger("compeg_tpu_torch.profiling")


@dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    @property
    def mean_ms(self) -> float:
        return self.total_s / self.count * 1e3 if self.count else 0.0


_stats: Dict[str, StageStats] = defaultdict(StageStats)


@contextlib.contextmanager
def stage_timer(name: str) -> Iterator[None]:
    """Accumulate wall time for a named pipeline stage; logs at trace level
    (DEBUG-5) like the reference's ``time()`` helper (src/lib.rs:532-536)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        s = _stats[name]
        s.count += 1
        s.total_s += dt
        s.max_s = max(s.max_s, dt)
        log.debug("t_%s: %.3f ms", name, dt * 1e3)


def get_stats() -> Dict[str, StageStats]:
    return dict(_stats)


def reset_stats() -> None:
    _stats.clear()


def log_stats(level: int = logging.INFO) -> None:
    for name, s in sorted(_stats.items()):
        log.log(
            level,
            "%s: n=%d mean=%.3f ms max=%.3f ms",
            name,
            s.count,
            s.mean_ms,
            s.max_s * 1e3,
        )


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


def trace_device_ms(run_frame, frames: int = 5):
    """Device time per frame over ``frames`` calls of ``run_frame()`` (launch
    the frame's device work on the current stream, return the output
    tensor): the sum of CUDA-event times around each call, which counts the
    kernels and copies the call enqueues and the gaps between them.

    Returns ``(total_ms_per_frame, rows)``, rows = ``[(ms_per_frame,
    count_per_frame, kernel name)]`` from a ``torch.profiler`` window over
    the same calls; rows is empty where the profiler shows no device time.
    Raises without a CUDA device: a host clock is no device time.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = run_frame()  # warm-up: builds, caches, allocator
    last = out[-1] if isinstance(out, (tuple, list)) else out
    if not last.is_cuda:
        raise RuntimeError("trace_device_ms needs tensors on a CUDA device")
    hard_sync(out)
    total = 0.0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = run_frame()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        hard_sync(out)
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        is_kernel = getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type)
        if us and is_kernel:
            rows.append((us / frames / 1e3, e.count // frames, e.key))
    rows.sort(reverse=True)
    return total / frames, rows
