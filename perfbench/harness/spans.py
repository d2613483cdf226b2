"""The program's own spans in the traced stretch, and the card's idle time
inside them.

While a ``torch.profiler`` session records, each stage of
``compeg_tpu_torch`` is a ``record_function`` span named ``compeg.<stage>``
(``profiling.stage_timer``): category ``user_annotation`` on the host
thread that ran it, on the clock of the kernel and copy records. Under CUDA
profiling a span also leaves a ``gpu_user_annotation`` record on the device
lanes, which is not read here. A program without such spans gives no value
(None), not 0.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

PREFIX = "compeg."
CATEGORY = "user_annotation"

Interval = Tuple[float, float]  # (start_us, end_us)


def intervals(events, stage: str) -> List[Interval]:
    """``(start_us, end_us)`` of every ``compeg.<stage>`` span among
    ``(name, category, start_us, dur_us)`` events, in trace order."""
    name = PREFIX + stage
    return [(ts, ts + dur) for n, cat, ts, dur in events
            if cat == CATEGORY and n == name]


def union(spans: Sequence[Interval]) -> List[Interval]:
    """The union of ``spans``, sorted, overlaps counted once."""
    merged: List[Interval] = []
    for lo, hi in sorted(spans):
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        elif hi > lo:
            merged.append((lo, hi))
    return merged


def idle(busy: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The complement of the sorted, disjoint ``busy`` inside ``[lo, hi]``."""
    out: List[Interval] = []
    at = lo
    for a, b in busy:
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def overlap_us(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """The length of the intersection of two sorted, disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def mean_ms(ctx, stage: str) -> Optional[float]:
    """The mean duration, in ms, of the stretch's ``compeg.<stage>`` spans;
    None without a trace or without such a span."""
    if ctx.stretch is None:
        return None
    spans = intervals(ctx.stretch.events, stage)
    if not spans:
        return None
    return sum(hi - lo for lo, hi in spans) / len(spans) / 1e3


def idle_in_pct(ctx, stage: str) -> Optional[float]:
    """100 x the time in which the card is idle (no kernel, memcpy or
    memset: the complement of ``ctx.intervals``) and some host thread is
    inside a ``compeg.<stage>`` span, over the stretch; None without a
    trace or without such a span."""
    if ctx.stretch is None:
        return None
    spans = intervals(ctx.stretch.events, stage)
    if not spans:
        return None
    lo, hi = ctx.stretch.lo_us, ctx.stretch.hi_us
    if hi <= lo:
        return None
    inside = union([(max(a, lo), min(b, hi)) for a, b in spans])
    return 100.0 * overlap_us(inside, idle(ctx.intervals, lo, hi)) / (hi - lo)
