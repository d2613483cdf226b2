"""Reading a ``torch.profiler`` chrome trace into what the card did.

The arithmetic is a frozen copy of the program's own (``profiling.
device_busy``, ``unmatched_launches`` and ``read_trace``, and
``tools/bench_stream.idle_gaps`` and the top-ops table of
``tools/trace_ops``), kept here so that a change to the program cannot
move the yardstick: device intervals from the trace's kernel, memcpy and
memset records, their union (overlaps on different streams counted once),
the launches whose device record the profiler lost, and the longest idle
gaps with the host events that ran in each.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Tuple

# Chrome-trace categories of the card's own work, in the spellings of newer
# and older Kineto releases.
DEVICE_CATEGORIES = {
    "kernel": "kernel", "Kernel": "kernel",
    "gpu_memcpy": "memcpy", "Memcpy": "memcpy",
    "gpu_memset": "memset", "Memset": "memset",
}
# Host calls that enqueue work on the card and leave a device record with
# their correlation id.
LAUNCH_CALL = re.compile(
    r"cu(da)?(LaunchKernel|LaunchCooperativeKernel|Memcpy|Memset)")
# The record_function span that marks the traced stretch.
WINDOW = "perfbench_traced_stretch"

Event = Tuple[str, str, float, float]  # (name, category, start_us, dur_us)


class LostEvents(RuntimeError):
    """The trace holds a launch whose device record the profiler lost."""


def unmatched_launches(events: Iterable[dict]) -> Dict[str, int]:
    """Launch calls among chrome-trace ``events`` whose correlation id no
    device event carries, counted by name."""
    events = list(events)
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


@dataclass
class Stretch:
    """The traced stretch: its events and its bounds on the trace's clock."""

    events: List[Event]  # host events inside it, device events it launched
    lo_us: float  # the marked span's start
    hi_us: float  # its end, or the last device event's end if later


def read_trace(path: str, window: str = WINDOW) -> Stretch:
    """The complete events of the trace at ``path`` inside the one span
    named ``window``: the host events inside it and the device events that
    host calls inside it launched. Raises :class:`LostEvents` where a launch
    among them has no device record."""
    with open(path) as f:
        trace = json.load(f)
    events = [e for e in trace["traceEvents"]
              if e.get("ph") == "X" and "ts" in e]
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
    kept = [e for e in events if (
        e.get("args", {}).get("correlation") in launched
        if e.get("cat") in DEVICE_CATEGORIES else inside(e))]
    lost = unmatched_launches(kept)
    if lost:
        raise LostEvents(f"the trace lost the device records of "
                         f"{sum(lost.values())} launches: {lost}")
    out = [(e.get("name", ""), e.get("cat", ""), float(e["ts"]),
            float(e.get("dur", 0))) for e in kept]
    end = max([ts + dur for _, cat, ts, dur in out
               if cat in DEVICE_CATEGORIES] + [hi])
    return Stretch(out, lo, end)


def device_intervals(events: Iterable[Event]) -> List[Tuple[float, float]]:
    """The union of the device events' intervals (us), sorted."""
    spans = sorted((ts, ts + dur) for _, cat, ts, dur in events
                   if cat in DEVICE_CATEGORIES)
    merged: List[Tuple[float, float]] = []
    for lo, hi in spans:
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def busy_s(intervals: Sequence[Tuple[float, float]]) -> float:
    """Seconds in which some device operation ran."""
    return sum(hi - lo for lo, hi in intervals) / 1e6


NAME = 100  # characters of an operation's name kept


def top_ops(events: Iterable[Event], top: int = 10) -> List[list]:
    """``[[name, seconds], ...]`` of the device operations that took most
    time, longest first (a name cut to its first :data:`NAME`
    characters)."""
    agg: Dict[str, float] = defaultdict(float)
    for name, cat, _, dur in events:
        if cat in DEVICE_CATEGORIES:
            agg[name[:NAME]] += dur / 1e6
    return [[n, s] for n, s in sorted(agg.items(), key=lambda kv: -kv[1])][
        :top]


def idle_gaps(events: Sequence[Event],
              intervals: Sequence[Tuple[float, float]], lo: float,
              hi: float, top: int = 5, names: int = 4) -> List[list]:
    """``[[label, seconds], ...]`` of the ``top`` longest gaps in
    ``[lo, hi]`` between the device's busy ``intervals``, longest first;
    the label says where the gap starts (ms into the stretch) and names the
    host events that overlap it most."""
    edges = [lo] + [x for iv in intervals for x in iv] + [hi]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2])
                   if b > a), reverse=True)
    out = []
    for length, a, b in gaps[:top]:
        host: Dict[str, float] = defaultdict(float)
        for name, cat, ts, dur in events:
            if (cat in DEVICE_CATEGORIES or cat.startswith("gpu_")
                    or name == WINDOW):
                continue
            overlap = min(b, ts + dur) - max(a, ts)
            if overlap > 0:
                host[name] += overlap
        who = [n for n, _ in sorted(host.items(), key=lambda kv: -kv[1])][
            :names]
        out.append([f"at {(a - lo) / 1e3:.3f} ms: "
                    f"{', '.join(who) or 'no host event traced'}",
                    length / 1e6])
    return out
