"""The program's own counters, as the per-layer readers take them.

``compeg_tpu_torch.profiling`` keeps a count a name (``get_counts()``: an
event or an amount added where it happens) and a count a span
(``get_stats()``). A reader takes a counter over a count of calls, both
since the process started: a run is one process that decodes one cell's
frames, all of one geometry, so that mean is the mean of the window's calls
too. A program without the counter gives None, not 0.

The names are the yardstick's, written here and not taken from the
program: a program that renames a counter falls silent.
"""

from __future__ import annotations

from typing import Optional


def count(name: str) -> Optional[int]:
    """The program's count of ``name``; None where it keeps none."""
    from compeg_tpu_torch import profiling

    return profiling.get_counts().get(name)


def spans(stage: str) -> int:
    """How many ``stage`` spans the program has ended (0 for none)."""
    from compeg_tpu_torch import profiling

    s = profiling.get_stats().get(stage)
    return 0 if s is None else s.count


def ratio(num: Optional[float], den: Optional[float]) -> Optional[float]:
    """``num / den``; None where either is missing or ``den`` is 0."""
    if num is None or not den:
        return None
    return num / den
