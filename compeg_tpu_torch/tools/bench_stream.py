"""Steady-state streaming: can the host feed the card? The counterpart of
tools/bench_stream.py.

    python -m compeg_tpu_torch.tools.bench_stream              # host rates
    python -m compeg_tpu_torch.tools.bench_stream --device     # + a stream
    python -m compeg_tpu_torch.tools.bench_stream --device cpu # tests only

1. The aggregate prepare rate with T in {1, 2, 4, 6} prepare threads on one
   shared ``Decoder`` (the ``StreamDecoder`` configuration), with the
   pooled and the 1-thread native pack. The best of them against the card's
   rate for the same frame (``profiling.trace_device_ms`` of
   ``decode_prepared``, measured in the same process) says whether the host
   can feed the card.
2. With ``--device``: ``StreamDecoder(depth=3, prepare_threads=4)`` over
   ``--frames`` 4K frames that differ (bench4k with its restart segments
   rotated, as ``chip_smoke.py`` phase h makes them) inside
   ``profiling.device_trace``, after a 2-frame warm-up that is not read:
   the wall and frames/s (the profiler's own cost included), the card's
   busy time (the union of its intervals, a copy that overlaps a kernel on
   another stream counted once) over the span from its first event to its
   last, the idle share, and the longest idle gaps with the host-side
   events (``aten::...`` ops and ``cuda...`` runtime calls) that ran during
   each, all read from the same trace.

``--device`` without a value is the card. ``--device cpu`` streams a
64 x 128 frame on the plain versions and measures no device time. Ends
with one JSON line.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

from . import _common as K

REPS = 40  # prepares a measurement
THREADS = (1, 2, 4, 6)
GAPS = 5  # longest idle gaps shown
HOST_NAMES = 6  # host events named a gap


def idle_gaps(events: Sequence[Tuple[str, str, float, float]],
              intervals: Sequence[Tuple[float, float]],
              top: int = GAPS) -> List[dict]:
    """The ``top`` longest gaps between the card's busy ``intervals``
    (``DeviceBusy.intervals``, µs), longest first: each gap's start in ms
    from the first interval's, its length in ms, and the host events of
    ``events`` (``profiling.read_trace``; every category that is neither
    the card's nor the profiler's own span) that overlap it, by the time
    they overlap it, longest first."""
    from ..profiling import DEVICE_CATEGORIES

    t0 = intervals[0][0] if intervals else 0.0
    gaps = sorted(((b[0] - a[1], a[1], b[0])
                   for a, b in zip(intervals, intervals[1:])), reverse=True)
    out = []
    for length, lo, hi in gaps[:top]:
        host = defaultdict(float)
        for name, cat, ts, dur in events:
            if (cat in DEVICE_CATEGORIES or cat.startswith("gpu_")
                    or cat == "Trace"):  # the profiler's own span
                continue
            overlap = min(hi, ts + dur) - max(lo, ts)
            if overlap > 0:
                host[name] += overlap
        out.append({
            "start_ms": (lo - t0) / 1e3, "ms": length / 1e3,
            "host": [name for name, _ in sorted(
                host.items(), key=lambda kv: -kv[1])[:HOST_NAMES]]})
    return out


def rotated(data: bytes, n: int) -> List[bytes]:
    """``n`` frames that differ: ``data`` with its restart segments rotated
    by ``i`` MCU rows for frame ``i`` (``chip_smoke.py`` phase h), modulo
    the frame's rows."""
    from .. import testdata
    from ..metadata import analyze

    img = analyze(data)
    nseg = img.total_restart_intervals
    return [testdata.rotate_restart_segments(
        data, img.scan_offset, len(img.scan_data),
        img.width_mcus * i % nseg) for i in range(n)]


def prepare_rates(dec_for, data: bytes) -> dict:
    """Aggregate prepare frames/s ``{label: {threads: fps}}`` for the
    pooled and the 1-thread pack, ``dec_for(pack_threads)`` making the
    decoder."""
    rates = {}
    for pack_threads, label in ((None, "pooled pack"), (1, "1-thread pack")):
        dec = dec_for(pack_threads)
        dec.prepare(data)  # warm: width, native build, header cache
        rates[label] = {}
        for t in THREADS:
            with ThreadPoolExecutor(t) as ex:
                t0 = time.perf_counter()
                list(ex.map(lambda _: dec.prepare(data), range(REPS)))
                fps = REPS / (time.perf_counter() - t0)
            rates[label][t] = fps
            print(f"prepare x{t} threads ({label}): {fps:7.1f} frames/s "
                  f"aggregate ({1e3 / fps:.3f} ms/frame effective)",
                  flush=True)
    return rates


def run(argv: Optional[List[str]] = None) -> dict:
    from torch.profiler import record_function

    from .. import profiling
    from ..batch import StreamDecoder
    from ..pipeline import Decoder

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", nargs="?", const="cuda", default=None,
                    choices=("cuda", "cpu"),
                    help="also run a traced stream (on the card without a "
                    "value)")
    ap.add_argument("--frames", type=int, default=64,
                    help="frames of the traced stream")
    args = ap.parse_args(argv)
    dev = K.device(args.device or "cuda")
    cuda = dev.type == "cuda"
    info = K.card(dev)
    data = K.workload(dev)
    print(f"cores={os.cpu_count()}", flush=True)
    rates = prepare_rates(lambda p: Decoder(pack_threads=p, device=dev), data)
    best = max(f for r in rates.values() for f in r.values())

    card_fps = verdict = None
    if cuda:
        dec = Decoder(device=dev)
        pf = dec.prepare(data)
        card_ms, _ = profiling.trace_device_ms(
            lambda: dec.decode_prepared(pf), 5)
        card_fps = 1e3 / card_ms
        verdict = ("HOST CAN FEED THE CARD" if best >= card_fps
                   else "HOST-BOUND")
        print(f"host feed rate {best:.0f} fps vs card {card_fps:.0f} fps "
              f"(trace_device_ms of decode_prepared, {card_ms:.4f} ms) -> "
              f"{verdict} on {info['name']}, {info['power_limit_w']} W",
              flush=True)
    res = {"cores": os.cpu_count(), "prepare_fps": rates,
           "host_feed_fps": best, "card_fps": card_fps, "verdict": verdict,
           "stream": None, "device": info}
    if args.device is None:
        return K.emit(res)

    frames = rotated(data, args.frames)
    sd = StreamDecoder(depth=3, prepare_threads=4, device=dev)
    n = 0
    with tempfile.TemporaryDirectory(prefix="compeg_stream_") as logdir:
        with profiling.device_trace(logdir if cuda else None):
            for _ in sd.decode_iter(frames[:2]):  # warm-up, not read
                pass
            K.sync(dev)
            with record_function(profiling.WINDOW):
                t0 = time.perf_counter()
                for _ in sd.decode_iter(frames):
                    n += 1
                K.sync(dev)
                wall = time.perf_counter() - t0
        events = (profiling.read_trace(logdir, profiling.WINDOW) if cuda
                  else None)
    if n != len(frames):
        raise RuntimeError(f"the stream gave {n} of {len(frames)} frames")
    stream = {"frames": n, "wall_s": None, "fps": None, "busy_ms": None,
              "span_ms": None, "idle_share": None, "gaps": None}
    if cuda:
        busy = profiling.device_busy(events, n)
        idle = 1.0 - busy.union_ms / busy.span_ms
        gaps = idle_gaps(events, busy.intervals)
        stream.update(wall_s=wall, fps=n / wall, busy_ms=busy.union_ms,
                      span_ms=busy.span_ms, idle_share=idle, gaps=gaps,
                      kernel_ms_per_frame=busy.total_ms)
        print(f"stream {n} frames: wall {wall:.3f} s ({n / wall:.1f} fps, "
              "traced)", flush=True)
        print(f"device busy {busy.union_ms:.3f} ms (union; kernels "
              f"{busy.total_ms:.4f} ms a frame) over span "
              f"{busy.span_ms:.3f} ms -> idle {idle * 100:.1f}% on "
              f"{info['name']}, {info['power_limit_w']} W", flush=True)
        for g in gaps:
            print(f"  gap at {g['start_ms']:.3f} ms: {g['ms']:.3f} ms; "
                  f"host: {', '.join(g['host']) or '(none traced)'}",
                  flush=True)
    res["stream"] = stream
    return K.emit(res)


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
