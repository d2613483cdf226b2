"""One run of one cell: find the cell, its configuration and its traffic by
name, set up, measure a window, read the metrics, check the outputs
against the plain reference, print the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by its name in ``BENCHMARK.json``:
``perfbench/configs/<config>.json``, ``perfbench/traffic/<traffic>.json``
(its ``loop`` names one of :data:`perfbench.harness.loops.LOOPS`) and
``perfbench/metrics/<metric>.py`` (a ``read(ctx)`` that returns the value,
or None where it finds nothing to read).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..inputs import frames as F
from . import check, trace
from .loops import LOOPS

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "compeg_tpu")
TRACE_ATTEMPTS = 3


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find(bench: dict, key: str, name: str) -> dict:
    for entry in bench[key]:
        if entry["name"] == name:
            return entry
    raise SystemExit(f"no {key} entry named {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, trace_run: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or,
    traced, its per-layer ones (those whose ``workloads`` list it, or, with
    no such list, every cell that reports the metric they move)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace_run:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def reader(name: str, root: str = PERFBENCH) -> Callable:
    """``read`` of ``perfbench/metrics/<name>.py``."""
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, whole, is one the benchmark must
    never load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cards(n: int) -> List[dict]:
    """Name and power limit of the first ``n`` cards, read from nvidia-smi
    by UUID (a copy of the program's ``tools/_common.cards``)."""
    import torch

    uuids = [f"GPU-{torch.cuda.get_device_properties(d).uuid}"
             for d in range(n)]
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,name,power.limit",
         "--format=csv,noheader", "-i", ",".join(uuids)],
        capture_output=True, text=True, check=True, timeout=60)
    found = {}
    for line in res.stdout.strip().splitlines():
        uuid, rest = (p.strip() for p in line.split(",", 1))
        name, limit = (p.strip() for p in rest.rsplit(",", 1))
        try:
            watts: Optional[float] = float(limit.split()[0])
        except ValueError:
            watts = None
        found[uuid] = {"name": name, "power_limit_w": watts}
    return [found[u] for u in uuids]


class Tracer:
    """One ``torch.profiler`` session over a stretch of the window: opened
    ``at_s`` into it, a ``warm_s`` lead that is not read (a late session
    can lose its first device records), then the marked stretch of
    ``stretch_s``; the card is synchronized before the session stops."""

    def __init__(self, at_s: float, warm_s: float, stretch_s: float,
                 path: str, cuda: bool):
        self.at, self.warm, self.stretch = at_s, warm_s, stretch_s
        self.path = path
        self.cuda = cuda
        self.state = 0
        self.frames = 0
        self._f0 = 0
        self._t = 0.0

    def tick(self, now: float, frames: int) -> None:
        """Called by the loop between its calls: ``now`` seconds into the
        window, ``frames`` delivered so far."""
        if self.state == 0 and now >= self.at:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.cuda else [])
            self.prof = profile(activities=acts)
            self.prof.start()
            self.state, self._t = 1, now
        elif self.state == 1 and now >= self._t + self.warm:
            from torch.profiler import record_function

            self.span = record_function(trace.WINDOW)
            self.span.__enter__()
            self.state, self._f0, self._t = 2, frames, now
        elif self.state == 2 and now >= self._t + self.stretch:
            self._stop(frames)

    def _stop(self, frames: int) -> None:
        import torch

        self.span.__exit__(None, None, None)
        self.frames = frames - self._f0
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        self.prof.export_chrome_trace(self.path)
        del self.prof
        self.state = 3

    def close(self, frames: int) -> None:
        """End a session that the window's end cut short."""
        if self.state == 1:
            self.span = None
            self.prof.stop()
            del self.prof
            self.state = 4
        elif self.state == 2:
            self._stop(frames)

    @property
    def done(self) -> bool:
        return self.state == 3

    @property
    def ended(self) -> bool:
        """The session is over: a closed loop runs on past the window's
        end until it is, so that the stretch is whole."""
        return self.state >= 3


class Ctx:
    """What a metric reader reads: the run's configuration and traffic,
    its loop's results, and, in a traced run, the traced stretch."""

    def __init__(self, cfg, traffic, cell, seed, device, loop):
        self.cfg, self.traffic, self.cell = cfg, traffic, cell
        self.seed, self.device, self.loop = seed, device, loop
        self.result = loop.result
        self.setup_s: Optional[float] = None
        self.stretch: Optional[trace.Stretch] = None
        self.intervals: list = []
        self.frames_traced = 0
        self.kind = ""

    @property
    def window_s(self) -> float:
        return (self.stretch.hi_us - self.stretch.lo_us) / 1e6

    @property
    def busy_s(self) -> float:
        return trace.busy_s(self.intervals)

    def frame_bytes(self) -> float:
        """The least bytes one frame's decode moves, the mean over the
        loop's pool, which the traced stretch cycles many times: its
        entropy-coded data read once, counted from the frame's JPEG bytes,
        and its RGBA written once."""
        from .roofline import decode_bytes, scan_bytes

        n = self.traffic["pool_frames"]
        scan = sum(scan_bytes(self.loop.src.frame(self.seed, j))
                   for j in range(n)) / n
        return decode_bytes(scan, self.cfg["height"], self.cfg["width"])

    def prepare_rate(self, threads: int, passes: int, **decoder) -> float:
        """Frames per second of ``Decoder(**decoder).prepare`` on
        ``threads`` threads over the loop's pool, ``passes`` times, after
        one prepare that warms the header cache and the row width: frames
        over the wall (``host_feed_fps``'s arithmetic). Each thread packs
        into a buffer of its own that it reuses, as ``StreamDecoder``'s
        workers reuse their staging buffers."""
        import threading
        from concurrent.futures import ThreadPoolExecutor

        from compeg_tpu_torch import Decoder

        dec = Decoder(device=self.device, **decoder)
        own = threading.local()

        def alloc(rows: int, width: int):
            buf = getattr(own, "buf", None)
            if buf is None or buf.shape != (rows, width):
                buf = own.buf = np.empty((rows, width), np.uint32)
            return buf

        def prepare(data):
            return dec.prepare(data, alloc=alloc)

        frames = self.loop.frames
        prepare(frames[0])
        work = frames * passes
        t0 = time.perf_counter()
        if threads == 1:
            for f in work:
                prepare(f)
        else:
            with ThreadPoolExecutor(threads) as ex:
                list(ex.map(prepare, work))
        return len(work) / (time.perf_counter() - t0)


def parse_args(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(argv, t_start: float, root: str, device: Optional[str] = None,
        overrides: Optional[dict] = None) -> int:
    """One run; prints the result line and returns 0, or returns non-zero
    and prints no result. ``device`` and ``overrides`` (merged into the
    configuration and traffic) serve the CPU tests only: the command line
    always runs on the card."""
    args = parse_args(argv)
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = find(bench, "workloads", args.workload)
    cfg_entry = find(bench, "configs", cell["config"])
    cfg = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(PERFBENCH, "traffic",
                                     f"{cell['traffic']}.json"))
    if overrides:
        cfg.update(overrides.get("config", {}))
        traffic.update(overrides.get("traffic", {}))
    metrics = cell_metrics(bench, cell["name"], bool(args.trace))

    def progress(stage: str) -> None:
        print(f"# [{time.perf_counter() - t_start:8.3f} s] {stage}",
              file=sys.stderr, flush=True)

    import torch

    progress("torch imported")

    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            print(f"perfbench: the cell needs {cell['chips']} CUDA card(s); "
                  f"this machine shows "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = "cuda"
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    info = cards(cell["chips"])[0] if cuda else {"name": "cpu",
                                                 "power_limit_w": None}
    print(f"# device: {info['name']}, {info['power_limit_w']} W",
          file=sys.stderr, flush=True)

    loop = LOOPS[traffic["loop"]](cfg, traffic, dev, args.seed)
    progress("inputs' source ready")
    loop.setup()
    ctx = Ctx(cfg, traffic, cell["name"], args.seed, dev, loop)
    ctx.kind = info["name"]
    ctx.setup_s = time.perf_counter() - t_start
    loop.result["setup_s"] = ctx.setup_s
    progress("set up; the window opens")

    breakdown = None
    with tempfile.TemporaryDirectory(prefix="perfbench_") as tmp:
        tr_cfg = traffic["trace"]
        path = os.path.join(tmp, "trace.json")
        tracer = (Tracer(tr_cfg["at_s"], tr_cfg["warm_s"],
                         tr_cfg["stretch_s"], path, cuda)
                  if args.trace else None)
        loop.run(args.seconds, tracer)
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            if tracer is None:
                break
            if not tracer.done:
                raise RuntimeError("the window ended before the traced "
                                   "stretch did")
            try:
                ctx.stretch = trace.read_trace(path)
                ctx.frames_traced = tracer.frames
                break
            except trace.LostEvents as e:
                if attempt == TRACE_ATTEMPTS:
                    raise
                print(f"# trace session {attempt}: {e}; tracing again",
                      file=sys.stderr, flush=True)
                tracer = Tracer(0.0, tr_cfg["warm_s"], tr_cfg["stretch_s"],
                                path, cuda)
                loop.run(tr_cfg["warm_s"] + tr_cfg["stretch_s"] + 0.5,
                         tracer)
    progress("window closed")
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": info["name"],
                   "count": cell["chips"], "memory_peak_bytes": peak,
                   "power_limit_w": info["power_limit_w"]}
    if ctx.stretch is not None:
        ev = ctx.stretch.events
        ctx.intervals = trace.device_intervals(ev)
        device_info.update(busy_s=ctx.busy_s, window_s=ctx.window_s)
        breakdown = {
            "device_ops": trace.top_ops(ev),
            "idle_gaps": trace.idle_gaps(ev, ctx.intervals,
                                         ctx.stretch.lo_us,
                                         ctx.stretch.hi_us)}
    values: Dict[str, dict] = {}
    for m in metrics:
        v = reader(m["name"])(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    loop.finish()
    progress("metrics read, sample read back")
    sample = loop.sample
    ctx.loop = loop = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    src = F.source(cfg)
    numbers = check.compare(cfg, lambda j: src.frame(args.seed, j),
                            sample, traffic["check_expected"],
                            lanes=lambda j: src.lanes(args.seed, j))
    progress("outputs compared")
    # the loop's own numbers beyond the metrics, for the record
    res = {k: v for k, v in ctx.result.items()
           if k not in ("attempted", "failed")}
    if ctx.stretch is not None:
        # the rate inside the traced stretch, the profiler's cost included
        res["traced_fps"] = ctx.frames_traced / ctx.window_s
    for name, (v, lim) in numbers.items():
        print(f"# check {name}: {v} (limit {lim})", file=sys.stderr)
    correct = (all(v <= lim for v, lim in numbers.values())
               and ctx.result["failed"] == 0)
    line = {"correct": correct, "attempted": ctx.result["attempted"],
            "failed": ctx.result["failed"], "metrics": values,
            "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["run"] = res
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in numbers.items()}
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    root = os.getcwd()
    if not os.path.exists(os.path.join(root, "BENCHMARK.json")):
        root = os.path.dirname(PERFBENCH)
    return run(sys.argv[1:] if argv is None else argv, t_start, root)
