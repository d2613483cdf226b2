"""Weak scaling of the banded decode over ranks, one process a rank: the
counterpart of bench_scaling.py.

    python -m compeg_tpu_torch.tools.bench_scaling                # the cards
    python -m compeg_tpu_torch.tools.bench_scaling --device cpu --max-ranks 2

Every rank holds two 4K frames (bench4k.jpg) resident on its own card and
decodes them as one band each through
``parallel/sharding.decode_batch_sharded`` (kernel K2): one step of the
job. The data-parallel decode exchanges nothing between ranks, so a step
holds no collective; the ranks start their timed steps together at a
barrier, and the job runs at its slowest rank's pace. The steps are timed
by ``parallel/multihost.measure_scaling`` inside each rank, after its
process group is up, so process start-up stays outside the timed loop. The
JAX tool's three measurements:

1. **Mesh curve**: the job at n in {1, 2, 4} ranks, up to the cards the
   host has (``--max-ranks`` caps it), in a process group of n ranks (NCCL,
   rank r on card r; gloo on the CPU); the job's rate is n times its
   slowest rank's, and its efficiency is that over n times the rate at n =
   1.
2. **Independent-process control**: the same one-rank decode in k
   processes with no process group, released together once all are warm,
   each on its own card; its efficiency at the largest n is the ceiling
   the host gives any k copies.
3. **Orchestration probe**: a trivial op on each rank's card through the
   same process-group set-up: the cost of a step without the decode.

``value`` = mesh efficiency at the largest n over the control's, not
capped at 1. A value above 1 by more than the spread of the control's
one-process rates marks the run invalid (``valid`` false, exit 1): the
mesh's n = 1 baseline was slower than one process alone. Each rank
first checks its two frames against ``Decoder().decode_prepared`` byte for
byte. The JAX tool's 64 x 128 frame existed for CPU interpret mode; here it
is the 4K frame. ``--device cpu`` (gloo, one thread a rank, the 64 x 128
frame) is for the tests: it prints no rate or efficiency. Ends with one
JSON line with the JAX tool's keys, without its TPU-era ``vs_baseline``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import List, Optional

from . import _common as K

COUNTS = (1, 2, 4)
FRAMES_PER_RANK = 2


def _rank_setup(rank: int, nproc: int, port: int, device: str,
                group: bool):
    """This rank's device, its process group and (data, seq) mesh (when
    ``group``; else the one-process mesh), and its two frames' rows
    resident on the device with the step that decodes them, checked
    against the one-frame decode."""
    import torch
    import torch.distributed as dist

    from ..batch import BatchDecoder
    from ..parallel import multihost as MH
    from ..parallel import sharding as SH
    from ..pipeline import Decoder

    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)  # one core a rank, as one card a rank
    dev = torch.device(f"cuda:{rank}" if cuda else "cpu")
    if group:
        dist.init_process_group(
            "nccl" if cuda else "gloo", world_size=nproc, rank=rank,
            init_method=f"tcp://127.0.0.1:{port}")
        mesh = MH.global_mesh(1, dev.type)
    else:
        mesh = SH.LocalMesh(dev.type)

    data = K.workload(dev)
    bd = BatchDecoder(device=dev)
    pf = bd.prepare_batch([data] * FRAMES_PER_RANK)[0]
    band_rows = SH.band_rows_for(pf.image, 1)
    nseg = SH.band_segments(pf.image, band_rows)
    rows = bd.upload(nseg).reshape(FRAMES_PER_RANK, 1, nseg, -1)

    def step(n, rows):
        return SH.decode_batch_sharded(rows, nseg, pf.tables, pf.op,
                                       mesh=mesh, geom=pf.geom,
                                       band_rows=band_rows)

    one = Decoder(device=dev)
    want = one.decode_prepared(one.prepare(data))
    got = step(1, rows)
    if not all(torch.equal(f, want) for f in got):
        raise AssertionError(f"rank {rank}: the banded decode differs from "
                             "Decoder().decode_prepared")
    return dev, rows, step


def mesh_worker(rank: int, nproc: int, port: int, device: str) -> dict:
    """One rank of the mesh curve: its decode steps and the probe's."""
    import torch
    import torch.distributed as dist

    from ..parallel import multihost as MH

    dev, rows, step = _rank_setup(rank, nproc, port, device, True)
    together = ((lambda: dist.barrier(device_ids=[rank]))
                if dev.type == "cuda" else dist.barrier)
    try:
        iters, trials = (50, 5) if dev.type == "cuda" else (1, 1)
        together()
        [(_, fps, _)] = MH.measure_scaling(step, lambda n: (rows,), [nproc],
                                           iters, trials)
        tiny = torch.zeros((FRAMES_PER_RANK, 64, 16), dtype=torch.int32,
                           device=dev)

        def probe(n, t):
            return (t * 2).sum(dim=(1, 2))

        together()
        [(_, probe_fps, _)] = MH.measure_scaling(
            probe, lambda n: (tiny,), [nproc], iters, min(trials, 3))
        return {"rank": rank, "fps": fps,
                "probe_ms": FRAMES_PER_RANK / probe_fps * 1e3}
    finally:
        dist.destroy_process_group()


def control_worker(rank: int, device: str) -> dict:
    """One independent process of the control: warm, say ``ready``, wait
    for ``go`` on stdin, then time its own decode steps."""
    from ..parallel import multihost as MH

    dev, rows, step = _rank_setup(rank, 1, 0, device, False)
    iters, trials = (50, 5) if dev.type == "cuda" else (1, 1)
    print("ready", flush=True)
    sys.stdin.readline()
    t0 = time.time()
    [(_, fps, _)] = MH.measure_scaling(step, lambda n: (rows,), [1], iters,
                                       trials)
    return {"rank": rank, "fps": fps, "t0": t0, "t1": time.time()}


def _launch(role: str, nproc: int, device: str,
            timeout: float = 900.0) -> List[dict]:
    """Start ``nproc`` workers of ``role`` together and return each one's
    result; the control's are released at once when all are ready."""
    from ..parallel.multihost import free_port

    cmd = [sys.executable, "-m", "compeg_tpu_torch.tools.bench_scaling",
           "--device", device, "--worker", role, "--nproc", str(nproc),
           "--port", str(free_port())]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [K.ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                    if p])
    control = role == "control"
    procs = [subprocess.Popen(
        cmd + ["--rank", str(r)], cwd=K.ROOT, env=env, text=True,
        stdin=subprocess.PIPE if control else subprocess.DEVNULL,
        stdout=subprocess.PIPE) for r in range(nproc)]
    try:
        if control:
            for p in procs:
                for line in p.stdout:
                    if line.strip() == "ready":
                        break
                else:
                    raise RuntimeError("a control worker ended before it "
                                       "was ready")
            for p in procs:
                p.stdin.write("go\n")
                p.stdin.flush()
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:  # a failed rank leaves its peers waiting
            if p.poll() is None:
                p.kill()
                p.wait()
    res = []
    for p, out in zip(procs, outs):
        lines = out.strip().splitlines()
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"{role} worker failed (rc={p.returncode})")
        res.append(json.loads(lines[-1]))
    # Their aggregate is the ceiling only if they ran at once (measured on
    # the card alone: the CPU's numbers are not printed).
    if control and device == "cuda" and len(res) > 1 and (
            max(r["t0"] for r in res) >= min(r["t1"] for r in res)):
        raise RuntimeError("the control's workers did not overlap: their "
                           "aggregate would overstate the ceiling")
    return res


def attributable(eff: float, c1: float, ck_each: List[float]):
    """``(value, spread, valid)``: the mesh efficiency ``eff`` over the
    machine ceiling (the ``len(ck_each)`` control processes' rates
    ``ck_each`` over as many times the one process's ``c1``), uncapped; the
    spread of one process's rate between the control's runs of the same
    decode (largest over smallest, less 1); and whether the value stays
    within 1 + spread. A value further above 1 says the mesh's n = 1
    baseline was slow, not that the mesh beat the machine."""
    rates = list(ck_each) + [c1]
    spread = max(rates) / min(rates) - 1.0
    value = eff / (sum(ck_each) / (len(ck_each) * c1))
    return value, spread, value <= 1.0 + spread


def run(argv: Optional[List[str]] = None) -> dict:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--max-ranks", type=int, default=max(COUNTS),
                    help="the largest n of the curve")
    ap.add_argument("--worker", choices=("mesh", "control"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--nproc", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker == "mesh":
        return K.emit(mesh_worker(args.rank, args.nproc, args.port,
                                  args.device))
    if args.worker == "control":
        return K.emit(control_worker(args.rank, args.device))

    dev = K.device(args.device)
    cuda = dev.type == "cuda"
    have = torch.cuda.device_count() if cuda else (os.cpu_count() or 1)
    devices = K.cards(range(have)) if cuda else None
    for d in devices or ():
        print(f"# card: {d['name']}, {d['power_limit_w']} W", file=sys.stderr)
    counts = [n for n in COUNTS if n <= min(have, args.max_ranks)]

    results, probe_ms = [], {}
    for n in counts:
        ranks = _launch("mesh", n, dev.type)
        rate = n * min(r["fps"] for r in ranks)  # the slowest rank's pace
        base = results[0][1] if results else rate  # the job at n = 1
        results.append((n, rate, rate / (n * base)))
        probe_ms[n] = max(r["probe_ms"] for r in ranks)
        if cuda:
            print(f"# decode ranks={n}: {rate:.1f} frames/s  efficiency="
                  f"{results[-1][2]:.3f}; probe {probe_ms[n]:.4f} ms a "
                  "step", file=sys.stderr, flush=True)
    k = counts[-1]
    c1 = _launch("control", 1, dev.type)[0]["fps"]
    ck_each = ([r["fps"] for r in _launch("control", k, dev.type)] if k > 1
               else [c1])
    ck = sum(ck_each)
    ceiling = ck / (k * c1)
    n, _, eff = results[-1]
    program, spread, valid = attributable(eff, c1, ck_each)
    if cuda:
        print(f"# control: 1 proc {c1:.1f} fps, {k} procs {ck:.1f} fps -> "
              f"machine ceiling {ceiling:.3f}, spread {spread:.3f}",
              file=sys.stderr, flush=True)
        if not valid:
            print(f"# INVALID: mesh efficiency {eff:.3f} exceeds the machine "
                  f"ceiling {ceiling:.3f} by more than the control's spread: "
                  "the n = 1 baseline was slow", file=sys.stderr, flush=True)
    m = lambda v: K.measured(dev, v)  # noqa: E731
    return K.emit({
        "metric": "sharded_decode_scaling_efficiency",
        "value": m(program),
        "unit": (f"program-attributable fraction at {n} ranks (mesh "
                 f"{eff:.3f} / machine ceiling {ceiling:.3f})" if cuda
                 else "not measured (cpu)"),
        "mesh_efficiency_raw": m(eff),
        "machine_ceiling_independent_procs": m(ceiling),
        "control_spread": m(spread),
        "valid": m(valid),
        "dispatch_overhead_ms": m({str(c): v for c, v in probe_ms.items()}),
        "all_counts": m({str(c): e for c, _, e in results}),
        "frames_per_s": m({str(c): r for c, r, _ in results}),
        "counts": counts,
        "devices": devices,
    })


def main(argv: Optional[List[str]] = None) -> int:
    """0, or 1 where the run is invalid (``valid`` false; a worker
    prints no such field)."""
    return 1 if run(argv).get("valid") is False else 0


if __name__ == "__main__":
    sys.exit(main())
