"""Run a multi-process banded decode job on one host.

Spawns ``--nproc`` worker processes that form one ``torch.distributed``
job: a global (data, seq) mesh over their ranks, every rank decoding its
bands of a frame with the halo exchange between ranks, each rank checking
its rows against a one-process decode
(``compeg_tpu_torch.parallel.multihost.dryrun_multiprocess``). The
counterpart of tools/dryrun_multiproc.py, with processes in place of
virtual devices.

    python -m compeg_tpu_torch.tools.dryrun_multiproc --nproc 2 --device cpu
    python -m compeg_tpu_torch.tools.dryrun_multiproc --nproc 4

``--device cuda`` (the default) runs NCCL with one card a rank and refuses
to start with fewer cards than ranks (NCCL cannot put two ranks on one
card); ``--device cpu`` runs gloo on the CPU. The rendezvous is
``tcp://127.0.0.1:<port>``, a port found free at run time unless ``--port``
names one. Prints ``multiproc dryrun: OK`` and exits 0 iff every worker
passed. ``--bench`` times a data-parallel decode step instead: one process
against ``--nproc``.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from typing import List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def worker(rank: int, nproc: int, port: int, device: str, bench: bool) -> None:
    import torch

    from compeg_tpu_torch.parallel import multihost

    if device == "cpu":
        torch.set_num_threads(1)  # one core a rank, as one card a rank
    address = f"127.0.0.1:{port}"
    if bench:
        fps = multihost.bench_multiprocess(rank, nproc, address, device)
        print(f"worker {rank}: fps={fps:.2f}", flush=True)
        return
    multihost.dryrun_multiprocess(rank, nproc, address, device)
    print(f"worker {rank}: ok", flush=True)


def _launch(nproc: int, port: Optional[int], device: str, bench: bool,
            timeout: float):
    from compeg_tpu_torch.parallel.multihost import free_port

    port = port or free_port()
    cmd = [sys.executable, "-m", "compeg_tpu_torch.tools.dryrun_multiproc",
           "--nproc", str(nproc), "--port", str(port), "--device", device]
    if bench:
        cmd.append("--bench")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = [subprocess.Popen(cmd + ["--worker", str(rank)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, text=True)
             for rank in range(nproc)]
    rc, outs = 0, []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                rc = 1
                break
            outs.append(out)
            sys.stdout.write(out)
            if p.returncode != 0:
                rc = 1
    finally:
        for p in procs:  # a failed rank leaves its peers waiting
            if p.poll() is None:
                p.kill()
                p.wait()
    return rc, outs


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--port", type=int, default=None,
                    help="rendezvous port (default: a free one)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: NCCL, one card a rank; cpu: gloo")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds each worker may take")
    ap.add_argument(
        "--bench", action="store_true",
        help="time a data-parallel decode step: one process against "
        "--nproc processes (process-to-process weak scaling)")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.worker is not None:
        worker(args.worker, args.nproc, args.port, args.device, args.bench)
        return 0
    if args.device == "cuda":
        import torch

        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < args.nproc:
            raise RuntimeError(
                f"--device cuda runs one NCCL rank a card: {args.nproc} "
                f"ranks need {args.nproc} cards, this host has {cards}; "
                "pass --device cpu for gloo on the CPU")

    if args.bench:
        def fps_of(outs):
            vals = [float(m.group(1)) for o in outs
                    for m in [re.search(r"fps=([\d.]+)", o)] if m]
            return min(vals) if vals else 0.0  # slowest rank = job rate

        rc1, o1 = _launch(1, None, args.device, True, args.timeout)
        rcn, on = _launch(args.nproc, args.port, args.device, True,
                          args.timeout)
        if rc1 or rcn:
            print("multiproc bench: FAILED", flush=True)
            return 1
        f1, fn = fps_of(o1), fps_of(on)
        eff = fn / (args.nproc * f1) if f1 else 0.0
        print(f"multiproc bench ({args.device}): 1 proc {f1:.1f} fps, "
              f"{args.nproc} procs {fn:.1f} fps -> process-to-process "
              f"efficiency {eff:.2f}", flush=True)
        return 0

    rc, _ = _launch(args.nproc, args.port, args.device, False, args.timeout)
    print("multiproc dryrun:", "OK" if rc == 0 else "FAILED", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
