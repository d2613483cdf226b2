"""Device trace of the 4K decode: the card's busy total per frame and the
top ops, the counterpart of tools/trace_ops.py (and of its shim
tools/trace_decode.py).

    python -m compeg_tpu_torch.tools.trace_ops [--exact] [--fancy] [--frames N]

Traces ``Decoder(exact_idct=..., fancy_upsampling=...).decode_prepared(pf)``
with ``profiling.trace_device`` (torch.profiler) and prints the device total
(kernels, device-to-device copies and memsets; the JAX tool's XLA Ops lane
sum), the frames/s it implies, the categories it summed, and the top 20
rows with the tail. The pageable upload is a row of its own but, as a host
transfer, not in the total. Ends with one JSON line. ``--device cpu`` (for
the tests) decodes a 64 x 128 frame once on the plain versions and prints
no times.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from . import _common as K

TOP = 20


def run(argv: Optional[List[str]] = None) -> dict:
    from .. import profiling
    from ..pipeline import Decoder

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--exact", action="store_true")
    ap.add_argument("--fancy", action="store_true")
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = K.device(args.device)
    info = K.card(dev)
    dec = Decoder(exact_idct=args.exact, fancy_upsampling=args.fancy,
                  device=dev)
    pf = dec.prepare(K.workload(dev))
    mode = ("exact" if args.exact else "default") + (
        " fancy" if args.fancy else "")
    res = {"mode": mode, "frames": args.frames, "trace_ms": None,
           "fps": None, "trace_event_ms": None, "counted": None, "rows": [],
           "tail_ms": None, "tail_ops": None, "device": info}
    if dev.type != "cuda":
        dec.decode_prepared(pf)
        print(f"# {mode}: device total not measured (cpu)")
        return K.emit(res)
    busy = profiling.trace_device(lambda: dec.decode_prepared(pf),
                                  args.frames)
    total = busy.total_ms
    print(f"# {mode}: device total {total:.4f} ms/frame = {1e3 / total:.0f} "
          f"fps (CUDA-event span {busy.event_ms:.4f} ms/frame) on "
          f"{info['name']}, {info['power_limit_w']} W")
    print(f"# summed categories: {busy.counted}; host transfers are rows, "
          "not in the total")
    shown = 0.0
    for ms, c, name in busy.rows[:TOP]:
        print(f"{ms:8.4f} ms x{c} {name}")
        if not any(d in name for d in profiling.HOST_COPIES):
            shown += ms
    tail = max(0, len(busy.rows) - TOP)
    print(f"# top-{TOP} {shown:.4f} | tail {total - shown:.4f} ms in "
          f"{tail} ops")
    res.update(trace_ms=total, fps=1e3 / total, trace_event_ms=busy.event_ms,
               counted=busy.counted,
               rows=[list(r) for r in busy.rows[:TOP]],
               tail_ms=total - shown, tail_ops=tail)
    return K.emit(res)


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
