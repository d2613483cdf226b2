"""Host preparation micro-benchmark, the counterpart of tools/bench_host.py
(itself the analogue of the reference's divan bench of
``ScanBuffer::process``: bytes/s over the 4K frame's scan).

    python -m compeg_tpu_torch.tools.bench_host             # bench4k.jpg
    python -m compeg_tpu_torch.tools.bench_host --device cpu

Times ``analyze`` (the native parse), ``native.scan_info``,
``native.pack_rows`` (the port's linear rows ``[G*1024, W]``; the JAX
tool's ``pack_blocks tiled`` is TPU layout and has no counterpart), a
steady ``Decoder.prepare`` and the Python parser's ``parse_segments``
(which finds the scan's end with ``native.find_scan_end``), each in ms and
GB/s over the scan bytes, with the counts they run over: segments, words
per segment, rows. The JAX
tool's step over the reference's own bench input (its ``benches/scan.dat``)
is left out: that file is not in the repository. These are host times;
the card (``--device cuda``, the default, where ``prepare`` puts the
stream's constants) is named beside them. Ends with one JSON line.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

from . import _common as K

REPS = 30


def _timeit(fn, reps: int) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def counts(data: bytes) -> dict:
    """What the host path works over for one frame: restart segments, the
    words per segment row (``scan._words_per_segment`` of the longest
    destuffed segment, from ``native.scan_info``), blocks of
    ``SEGMENTS_PER_BLOCK`` segments, rows packed and scan bytes."""
    from .. import native
    from .. import scan as S
    from ..metadata import analyze

    img = analyze(data)
    n = img.total_restart_intervals
    _, mx = native.scan_info(img.scan_data)
    g = -(-n // S.SEGMENTS_PER_BLOCK)
    return {"segments": n, "words_per_segment": S._words_per_segment(mx),
            "blocks": g, "rows": g * S.SEGMENTS_PER_BLOCK,
            "scan_bytes": len(img.scan_data)}


def run(argv: Optional[List[str]] = None) -> dict:
    from .. import native
    from ..metadata import analyze
    from ..parser import parse_segments
    from ..pipeline import Decoder

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = K.device(args.device)
    info = K.card(dev)
    if not native.available():
        raise RuntimeError("the native host library did not build: "
                           "bench_host times the native packer")
    data = K.workload(dev)
    c = counts(data)
    img = analyze(data)
    n, w, g, sz = (c["segments"], c["words_per_segment"], c["blocks"],
                   c["scan_bytes"])
    print(f"# {n} segments of at most {w} words, {c['rows']} rows, {sz} "
          "scan bytes")
    dec = Decoder(device=dev)
    times = {}
    for name, fn in [
        ("analyze (native parse)", lambda: analyze(data)),
        ("scan_info", lambda: native.scan_info(img.scan_data)),
        ("pack_rows (pooled)", lambda: native.pack_rows(
            img.source, n, w, g, offset=img.scan_offset, length=sz)),
        ("prepare (parse+pack, steady state)", lambda: dec.prepare(data)),
        ("parse_segments (Python parser)", lambda: parse_segments(data)),
    ]:
        fn()
        dt = _timeit(fn, REPS)
        times[name] = dt * 1e3
        print(f"{name}: {dt * 1e3:.3f} ms  ({sz / dt / 1e9:.2f} GB/s over "
              f"{sz} scan bytes)")
    print("(reference ScanBuffer::process: ~2 ms for a 496,464-byte scan on "
          f"a desktop CPU, its README.md:5; this scan is {sz} bytes)")
    print("reference benches/scan.dat: not in the repository; skipped")
    return K.emit({**c, "ms": times, "device": info})


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
