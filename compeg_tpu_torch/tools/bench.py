"""The port's headline benchmark: 4K decode frames/s per card, the
counterpart of bench.py (which times the JAX package).

    python -m compeg_tpu_torch.tools.bench                  # on the card
    python -m compeg_tpu_torch.tools.bench --device cpu     # tests only

Workload: ``bench_assets/bench4k.jpg``, 3840 x 2160, 4:2:2, restart
interval 1, 64,800 segments. Prints progress on ``#`` lines to stderr and
ends with ONE JSON line whose fields are bench.py's, minus its TPU target
(``vs_baseline``), plus the card (``device``: name and power limit from
nvidia-smi) and ``trace_event_ms``:

  value            frames/s of the default decode (kernel K2) with the
                   rows resident on the card: ``Decoder.decode_rows`` in
                   rounds of ``--frames`` calls with a rolling window of 6
                   outputs, one synchronize, the round trip subtracted;
                   the median of ``--rounds`` rounds after 10 warm-up calls
                   (bench.py's ``chip_round``)
  exact_fps        the same with ``Decoder(exact_idct=True)`` (K2x) on the
                   same rows
  trace_ms         the card's busy time per frame of those calls
  exact_trace_ms   (``profiling.trace_device_ms``: kernels, device copies
                   and memsets, no host gaps, no transfers); ``trace_fps``
                   and ``exact_trace_fps`` are 1000 over them
  trace_event_ms   CUDA-event spans around the same traced calls, per
                   frame (gaps included): ``trace_ms`` is at most it
  thumbnail_trace_ms, thumbnail_fps
                   K2s at k = 1 (``ops/fused.fused_decode_scaled``) on the
                   resident rows
  e2e_fps          ``BatchDecoder`` at B = 8 fed by host prepares of a
                   16-frame lookahead on 3 threads (``prepare_batch`` into
                   each of three decoders' pinned staging, then
                   ``decode_prepared``), 3 batches a round, median of 3
  host_ms          min of 4 rounds of 5 ``Decoder.prepare``
  host_feed_fps    median of 3 rounds of 40 prepares on 4 threads with
                   ``Decoder(pack_threads=1)``
  link_h2d_MBps    a 2.5 MB pageable upload as ``Decoder.upload`` makes it,
                   the round trip (a synchronize) subtracted

A device trace that fails fails the run. With ``--device cpu`` the frame is
64 x 128 and every field that times the card is null.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from . import _common as K

B = 8  # frames a batch of the end-to-end stream
LOOKAHEAD = 16  # frames of host prepares ahead of the decode
WINDOW = 6  # outputs kept alive while timing the resident decode


class Progress:
    """``# [  12.3s] stage done`` lines on stderr, as bench.py prints."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def __call__(self, stage: str) -> None:
        print(f"# [{time.perf_counter() - self.t0:7.1f}s] {stage} done",
              file=sys.stderr, flush=True)


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def run(argv: Optional[List[str]] = None) -> dict:
    import torch

    from .. import profiling
    from ..batch import BatchDecoder
    from ..ops import fused as F
    from ..ops import idct as D
    from ..pipeline import Decoder

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--frames", type=int, default=150,
                    help="calls a timed round of the resident decode")
    ap.add_argument("--rounds", type=int, default=5,
                    help="timed rounds (the median is printed)")
    args = ap.parse_args(argv)
    dev = K.device(args.device)
    cuda = dev.type == "cuda"
    info = K.card(dev)
    prog = Progress()
    data = K.workload(dev)

    def sync():
        K.sync(dev)

    # Link round trip (a synchronize of an idle card) and the pageable
    # upload's bandwidth.
    sync()
    t_rtt = min(_timed(sync) for _ in range(5))
    blob = np.random.default_rng(K.SEED).integers(0, 255, 2_500_000,
                                                  dtype=np.uint8)

    def put():
        torch.from_numpy(blob).to(dev)
        sync()

    put()
    t_put = min(_timed(put) for _ in range(3))
    link_mbps = blob.nbytes / max(t_put - t_rtt, 1e-9) / 1e6
    prog("link")

    dec = Decoder(device=dev)
    pf = dec.prepare(data)
    dec.decode_prepared(pf)
    sync()
    prog("first decode")

    # Host preparation: one prepare on the machine pool (min of short
    # rounds: time-shared cores read 2x apart minutes apart), and four
    # single-thread prepares at once (the stream's configuration).
    def host_round(n=5):
        t0 = time.perf_counter()
        for _ in range(n):
            dec.prepare(data)
        return (time.perf_counter() - t0) / n

    t_host = min(host_round() for _ in range(4))
    dec_feed = Decoder(pack_threads=1, device=dev)
    dec_feed.prepare(data)

    def feed_round(n=40, threads=4):
        with ThreadPoolExecutor(threads) as ex:
            t0 = time.perf_counter()
            list(ex.map(lambda _: dec_feed.prepare(data), range(n)))
            return n / (time.perf_counter() - t0)

    host_feed_fps = statistics.median(feed_round() for _ in range(3))
    prog("host feed")

    # The resident decode: rows on the card, calls enqueued back to back.
    rows = dec.upload(pf)
    sync()

    def chip_round(fn, n):
        window: deque = deque(maxlen=WINDOW)
        t0 = time.perf_counter()
        for _ in range(n):
            window.append(fn())
        sync()
        return (time.perf_counter() - t0 - t_rtt) / n

    def chip_rate(fn):
        chip_round(fn, min(10, args.frames))
        return statistics.median(chip_round(fn, args.frames)
                                 for _ in range(args.rounds))

    def default():
        return dec.decode_rows(pf, rows)

    t_chip = chip_rate(default)
    prog("chip rate")
    dec_x = Decoder(exact_idct=True, device=dev)
    pfx = dec_x.prepare(data)  # the same rows; its own integer quantizers

    def exact():
        return dec_x.decode_rows(pfx, rows)

    t_exact = chip_rate(exact)
    prog("exact chip rate")

    lq1 = D.scaled_operators(D.qz_by_slot_array(pf.image), 1, dec.retained,
                             dev)

    def thumb():
        return F.fused_decode_scaled(rows, pf.nseg, pf.tables, lq1, pf.geom,
                                     1)

    trace = exact_trace = thumb_trace = None
    if cuda:
        trace = profiling.trace_device(default, 5)
        exact_trace = profiling.trace_device(exact, 5)
        thumb_trace = profiling.trace_device(thumb, 5)
        print(f"# traced categories (default): {trace.counted}",
              file=sys.stderr, flush=True)
    else:
        thumb()
    prog("device traces")

    # End to end: host prepares of the next LOOKAHEAD frames on 3 threads,
    # each batch packed into the pinned staging of one of three decoders
    # (a decoder's buffer is packed again only after its upload).
    bdecs = [BatchDecoder(device=dev) for _ in range(3)]
    for bd in bdecs:
        bd.decode_prepared(bd.prepare_batch([data] * B))
    sync()
    prog("batch warm-up")

    def e2e_round(n_batches=3):
        ahead = LOOKAHEAD // B
        with ThreadPoolExecutor(3) as ex:
            t0 = time.perf_counter()

            def submit(i):
                bd = bdecs[i % len(bdecs)]
                return bd, ex.submit(bd.prepare_batch, [data] * B)

            futs = deque(submit(i) for i in range(min(ahead, n_batches)))
            done: deque = deque()  # each batch's event, two in flight
            for i in range(n_batches):
                bd, fut = futs.popleft()
                bd.decode_prepared(fut.result())
                if cuda:
                    done.append(torch.cuda.Event())
                    done[-1].record()
                if i + ahead < n_batches:
                    futs.append(submit(i + ahead))
                if len(done) > 2:
                    done.popleft().synchronize()
            sync()
            return (time.perf_counter() - t0) / (n_batches * B)

    t_e2e = statistics.median(e2e_round() for _ in range(min(3, args.rounds)))
    prog("e2e")

    def ms(t):
        return None if t is None else t.total_ms

    trace_ms, exact_trace_ms, thumb_ms = ms(trace), ms(exact_trace), ms(
        thumb_trace)
    m = lambda v: K.measured(dev, v)  # noqa: E731
    if cuda:
        print(f"# rtt {t_rtt * 1e3:.3f} ms | h2d {link_mbps:.0f} MB/s | "
              f"host {t_host * 1e3:.3f} ms | chip {t_chip * 1e3:.4f} ms | "
              f"exact {t_exact * 1e3:.4f} ms | trace {trace_ms:.4f} ms | "
              f"e2e {t_e2e * 1e3:.3f} ms | {info['name']}, "
              f"{info['power_limit_w']} W", file=sys.stderr, flush=True)
    return K.emit({
        "metric": "4k_jpeg_decode_frames_per_second_per_card",
        "value": m(1.0 / t_chip),
        "unit": "frames/s",
        "exact_fps": m(1.0 / t_exact),
        "trace_ms": trace_ms,
        "exact_trace_ms": exact_trace_ms,
        "trace_fps": None if trace_ms is None else 1e3 / trace_ms,
        "exact_trace_fps": (None if exact_trace_ms is None
                            else 1e3 / exact_trace_ms),
        "trace_event_ms": None if trace is None else trace.event_ms,
        "e2e_fps": m(1.0 / t_e2e),
        "host_ms": t_host * 1e3,
        "host_feed_fps": host_feed_fps,
        "thumbnail_trace_ms": thumb_ms,
        "thumbnail_fps": None if thumb_ms is None else 1e3 / thumb_ms,
        "link_h2d_MBps": m(link_mbps),
        "device": info,
    })


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
