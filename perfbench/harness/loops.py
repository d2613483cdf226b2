"""The traffic loops: one general driver a kind of traffic, each fed by the
parameters of a traffic file (``perfbench/traffic/<mix>.json``, whose
``loop`` names the driver).

* ``stream``: a closed loop of a recorded MJPEG (a pool of distinct frames
  held in host memory, cycled) through ``StreamDecoder.decode_iter``;
  outputs stay on the card and are dropped after ``depth``.
* ``oneshot``: a closed loop of a pool of distinct frames held in host
  memory, cycled, each through the one-shot ``Decoder.decode`` to host RGB
  on one thread.
* ``resident``: a closed loop over a pool of prepared frames resident on
  the card as one ``[P, segments, words]`` int32 tensor, decoded in batches
  of ``batch`` consecutive frames by ``Decoder.decode_rows``, at most two
  batches in flight.

Each driver makes its decoders and warms up the shapes of its traffic in
``setup``, runs a window with ``run(seconds, tracer)`` (callable again, for
a trace that has to be taken anew), keeps a seeded sample of what the
window delivered (``sample``: ``(pool index, host RGB)`` pairs, read back
only once the window has closed) and reports its end-to-end numbers in
``result``.
"""

from __future__ import annotations

import random
import time
from collections import deque
from typing import Optional

import numpy as np

from ..inputs import frames as F

STAGE_BYTES = 2 * 10**9  # host memory a resident loop stages at most at once


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from a seed."""

    def __init__(self, k: int, seed: int, stream: int):
        self.k = k
        self.items: list = []
        self.seen = 0
        self._rng = random.Random(int(F.rng(seed, stream).integers(2**62)))

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self._rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def rgba_to_rgb_host(t) -> np.ndarray:
    """Packed RGBA int32 ``[H, W]`` (any device) -> ``[H, W, 3]`` u8."""
    a = t.cpu().contiguous().numpy()
    return a.view(np.uint8).reshape(a.shape + (4,))[..., :3]


class Loop:
    """What every driver shares."""

    def __init__(self, cfg: dict, traffic: dict, device, seed: int):
        self.cfg, self.t, self.device, self.seed = cfg, traffic, device, seed
        self.src = F.source(cfg)
        self.result: dict = {}

    def frame(self, j: int) -> bytes:
        return self.src.frame(self.seed, j)

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)


class StreamLoop(Loop):
    def setup(self) -> None:
        from compeg_tpu_torch import StreamDecoder

        t = self.t
        self.frames = [self.frame(j) for j in range(t["pool_frames"])]
        self.sd = StreamDecoder(depth=t["depth"],
                                prepare_threads=t["prepare_threads"],
                                device=self.device)
        self._stop = False
        self._it = self.sd.decode_iter(self._feed())
        self.yielded = 0
        self.sampler = Reservoir(t["check_frames"], self.seed, 2)
        for _ in range(t["warm_frames"]):
            next(self._it)
            self.yielded += 1
        self.sync()

    def _feed(self):
        i = 0
        while not self._stop:
            yield self.frames[i % len(self.frames)]
            i += 1

    def run(self, seconds: float, tracer=None) -> None:
        clock = time.perf_counter
        n = 0
        t0 = clock()
        while True:
            out = next(self._it)
            self.sampler.offer((self.yielded % len(self.frames), out))
            self.yielded += 1
            n += 1
            now = clock() - t0
            if tracer is not None:
                tracer.tick(now, n)
            if now >= seconds and (tracer is None or tracer.ended):
                break
        self.sync()
        wall = clock() - t0
        if tracer is not None:
            tracer.close(n)
        self.result.setdefault("fps", n / wall)
        self.result.setdefault("attempted", n)
        self.result.setdefault("failed", 0)

    def finish(self) -> None:
        self._stop = True
        self._it.close()
        self.sample = [(j, rgba_to_rgb_host(out))
                       for j, out in self.sampler.items]
        del self.sampler, self._it, self.sd


class OneShotLoop(Loop):
    def setup(self) -> None:
        from compeg_tpu_torch import Decoder

        t = self.t
        self.frames = [self.frame(j) for j in range(t["pool_frames"])]
        self.dec = Decoder(device=self.device, **self.cfg["decoder"])
        for data in self.frames[:t["warm_frames"]]:
            self.dec.decode(data)
        self.sampler = Reservoir(t["check_frames"], self.seed, 2)
        self.served = 0

    def run(self, seconds: float, tracer=None) -> None:
        clock = time.perf_counter
        n = 0
        t0 = clock()
        while True:
            j = self.served % len(self.frames)
            self.sampler.offer((j, self.dec.decode(self.frames[j])))
            self.served += 1
            n += 1
            now = clock() - t0
            if tracer is not None:
                tracer.tick(now, n)
            if now >= seconds and (tracer is None or tracer.ended):
                break
        wall = clock() - t0
        if tracer is not None:
            tracer.close(n)
        self.result.setdefault("fps", n / wall)
        self.result.setdefault("attempted", n)
        self.result.setdefault("failed", 0)

    def finish(self) -> None:
        self.sample = list(self.sampler.items)
        del self.sampler, self.dec


class ResidentLoop(Loop):
    def setup(self) -> None:
        import torch
        from compeg_tpu_torch import Decoder

        t = self.t
        P, B = t["pool_frames"], t["batch"]
        if P % B:
            raise ValueError(f"pool of {P} frames in batches of {B}")
        self.dec = Decoder(device=self.device, **self.cfg["decoder"])
        if isinstance(self.src, F.RunsOfEight):
            # The widest row any frame can need: these frames are drawn from
            # the base images' runs of segments.
            words = max(Decoder(device=self.device).prepare(b).rows.shape[1]
                        for b in F.base_jpegs(self.cfg))
            chunk = 32
        else:
            # The widest row of the pool's own frames, by the program's
            # measure of the frame whose longest segment is longest; as many
            # frames a chunk as STAGE_BYTES holds at the program's row
            # capacity.
            j = max(range(P), key=lambda j: self.src.row_bytes(self.seed, j))
            widest = self.dec.prepare(self.frame(j)).rows
            words = widest.shape[1]
            chunk = max(1, min(32, STAGE_BYTES // widest.nbytes))
            del widest
        nseg = self.src.segments
        host: Optional[np.ndarray] = None
        self.rows = torch.empty((P, nseg, words), dtype=torch.int32,
                                device=self.device)
        self.pf = None
        for lo in range(0, P, chunk):
            n = min(chunk, P - lo)
            for k in range(n):
                def alloc(r, w, k=k):
                    nonlocal host
                    if w > words:
                        raise ValueError(f"a frame needs {w} words a row, "
                                         f"more than the {words} staged")
                    if host is None:
                        host = np.zeros((chunk, r, words), np.uint32)
                    return host[k]

                pf = self.dec.prepare(self.frame(lo + k), alloc=alloc)
                self.pf = self.pf or pf
            self.rows[lo:lo + n].copy_(torch.from_numpy(
                host[:n, :nseg].view(np.int32)))
        self.keep: deque = deque(maxlen=2)
        self.inflight: deque = deque()
        self.cursor = 0
        self.sampler = Reservoir(t["check_batches"], self.seed, 2)
        for _ in range(t["warm_batches"]):
            self._launch(False)
        self.sync()
        self.inflight.clear()

    def _launch(self, offer: bool) -> None:
        import torch

        B = self.t["batch"]
        i = self.cursor
        out = self.dec.decode_rows(self.pf, self.rows[i:i + B])
        self.keep.append(out)
        if offer:
            self.sampler.offer((i, out))
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self.inflight.append(ev)
            if len(self.inflight) > 2:
                self.inflight.popleft().synchronize()
        self.cursor = (i + B) % self.t["pool_frames"]

    def run(self, seconds: float, tracer=None) -> None:
        clock = time.perf_counter
        B = self.t["batch"]
        n = 0
        t0 = clock()
        while True:
            self._launch(True)
            n += B
            now = clock() - t0
            if tracer is not None:
                tracer.tick(now, n)
            if now >= seconds and (tracer is None or tracer.ended):
                break
        self.sync()
        wall = clock() - t0
        self.inflight.clear()
        if tracer is not None:
            tracer.close(n)
        self.result.setdefault("fps", n / wall)
        self.result.setdefault("attempted", n)
        self.result.setdefault("failed", 0)

    def finish(self) -> None:
        """Each sampled batch's frames at one seeded position in each
        quarter of the batch, read back."""
        B = self.t["batch"]
        r = F.rng(self.seed, 4)
        q = 4 if B >= 4 else B
        self.sample = []
        for i, out in self.sampler.items:
            for s in range(q):
                lo, hi = s * B // q, (s + 1) * B // q
                k = int(r.integers(lo, hi))
                self.sample.append((i + k, rgba_to_rgb_host(out[k])))
        del self.sampler, self.keep, self.rows, self.dec


LOOPS = {"stream": StreamLoop, "oneshot": OneShotLoop,
         "resident": ResidentLoop}
