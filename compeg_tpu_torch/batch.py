"""Batched multi-frame decode and streaming: the port of
:mod:`compeg_tpu.batch`.

:class:`BatchDecoder` decodes B frames of one geometry with ONE upload and
ONE kernel launch. The JAX package concatenates the frames' blocks along its
kernel's grid (compeg_tpu/batch.py:71-114); here the frames' rows lie in one
``[B, R, W]`` tensor, packed straight into a pinned staging buffer, and the
frame is the second dimension of the fused kernels' grid
(``ops/fused.py``), so the output is ``[B, H, W]`` packed RGBA. The stream
constants (tables, operators, quantizers) are the first frame's, uploaded
once per stream by the header cache.

:class:`StreamDecoder` overlaps the host preparation of later frames with
the upload and decode of earlier ones. JAX dispatch is asynchronous, so the
JAX class needs nothing else; a PyTorch copy from pageable memory is not, so
here worker threads pack the rows into pinned staging buffers, the upload
runs ``non_blocking`` on a copy stream, and the kernel runs on the caller's
current stream after waiting on the upload's event. A staging buffer returns
to the ring with that event and is written again only after it has passed;
the ring holds one buffer more than can be in preparation at once, and at
least ``depth + 1``. ``decode_iter_rgb`` reads back through pinned buffers
on a third stream, a few frames behind the decode, and worker threads move
each frame from its pinned buffer into the array the caller gets.

``BatchDecoder(fused=False)`` is the staged tier
(:func:`compeg_tpu_torch.pipeline.decode_frame_device`): still one upload,
then the batch's frames one by one, a K1 launch and the torch stages each,
to ``[B, H, W, 3]`` u8.

On a CPU device (the tests) the same code runs without streams, events or
pinned memory, on the kernels' plain versions.
"""

from __future__ import annotations

import os
import queue
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .errors import CompegError, bail
from .pipeline import Decoder, PreparedFrame, row_capacity, to_rgb_tensor
from .profiling import stage_timer


class _Staging:
    """One host buffer for packed rows, pinned when the decoder's device is
    a CUDA card, with the event of the upload that last read it."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.tensor: Optional[torch.Tensor] = None  # int32
        self.event = None

    def wait(self) -> None:
        """Block until the last upload from this buffer has completed."""
        if self.event is not None:
            with stage_timer("ring_wait"):
                self.event.synchronize()
            self.event = None

    def array(self, *shape: int) -> np.ndarray:
        """The buffer as a uint32 array of ``shape``, free to be written."""
        self.wait()
        if self.tensor is None or tuple(self.tensor.shape) != shape:
            self.tensor = torch.empty(shape, dtype=torch.int32,
                                      pin_memory=self.cuda)
        return self.tensor.numpy().view(np.uint32)

    def upload(self, device, nrows: Optional[int] = None,
               lo: int = 0) -> torch.Tensor:
        """Copy the buffer's ``nrows`` rows from row ``lo`` (all of them by
        default; of every frame, for a batch ``[B, R, W]``) to ``device`` on
        the current stream, asynchronously from pinned memory, and remember
        the copy's event. Part of every frame of a batch is not contiguous:
        it travels as one copy a frame."""
        with stage_timer("upload"):
            hi = None if nrows is None else lo + nrows
            src = self.tensor[..., lo:hi, :]
            if src.is_contiguous():
                out = src.to(device, non_blocking=self.cuda)
            else:
                out = torch.empty(src.shape, dtype=src.dtype, device=device)
                for o, part in zip(out, src):
                    o.copy_(part, non_blocking=self.cuda)
            if self.cuda:
                self.event = torch.cuda.Event()
                self.event.record()
            return out


class _Readback:
    """Frames on the device (packed RGBA, or the staged tier's ``[H, W,
    3]`` u8) -> ``[H, W, 3]`` u8 arrays on the host. On a CUDA device the
    RGB bytes travel through pinned buffers on a stream of their own, and a
    few worker threads wait for each copy and
    move the frame out of its pinned buffer into the caller's array (numpy
    releases the GIL for the copy, and a fresh array's page faults spread
    over the threads), so a caller can have ``threads`` frames on their way
    while the next one decodes."""

    def __init__(self, device: torch.device, threads: int = 4):
        self.cuda = device.type == "cuda"
        self.threads = threads if self.cuda else 0
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._pool = (ThreadPoolExecutor(threads, "compeg-readback")
                      if self.cuda else None)
        self._free: List[torch.Tensor] = []  # pinned buffers not in use

    def fetch(self, rgba: torch.Tensor,
              out: Optional[np.ndarray] = None) -> Future:
        """Start the readback of one frame; the future gives its host array
        (``out`` when given, else an array of its own)."""
        fut: Future
        if not self.cuda:
            fut = Future()
            fut.set_result(self._copy_out(to_rgb_tensor(rgba).numpy(), out))
            return fut
        ready = torch.cuda.Event()
        ready.record()  # the decode, on the caller's stream
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(ready)
            rgba.record_stream(self.stream)
            rgb = to_rgb_tensor(rgba)
            buf = self._free.pop() if self._free else None
            if buf is None or buf.shape != rgb.shape:
                buf = torch.empty(rgb.shape, dtype=torch.uint8,
                                  pin_memory=True)
            buf.copy_(rgb, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return self._pool.submit(self._finish, buf, done, out)

    def _finish(self, buf: torch.Tensor, done, out) -> np.ndarray:
        done.synchronize()
        res = self._copy_out(buf.numpy(), out)
        self._free.append(buf)
        return res

    @staticmethod
    def _copy_out(rgb: np.ndarray, out: Optional[np.ndarray]) -> np.ndarray:
        if out is None:
            return np.array(rgb)
        out[...] = rgb
        return out


def _same_stream(a: PreparedFrame, b: PreparedFrame) -> bool:
    """Two frames share geometry and tables (Huffman and quantization)."""
    if a.consts is not None and a.consts is b.consts:
        return True  # byte-identical headers
    ia, ib = a.image, b.image
    return (a.geom == b.geom and ia.htables == ib.htables
            and ia.qtables.keys() == ib.qtables.keys()
            and all(np.array_equal(ia.qtables[k], ib.qtables[k])
                    for k in ia.qtables)
            and [(c.qtable, c.dc_table, c.ac_table) for c in ia.components]
            == [(c.qtable, c.dc_table, c.ac_table) for c in ib.components])


class BatchDecoder:
    """Decode batches of same-geometry frames with one upload and one kernel
    launch per batch.

    The knobs are the JAX class's, plus ``device``: ``exact_idct`` takes
    kernel K2x, ``fancy_upsampling`` kernel K3 and one launch of the planes
    epilogue E (``ops/color.finalize_planes``, whose vertical filter never
    reaches a neighbouring frame), the default K2.
    ``fused=False`` takes the staged tier, frame by frame (K1 and torch ops,
    ``[B, H, W, 3]`` u8 on the device), with ``exact_idct`` and
    ``fancy_upsampling`` as the single-frame Decoder applies them. The JAX
    package falls back to its staged tier for fancy upsampling on a geometry
    it cannot tile (compeg_tpu/batch.py:284-290); the port has no tiling and
    fancy always takes K3 when fused, so there is no such fall-back here.
    """

    def __init__(
        self,
        retained_coefficients: int = 64,
        fused: bool = True,
        exact_idct: bool = False,
        fancy_upsampling: bool = False,
        device="cuda",
        max_device_bytes: int = 8 << 30,
    ):
        self._dec = Decoder(
            retained_coefficients, max_device_bytes=max_device_bytes,
            device=device, exact_idct=exact_idct,
            fancy_upsampling=fancy_upsampling, fused=fused,
        )
        self.device = self._dec.device
        self.retained = retained_coefficients
        self.fused = fused
        self.exact_idct = exact_idct
        self.fancy = fancy_upsampling
        cuda = self.device.type == "cuda"
        self._staging = _Staging(cuda)
        self._prepared: List[PreparedFrame] = []  # the staging buffer's frames
        self._readback = _Readback(self.device)

    def prepare_batch(self, frames: Sequence[bytes],
                      rows_per_frame: Optional[int] = None
                      ) -> List[PreparedFrame]:
        """Parse every frame and pack its rows into one staging buffer
        ``[B, R, W]`` at the batch's common row width; the frames must share
        geometry and tables. The buffer is this decoder's: a batch is decoded
        before the next one is prepared. ``rows_per_frame`` makes ``R`` hold
        at least that many rows, zero past the frame's segments: the banded
        decode's whole bands (``parallel/sharding.py``), which checks the
        device budget of each rank's bands itself."""
        dec = self._dec
        if not frames:
            bail("empty batch")
        imgs = [dec._analyze(f) for f in frames]
        img0 = imgs[0][0]
        if rows_per_frame is None:
            dec.check_budget(img0, len(imgs))
        nseg = img0.total_restart_intervals
        pfs = [dec.frame_constants(img, consts) for img, consts in imgs]
        for pf in pfs[1:]:
            if pf.nseg != nseg or not _same_stream(pfs[0], pf):
                bail("batched frames must share geometry and tables")
        # One width for the whole batch: the stream's steady width, measured
        # again over every frame when a segment does not fit.
        width = dec._cached_width or dec.measure_width(img0)
        for attempt in (0, 1):
            rows = self._staging.array(
                len(pfs), row_capacity(max(nseg, rows_per_frame or 0)), width)
            try:
                packers = [dec.pack_into(pf.image, rows[i])
                           for i, pf in enumerate(pfs)]
                break
            except CompegError:
                if attempt:
                    raise
                width = max(dec.measure_width(pf.image) for pf in pfs)
        dec._cached_width = width
        for i, (pf, packer) in enumerate(zip(pfs, packers)):
            pf.rows, pf.packer = rows[i], packer
        self._prepared = pfs
        return pfs

    def decode_prepared(self, pfs: Sequence[PreparedFrame]) -> torch.Tensor:
        """One upload, one launch: packed RGBA ``[B, H, W]`` int32 on the
        device (asynchronous on a CUDA device); the staged tier: one upload,
        a K1 launch per frame, ``[B, H, W, 3]`` u8. ``pfs`` is what
        :meth:`prepare_batch` returned last: its rows lie in this decoder's
        staging buffer."""
        if len(pfs) != len(self._prepared) or not all(
                a is b for a, b in zip(pfs, self._prepared)):
            raise ValueError("decode_prepared takes the frames of this "
                             "decoder's last prepare_batch, in order")
        return self._dec.decode_rows(pfs[0], self.upload())

    def upload(self, nrows: Optional[int] = None,
               lo: int = 0) -> torch.Tensor:
        """``nrows`` rows from row ``lo`` of every frame of the last
        prepared batch (all of them by default), ``[B, nrows, W]`` int32 on
        the device, uploaded from the staging buffer (asynchronously on a
        CUDA device)."""
        return self._staging.upload(self.device, nrows, lo)

    def to_rgb(self, out: torch.Tensor) -> np.ndarray:
        """Device batch output -> ``[B, H, W, 3]`` u8 (synchronizes). A few
        frames cross to the host while earlier ones are copied out of their
        pinned buffers."""
        res = np.empty((*out.shape[:3], 3), dtype=np.uint8)
        pending: deque = deque()
        for i in range(out.shape[0]):
            pending.append(self._readback.fetch(out[i], res[i]))
            if len(pending) > self._readback.threads:
                pending.popleft().result()
        for fut in pending:
            fut.result()
        return res

    def decode(self, frames: Sequence[bytes]) -> np.ndarray:
        """[B frames] -> [B, H, W, 3] u8."""
        with stage_timer("batch_prepare"):
            pfs = self.prepare_batch(frames)
        with stage_timer("batch_launch"):  # asynchronous on a CUDA device
            out = self.decode_prepared(pfs)
        with stage_timer("batch_readback"):  # waits for the kernel too
            return self.to_rgb(out)


class StreamDecoder:
    """Pipelined streaming decode: host preprocessing runs on worker threads
    (the native pack releases the GIL) while the device uploads and decodes
    earlier frames, with ``depth`` frames in flight on the device."""

    def __init__(
        self,
        retained_coefficients: int = 64,
        depth: int = 2,
        prepare_threads: Optional[int] = None,
        device="cuda",
    ):
        if prepare_threads is None:
            prepare_threads = os.cpu_count() or 2
        if depth < 1:
            raise ValueError("depth must be at least 1")
        # With several prepares in flight, per-call single-threaded packs
        # keep the workers from contending for one shared pool (as in the
        # JAX class).
        self._dec = Decoder(
            retained_coefficients,
            pack_threads=1 if prepare_threads > 1 else None,
            device=device,
        )
        self.device = self._dec.device
        self.depth = depth
        self.prepare_threads = prepare_threads
        cuda = self.device.type == "cuda"
        self._h2d = torch.cuda.Stream(self.device) if cuda else None
        # Frames in preparation hold one staging buffer each, at most
        # prepare_threads + 1 of them; one more keeps a worker from waiting
        # on the upload that has just begun.
        self._ring: "queue.SimpleQueue[_Staging]" = queue.SimpleQueue()
        for _ in range(max(max(prepare_threads, 1) + 1, depth) + 1):
            self._ring.put(_Staging(cuda))
        self._readback = _Readback(self.device)

    def _prepare(self, data) -> Tuple[PreparedFrame, _Staging]:
        """Prepare one frame into a staging buffer of the ring (blocks until
        one is free and its last upload has completed)."""
        with stage_timer("ring_wait"):
            staging = self._ring.get()
        try:
            return self._dec.prepare(data, alloc=staging.array), staging
        except BaseException:
            self._ring.put(staging)
            raise

    def _launch(self, pf: PreparedFrame, staging: _Staging) -> torch.Tensor:
        """Upload on the copy stream, decode on the current stream behind
        the upload's event, and hand the staging buffer back to the ring."""
        try:
            if self._h2d is None:
                return self._dec.decode_rows(pf, staging.upload(self.device,
                                                                pf.nseg))
            with torch.cuda.stream(self._h2d):
                rows = staging.upload(self.device, pf.nseg)
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(staging.event)
            # Allocated on the copy stream, read by the kernel on this one.
            rows.record_stream(cur)
            return self._dec.decode_rows(pf, rows)
        finally:
            self._ring.put(staging)

    def decode_iter(self, frames: Iterable[bytes]) -> Iterator[torch.Tensor]:
        """Yields device tensors in order (packed RGBA ``[H, W]`` int32),
        ``depth`` frames in flight. Convert with :meth:`to_rgb`."""
        it = iter(frames)
        inflight: deque = deque()
        if self.prepare_threads <= 1:
            for data in it:
                inflight.append(self._launch(*self._prepare(data)))
                if len(inflight) >= self.depth:
                    yield inflight.popleft()
            yield from inflight
            return

        pending: deque = deque()
        with ThreadPoolExecutor(self.prepare_threads) as ex:
            try:
                for _ in range(self.prepare_threads + 1):
                    data = next(it, None)
                    if data is None:
                        break
                    pending.append(ex.submit(self._prepare, data))
                while pending:
                    with stage_timer("stream_wait_prepare"):
                        pf, staging = pending.popleft().result()
                    data = next(it, None)
                    if data is not None:
                        pending.append(ex.submit(self._prepare, data))
                    inflight.append(self._launch(pf, staging))
                    if len(inflight) >= self.depth:
                        yield inflight.popleft()
                yield from inflight
            finally:
                # Abandoned or failed: give the prepared frames' buffers
                # back, so that the ring is whole for the next call.
                for fut in pending:
                    if not fut.cancel() and fut.exception() is None:
                        self._ring.put(fut.result()[1])

    def to_rgb(self, out: torch.Tensor) -> np.ndarray:
        """Device output -> [H, W, 3] u8 numpy (synchronizes)."""
        return self._readback.fetch(out).result()

    def decode_iter_rgb(self, frames: Iterable[bytes]) -> Iterator[np.ndarray]:
        """Yields ``[H, W, 3]`` u8 arrays in order; the readbacks of a few
        frames run while the next frames decode."""
        pending: deque = deque()
        for out in self.decode_iter(frames):
            pending.append(self._readback.fetch(out))
            if len(pending) > self._readback.threads:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
