"""A V4L2 MJPG camera in user space, for driving ``compeg_tpu_torch.v4l2``
where there is no camera (the smoke run on the card, the tests).

:class:`FakeCamera` answers the ioctl sequence ``v4l2.Camera`` issues
(QUERYCAP, S_FMT, REQBUFS, QUERYBUF, QBUF, STREAMON, DQBUF, STREAMOFF) and
hands out a fixed list of payloads through a ring of fake mmap buffers, each
with the buffer flags its entry names, so a stream can carry
error-flagged and non-JPEG frames among good ones. ``installed()`` swaps it
in for the ``os``, ``fcntl`` and ``mmap`` names of the v4l2 module only, and
puts them back on exit.
"""

from __future__ import annotations

import contextlib
import types
from typing import Iterator, List, Sequence, Tuple

from .. import v4l2


class FakeCamera:
    """Serves ``frames``, a list of ``(payload, flags)``, in order, then
    raises ``OSError`` (a camera unplugged mid-stream)."""

    FD = 42

    def __init__(self, frames: Sequence[Tuple[bytes, int]],
                 size: Tuple[int, int] = (3840, 2160), n_buffers: int = 4):
        self.frames = list(frames)
        self.size = size
        self.buf_len = max(len(f) for f, _ in self.frames)
        self.maps = [bytearray(self.buf_len) for _ in range(n_buffers)]
        self.queued: List[int] = []
        self.streaming = False
        self.served = 0

    def ioctl(self, fd, req, arg=0, mutate=True):
        if fd != self.FD:
            raise OSError(f"fake camera: unknown fd {fd}")
        if req == v4l2.VIDIOC_QUERYCAP:
            arg.capabilities = v4l2.CAP_VIDEO_CAPTURE | v4l2.CAP_STREAMING
            arg.device_caps = arg.capabilities
            card = b"fake-mjpg-cam"
            arg.card[: len(card)] = card
        elif req == v4l2.VIDIOC_S_FMT:
            if arg.fmt.pix.pixelformat != v4l2.PIX_FMT_MJPEG:
                raise OSError("fake camera: only MJPG")
            arg.fmt.pix.width, arg.fmt.pix.height = self.size
        elif req == v4l2.VIDIOC_REQBUFS:
            arg.count = min(arg.count, len(self.maps))
        elif req == v4l2.VIDIOC_QUERYBUF:
            arg.length = self.buf_len
            arg.m.offset = arg.index * 4096
        elif req == v4l2.VIDIOC_QBUF:
            self.queued.append(arg.index)
        elif req == v4l2.VIDIOC_DQBUF:
            if not (self.streaming and self.queued):
                raise OSError("fake camera: DQBUF with nothing queued")
            if self.served >= len(self.frames):
                raise OSError("fake camera: no more frames")
            i = self.queued.pop(0)
            data, flags = self.frames[self.served]
            self.served += 1
            self.maps[i][: len(data)] = data
            arg.index, arg.bytesused, arg.flags = i, len(data), flags
        elif req == v4l2.VIDIOC_STREAMON:
            self.streaming = True
        elif req == v4l2.VIDIOC_STREAMOFF:
            self.streaming = False
        else:
            raise OSError(f"fake camera: unexpected ioctl {req:#x}")
        return 0

    def _mmap(self, fd, length, flags, prot, offset=0):
        buf = self.maps[offset // 4096]

        class _Map:
            def __getitem__(self, s):
                return bytes(memoryview(buf)[s])

            def close(self):
                pass

        return _Map()

    @contextlib.contextmanager
    def installed(self) -> Iterator["FakeCamera"]:
        """This camera behind ``v4l2``'s ``os.open``, ``fcntl.ioctl`` and
        ``mmap.mmap`` for the duration of the block."""
        saved = v4l2.os, v4l2.fcntl, v4l2.mmap
        v4l2.os = types.SimpleNamespace(
            open=lambda path, flags: self.FD, close=lambda fd: None,
            O_RDWR=saved[0].O_RDWR)
        v4l2.fcntl = types.SimpleNamespace(ioctl=self.ioctl)
        v4l2.mmap = types.SimpleNamespace(mmap=self._mmap, MAP_SHARED=1,
                                          PROT_READ=1)
        try:
            yield self
        finally:
            v4l2.os, v4l2.fcntl, v4l2.mmap = saved
