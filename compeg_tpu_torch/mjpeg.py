"""MJPEG stream utilities (the port's copy of compeg_tpu/mjpeg.py).

The reference's flagship integration is decoding an MJPG webcam stream
(examples/viewer.rs + linuxvideo). This module provides the stream plumbing
for the same use case without V4L2 bindings: splitting a raw MJPEG
byte stream (concatenated JPEG frames, the format V4L2 MJPG delivers and
.mjpeg files store) into frames suitable for :class:`compeg_tpu_torch.batch.StreamDecoder`.
"""

from __future__ import annotations

from typing import Iterable, Iterator

SOI = b"\xFF\xD8"
EOI = b"\xFF\xD9"


class FrameAssembler:
    """Incremental MJPEG frame splitter: ``feed(chunk)`` yields every frame
    completed by the chunk; partial frames (and a trailing lone ``0xFF``
    that may be the first byte of the next frame's SOI split across chunks)
    are buffered for the next feed. One implementation shared by the file,
    pipe, and tail readers, so marker-boundary handling lives in one place.
    """

    def __init__(self) -> None:
        self.buf = b""

    def feed(self, chunk: bytes) -> Iterator[bytes]:
        self.buf += chunk
        pos = 0
        while True:
            start = self.buf.find(SOI, pos)
            if start < 0:
                # Keep a trailing 0xFF: it may be the SOI's first byte with
                # the 0xD8 still in flight (dropping it would silently skip
                # the whole next frame).
                self.buf = self.buf[-1:] if self.buf.endswith(b"\xFF") else b""
                return
            end = self.buf.find(EOI, start + 2)
            if end < 0:
                self.buf = self.buf[start:]  # partial frame: keep from SOI
                return
            yield self.buf[start : end + 2]
            pos = end + 2


def split_frames(stream: bytes) -> Iterator[bytes]:
    """Split a concatenated-JPEG (MJPEG) buffer into individual frames.

    Scans SOI..EOI spans; bytes between frames (padding, timestamps some
    encoders insert) are skipped. EOI detection accounts for byte stuffing
    and RST markers, so an embedded FFD9-looking byte pair inside entropy
    data cannot occur (FFD9 never appears inside a valid scan: FF is always
    stuffed or a marker).
    """
    yield from FrameAssembler().feed(stream)


def frames_from_stream(f, chunk_size: int = 1 << 20) -> Iterator[bytes]:
    """Stream frames from a binary file object (a pipe, a socket, stdin).

    This is the live-capture integration path: a camera daemon or
    ``ffmpeg -f v4l2 -i /dev/video0 -c copy -f mjpeg -`` writes the raw
    MJPG byte stream to a pipe and the viewer decodes frames as they
    arrive (the role linuxvideo's `Stream::dequeue` plays for the
    reference viewer, examples/viewer.rs:40-89). Reads whatever is
    available (``read1`` when the object offers it — a plain ``read(n)``
    on a buffered pipe would block until a full ``chunk_size`` accumulates,
    batching ~20 webcam frames before the first is yielded); ends when the
    stream does.
    """
    read1 = getattr(f, "read1", None)
    asm = FrameAssembler()
    while True:
        chunk = read1(chunk_size) if read1 is not None else f.read(chunk_size)
        if not chunk:
            return
        yield from asm.feed(chunk)


def frames_from_file(path: str, chunk_size: int = 1 << 20) -> Iterator[bytes]:
    """Stream frames from an .mjpeg file without loading it whole."""
    with open(path, "rb") as f:
        asm = FrameAssembler()
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                return
            yield from asm.feed(chunk)


def follow_frames(path: str, poll_s: float = 0.02,
                  idle_timeout_s: float | None = None,
                  chunk_size: int = 1 << 20) -> Iterator[bytes]:
    """Tail a GROWING .mjpeg file, yielding frames as they are appended
    (the file-based stand-in for a live capture feed). Polls every
    ``poll_s`` when no new bytes are available; stops after
    ``idle_timeout_s`` with no growth (None = follow forever).
    """
    import time

    asm = FrameAssembler()
    idle = 0.0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                if idle_timeout_s is not None and idle >= idle_timeout_s:
                    return
                time.sleep(poll_s)
                idle += poll_s
                continue
            idle = 0.0
            yield from asm.feed(chunk)


def concat_frames(frames: Iterable[bytes]) -> bytes:
    """Inverse helper: build an MJPEG buffer from JPEG frames."""
    return b"".join(frames)
