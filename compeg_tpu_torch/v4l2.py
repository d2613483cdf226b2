"""V4L2 MJPEG capture — the live-webcam source for the viewer (the port's
copy of compeg_tpu/v4l2.py).

The reference viewer's flagship integration opens a V4L2 webcam in MJPG
mode via the ``linuxvideo`` crate and streams compressed frames straight
into the decoder (``examples/viewer.rs:40-89``: open device, pick the MJPG
``PixFormat``, ``ReadStream`` loop handing each frame to ``ImageData`` +
``Decoder::enqueue``). This module is the same capability with zero
dependencies: the V4L2 UAPI spoken directly over ``ioctl(2)`` + ``mmap(2)``
through ctypes — request MJPG format, queue a ring of mmap'd kernel
buffers, ``STREAMON``, and yield each dequeued buffer's bytes as one JPEG
frame for :class:`compeg_tpu_torch.batch.StreamDecoder`.

Design notes:

* The struct layouts below are the 64-bit kernel ABI. ioctl request codes
  are *derived* from ``ctypes.sizeof`` via the ``_IOC`` encoding rather
  than hard-coded, so a wrong struct layout shows up as a wrong request
  number — ``tests/test_torch_host.py`` pins both the sizes and the resulting
  codes against the kernel's published values, which makes this module
  verifiable on rigs with no camera (this one included).
* Cameras deliver MJPEG: baseline JPEG, usually with **no DHT segments**.
  The analyzer installs the ITU T.81 Annex K default tables for exactly
  this case (``metadata.py``; reference ``src/lib.rs:608-613``), so frames
  yielded here decode unmodified.
* Frames come out of ``DQBUF`` already delimited — no SOI/EOI scanning
  needed (contrast ``mjpeg.FrameAssembler`` for undelimited byte streams).
* One deliberate difference from the JAX package's copy: the bound on a
  run of bad frames (``Camera.frames``) applies only when ``max_frames``
  is given. An open-ended stream skips bad frames for as long as they
  come and resumes when the camera does.
"""

from __future__ import annotations

import ctypes
import fcntl
import mmap
import os
from typing import Iterator, Optional, Tuple

# --- ioctl request encoding (asm-generic/ioctl.h) -------------------------

_IOC_WRITE = 1
_IOC_READ = 2


def _ioc(direction: int, nr: int, size: int, ioc_type: str = "V") -> int:
    return (direction << 30) | (size << 16) | (ord(ioc_type) << 8) | nr


def _ior(nr: int, struct: type) -> int:
    return _ioc(_IOC_READ, nr, ctypes.sizeof(struct))


def _iow(nr: int, struct: type) -> int:
    return _ioc(_IOC_WRITE, nr, ctypes.sizeof(struct))


def _iowr(nr: int, struct: type) -> int:
    return _ioc(_IOC_READ | _IOC_WRITE, nr, ctypes.sizeof(struct))


# --- UAPI structs (linux/videodev2.h, 64-bit layout) ----------------------


class Capability(ctypes.Structure):
    _fields_ = [
        ("driver", ctypes.c_uint8 * 16),
        ("card", ctypes.c_uint8 * 32),
        ("bus_info", ctypes.c_uint8 * 32),
        ("version", ctypes.c_uint32),
        ("capabilities", ctypes.c_uint32),
        ("device_caps", ctypes.c_uint32),
        ("reserved", ctypes.c_uint32 * 3),
    ]


class PixFormat(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_uint32),
        ("height", ctypes.c_uint32),
        ("pixelformat", ctypes.c_uint32),
        ("field", ctypes.c_uint32),
        ("bytesperline", ctypes.c_uint32),
        ("sizeimage", ctypes.c_uint32),
        ("colorspace", ctypes.c_uint32),
        ("priv", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("ycbcr_enc", ctypes.c_uint32),
        ("quantization", ctypes.c_uint32),
        ("xfer_func", ctypes.c_uint32),
    ]


class _FormatUnion(ctypes.Union):
    # The kernel union's largest arms (v4l2_window et al) carry pointers,
    # giving it 8-byte alignment and 200 bytes on 64-bit; the u64 arm
    # reproduces both without declaring every variant.
    _fields_ = [
        ("pix", PixFormat),
        ("raw", ctypes.c_uint8 * 200),
        ("_align", ctypes.c_uint64 * 25),
    ]


class Format(ctypes.Structure):
    _fields_ = [("type", ctypes.c_uint32), ("fmt", _FormatUnion)]


class RequestBuffers(ctypes.Structure):
    _fields_ = [
        ("count", ctypes.c_uint32),
        ("type", ctypes.c_uint32),
        ("memory", ctypes.c_uint32),
        ("capabilities", ctypes.c_uint32),
        ("flags", ctypes.c_uint8),
        ("reserved", ctypes.c_uint8 * 3),
    ]


class Timecode(ctypes.Structure):
    _fields_ = [
        ("type", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("frames", ctypes.c_uint8),
        ("seconds", ctypes.c_uint8),
        ("minutes", ctypes.c_uint8),
        ("hours", ctypes.c_uint8),
        ("userbits", ctypes.c_uint8 * 4),
    ]


class _Timeval(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_usec", ctypes.c_long)]


class _BufferM(ctypes.Union):
    _fields_ = [
        ("offset", ctypes.c_uint32),
        ("userptr", ctypes.c_ulong),
        ("planes", ctypes.c_void_p),
        ("fd", ctypes.c_int32),
    ]


class Buffer(ctypes.Structure):
    _fields_ = [
        ("index", ctypes.c_uint32),
        ("type", ctypes.c_uint32),
        ("bytesused", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("field", ctypes.c_uint32),
        ("timestamp", _Timeval),
        ("timecode", Timecode),
        ("sequence", ctypes.c_uint32),
        ("memory", ctypes.c_uint32),
        ("m", _BufferM),
        ("length", ctypes.c_uint32),
        ("reserved2", ctypes.c_uint32),
        ("request_fd", ctypes.c_int32),
    ]


# --- request codes (derived; pinned by tests/test_torch_host.py) ---------

VIDIOC_QUERYCAP = _ior(0, Capability)
VIDIOC_S_FMT = _iowr(4, Format)
VIDIOC_REQBUFS = _iowr(8, RequestBuffers)
VIDIOC_QUERYBUF = _iowr(9, Buffer)
VIDIOC_QBUF = _iowr(15, Buffer)
VIDIOC_DQBUF = _iowr(17, Buffer)
VIDIOC_STREAMON = _iow(18, ctypes.c_int32)
VIDIOC_STREAMOFF = _iow(19, ctypes.c_int32)

BUF_TYPE_VIDEO_CAPTURE = 1
MEMORY_MMAP = 1
BUF_FLAG_ERROR = 0x00000040  # V4L2_BUF_FLAG_ERROR (videodev2.h)
FIELD_ANY = 0
CAP_VIDEO_CAPTURE = 0x00000001
CAP_STREAMING = 0x04000000


def fourcc(code: str) -> int:
    a, b, c, d = (ord(ch) for ch in code)
    return a | (b << 8) | (c << 16) | (d << 24)


PIX_FMT_MJPEG = fourcc("MJPG")
PIX_FMT_JPEG = fourcc("JPEG")


class Camera:
    """One V4L2 capture device streaming MJPEG via an mmap buffer ring.

    ``with Camera("/dev/video0", size=(1280, 720)) as cam:`` negotiates the
    format, maps ``n_buffers`` kernel buffers and starts streaming;
    ``cam.frames()`` yields one ``bytes`` JPEG per captured frame. The ring
    is requeued as frames are consumed, so the kernel always has buffers to
    fill — same structure as the reference's ``ReadStream`` loop.
    """

    def __init__(
        self,
        device: str = "/dev/video0",
        size: Optional[Tuple[int, int]] = None,
        n_buffers: int = 4,
    ) -> None:
        self.device = device
        self.fd = os.open(device, os.O_RDWR)
        self.maps: list = []
        try:
            cap = Capability()
            fcntl.ioctl(self.fd, VIDIOC_QUERYCAP, cap)
            if not (cap.device_caps or cap.capabilities) & CAP_VIDEO_CAPTURE:
                raise OSError(f"{device} is not a video capture device")
            if not (cap.device_caps or cap.capabilities) & CAP_STREAMING:
                raise OSError(f"{device} does not support streaming I/O")
            self.card = bytes(cap.card).split(b"\0", 1)[0].decode(errors="replace")

            fmt = Format()
            fmt.type = BUF_TYPE_VIDEO_CAPTURE
            if size is not None:
                fmt.fmt.pix.width, fmt.fmt.pix.height = size
            fmt.fmt.pix.pixelformat = PIX_FMT_MJPEG
            fmt.fmt.pix.field = FIELD_ANY
            fcntl.ioctl(self.fd, VIDIOC_S_FMT, fmt)
            # S_FMT negotiates: the driver writes back what it will deliver.
            if fmt.fmt.pix.pixelformat not in (PIX_FMT_MJPEG, PIX_FMT_JPEG):
                raise OSError(
                    f"{device} ({self.card}) cannot deliver MJPEG "
                    f"(got fourcc {fmt.fmt.pix.pixelformat:#010x})"
                )
            self.size = (fmt.fmt.pix.width, fmt.fmt.pix.height)

            req = RequestBuffers()
            req.count, req.type, req.memory = (
                n_buffers,
                BUF_TYPE_VIDEO_CAPTURE,
                MEMORY_MMAP,
            )
            fcntl.ioctl(self.fd, VIDIOC_REQBUFS, req)
            if req.count < 1:
                raise OSError(f"{device}: driver granted no buffers")
            for i in range(req.count):
                buf = Buffer()
                buf.index, buf.type, buf.memory = i, BUF_TYPE_VIDEO_CAPTURE, MEMORY_MMAP
                fcntl.ioctl(self.fd, VIDIOC_QUERYBUF, buf)
                self.maps.append(
                    mmap.mmap(
                        self.fd,
                        buf.length,
                        mmap.MAP_SHARED,
                        mmap.PROT_READ,
                        offset=buf.m.offset,
                    )
                )
                fcntl.ioctl(self.fd, VIDIOC_QBUF, buf)
            fcntl.ioctl(
                self.fd, VIDIOC_STREAMON, ctypes.c_int32(BUF_TYPE_VIDEO_CAPTURE)
            )
            self.streaming = True
        except BaseException:
            self.close()
            raise

    def frames(
        self, max_frames: Optional[int] = None, max_consecutive_bad: int = 64
    ) -> Iterator[bytes]:
        """Yield captured JPEG frames (copies — the mmap is requeued).

        Frames flagged ``V4L2_BUF_FLAG_ERROR`` by the driver or not starting
        with an SOI marker are skipped. With ``max_frames`` given, a run of
        ``max_consecutive_bad`` such frames raises instead of looping
        forever on a camera that only delivers error/starvation frames; an
        open-ended stream (``max_frames=None``) keeps skipping them and
        resumes when good frames come again, as a live viewer should."""
        n = 0
        bad = 0
        while max_frames is None or n < max_frames:
            buf = Buffer()
            buf.type, buf.memory = BUF_TYPE_VIDEO_CAPTURE, MEMORY_MMAP
            fcntl.ioctl(self.fd, VIDIOC_DQBUF, buf)  # blocks for next frame
            data = bytes(self.maps[buf.index][: buf.bytesused])
            flags = buf.flags
            fcntl.ioctl(self.fd, VIDIOC_QBUF, buf)
            # Some UVC cameras pad after EOI or deliver header-only error
            # frames on starvation; skip driver-flagged errors and anything
            # that is not SOI-led — but bound the skip run so max_frames
            # cannot hang indefinitely on a broken capture. Open-ended
            # streaming has no count to reach and keeps waiting.
            if not (flags & BUF_FLAG_ERROR) and data[:2] == b"\xFF\xD8":
                yield data
                n += 1
                bad = 0
            else:
                bad += 1
                if max_frames is not None and bad >= max_consecutive_bad:
                    raise OSError(
                        f"camera delivered {bad} consecutive error/non-JPEG "
                        "frames; giving up"
                    )

    def close(self) -> None:
        if getattr(self, "streaming", False):
            try:
                fcntl.ioctl(
                    self.fd, VIDIOC_STREAMOFF, ctypes.c_int32(BUF_TYPE_VIDEO_CAPTURE)
                )
            except OSError:
                pass
            self.streaming = False
        for m in self.maps:
            try:
                m.close()
            except (BufferError, OSError):
                pass
        self.maps.clear()
        if getattr(self, "fd", -1) >= 0:
            os.close(self.fd)
            self.fd = -1

    def __enter__(self) -> "Camera":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def capture_frames(
    device: str = "/dev/video0",
    size: Optional[Tuple[int, int]] = None,
    max_frames: Optional[int] = None,
) -> Iterator[bytes]:
    """Convenience generator: open ``device``, stream JPEG frames, close on
    exhaustion or generator close. The viewer's ``/dev/video*`` input path."""
    with Camera(device, size=size) as cam:
        yield from cam.frames(max_frames=max_frames)
