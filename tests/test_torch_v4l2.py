"""The port's V4L2 capture (compeg_tpu_torch.v4l2) through a fake driver:
the fake-driver cases of tests/test_v4l2.py:117-194 against the port's
Camera, and the one deliberate difference from the JAX package — with
``max_frames=None`` a run of ``max_consecutive_bad`` bad frames is skipped
and capture resumes; with ``max_frames`` given the run still raises. The
ABI (struct sizes, ioctl codes) is held to the JAX package's in
tests/test_torch_host.py."""

import pytest

pytest.importorskip("torch")

from compeg_tpu_torch import v4l2  # noqa: E402


class _FakeDriver:
    """Userspace stand-in for a V4L2 MJPG camera: answers the ioctl
    sequence Camera issues, serving ``FRAMES`` in a cycle."""

    FRAMES = [b"\xFF\xD8" + b"frame-a" + b"\xFF\xD9",
              b"junk-not-soi",  # starvation frame: must be skipped
              b"\xFF\xD8" + b"frame-b" + b"\xFF\xD9"]

    def __init__(self):
        self.buf_len = 64
        self.queued = []
        self.streaming = False
        self.served = 0
        self.maps = {i: bytearray(self.buf_len) for i in range(4)}

    def frame(self, k):
        return self.FRAMES[k % len(self.FRAMES)], 0

    def ioctl(self, fd, req, arg=0, mutate=True):
        if req == v4l2.VIDIOC_QUERYCAP:
            arg.capabilities = v4l2.CAP_VIDEO_CAPTURE | v4l2.CAP_STREAMING
            arg.device_caps = arg.capabilities
            card = b"fake-cam"
            arg.card[: len(card)] = card
        elif req == v4l2.VIDIOC_S_FMT:
            assert arg.fmt.pix.pixelformat == v4l2.PIX_FMT_MJPEG
            arg.fmt.pix.width, arg.fmt.pix.height = 320, 240
        elif req == v4l2.VIDIOC_REQBUFS:
            assert arg.memory == v4l2.MEMORY_MMAP
            arg.count = min(arg.count, 4)
        elif req == v4l2.VIDIOC_QUERYBUF:
            arg.length = self.buf_len
            arg.m.offset = arg.index * 4096
        elif req == v4l2.VIDIOC_QBUF:
            self.queued.append(arg.index)
        elif req == v4l2.VIDIOC_DQBUF:
            assert self.streaming and self.queued
            i = self.queued.pop(0)
            data, flags = self.frame(self.served)
            self.served += 1
            self.maps[i][: len(data)] = data
            arg.index, arg.bytesused, arg.flags = i, len(data), flags
        elif req == v4l2.VIDIOC_STREAMON:
            self.streaming = True
        elif req == v4l2.VIDIOC_STREAMOFF:
            self.streaming = False
        else:
            raise AssertionError(f"unexpected ioctl {req:#x}")
        return 0


def _fake_camera(monkeypatch, drv, **kw):
    monkeypatch.setattr(v4l2.os, "open", lambda *a: 42)
    monkeypatch.setattr(v4l2.os, "close", lambda fd: None)
    monkeypatch.setattr(v4l2.fcntl, "ioctl", drv.ioctl)

    class _FakeMmapModule:
        MAP_SHARED = PROT_READ = 0

        @staticmethod
        def mmap(fd, length, flags, prot, offset=0):
            assert length == drv.buf_len and offset % 4096 == 0

            class _M:
                def __getitem__(self, s):
                    return bytes(drv.maps[offset // 4096][s])

                def close(self):
                    pass

            return _M()

    monkeypatch.setattr(v4l2, "mmap", _FakeMmapModule)
    return v4l2.Camera("/dev/video0", **kw)


def test_missing_device_raises_oserror():
    with pytest.raises(OSError):
        v4l2.Camera("/dev/video999")


def test_camera_logic_with_fake_driver(monkeypatch):
    drv = _FakeDriver()
    with _fake_camera(monkeypatch, drv, size=(640, 480)) as cam:
        assert cam.size == (320, 240)  # driver-negotiated, not requested
        assert cam.card == "fake-cam"
        assert len(cam.maps) == 4 and len(drv.queued) == 4
        got = list(cam.frames(max_frames=2))
    # Two SOI-led frames delivered; the non-JPEG starvation frame skipped.
    assert got == [_FakeDriver.FRAMES[0], _FakeDriver.FRAMES[2]]
    assert drv.served == 3
    assert not drv.streaming  # close() issued STREAMOFF


def test_camera_skips_error_flagged_frames(monkeypatch):
    """Frames flagged V4L2_BUF_FLAG_ERROR are dropped even when their
    payload starts with SOI."""

    class _ErrDriver(_FakeDriver):
        FRAMES = [b"\xFF\xD8ok\xFF\xD9"]

        def frame(self, k):
            return self.FRAMES[0], v4l2.BUF_FLAG_ERROR if k % 2 else 0

    drv = _ErrDriver()
    with _fake_camera(monkeypatch, drv) as cam:
        got = list(cam.frames(max_frames=3))
    assert got == [b"\xFF\xD8ok\xFF\xD9"] * 3
    assert drv.served == 5  # frames 1 and 3 were error-flagged


def test_camera_bad_frame_run_raises_with_max_frames(monkeypatch):
    """With max_frames given, a camera that only delivers garbage raises
    after a bounded run instead of spinning forever."""
    drv = _FakeDriver()
    drv.FRAMES = [b"garbage-no-soi"]
    with _fake_camera(monkeypatch, drv) as cam:
        with pytest.raises(OSError, match="consecutive"):
            list(cam.frames(max_frames=1, max_consecutive_bad=5))
    assert drv.served == 5


def test_open_ended_stream_skips_a_bad_run_and_resumes(monkeypatch):
    """The port's deliberate difference from compeg_tpu/v4l2.py:262-293:
    with max_frames=None the bound does not apply, so a run of
    max_consecutive_bad bad frames (error-flagged and not SOI-led) is
    skipped and capture resumes when the camera does; the same run under
    max_frames raises."""
    good = [b"\xFF\xD8" + bytes([65 + k]) + b"\xFF\xD9" for k in range(3)]

    class _StarvingDriver(_FakeDriver):
        # one good frame, then 2 * bad bad frames, then good ones again
        def frame(self, k):
            if k == 0:
                return good[0], 0
            if k <= 2 * self.bad:
                return ((b"\xFF\xD8x\xFF\xD9", v4l2.BUF_FLAG_ERROR)
                        if k % 2 else (b"no-soi", 0))
            return good[1 + (k - 2 * self.bad - 1) % 2], 0

    drv = _StarvingDriver()
    drv.bad = 4
    with _fake_camera(monkeypatch, drv) as cam:
        frames = cam.frames(max_consecutive_bad=drv.bad)
        got = [next(frames) for _ in range(3)]
        frames.close()
    assert got == good
    assert drv.served == 2 * drv.bad + 3

    drv = _StarvingDriver()
    drv.bad = 4
    with _fake_camera(monkeypatch, drv) as cam:
        with pytest.raises(OSError, match="consecutive"):
            list(cam.frames(max_frames=3, max_consecutive_bad=drv.bad))
    assert drv.served == 1 + drv.bad


def test_capture_frames_closes_the_camera(monkeypatch):
    """capture_frames streams max_frames frames and closes the device."""
    drv = _FakeDriver()
    monkeypatch.setattr(v4l2.os, "open", lambda *a: 42)
    closed = []
    monkeypatch.setattr(v4l2.os, "close", closed.append)
    monkeypatch.setattr(v4l2.fcntl, "ioctl", drv.ioctl)

    class _FakeMmapModule:
        MAP_SHARED = PROT_READ = 0

        @staticmethod
        def mmap(fd, length, flags, prot, offset=0):
            class _M:
                def __getitem__(self, s):
                    return bytes(drv.maps[offset // 4096][s])

                def close(self):
                    pass

            return _M()

    monkeypatch.setattr(v4l2, "mmap", _FakeMmapModule)
    got = list(v4l2.capture_frames("/dev/video0", max_frames=4))
    assert got == [_FakeDriver.FRAMES[0], _FakeDriver.FRAMES[2]] * 2
    assert closed == [42] and not drv.streaming


def test_testdata_fake_camera_feeds_the_stream_decoder(test_image):
    """compeg_tpu_torch.testdata.fake_v4l2 (what the smoke run drives on the
    card): camera frames, an error-flagged one and a non-JPEG one among
    them, through Camera.frames into StreamDecoder, each equal to the
    port's Decoder; the v4l2 module's names are put back afterwards."""
    import numpy as np

    from compeg_tpu_torch import Decoder, StreamDecoder, encoder
    from compeg_tpu_torch.testdata.fake_v4l2 import FakeCamera

    good = [encoder.encode(test_image(16, 32, "noise", seed=s),
                           sampling="422", emit_dht=False,
                           restart_interval_mcus=1) for s in range(4)]
    served = [(good[0], 0), (good[1], v4l2.BUF_FLAG_ERROR), (good[1], 0),
              (b"\x00not-a-jpeg", 0), (good[2], 0), (good[3], 0)]
    cam = FakeCamera(served, size=(32, 16))
    saved = v4l2.os, v4l2.fcntl, v4l2.mmap
    with cam.installed():
        with v4l2.Camera("/dev/video0") as c:
            assert c.size == (32, 16) and c.card == "fake-mjpg-cam"
            outs = list(StreamDecoder(device="cpu", prepare_threads=2)
                        .decode_iter_rgb(c.frames(max_frames=4)))
    assert (v4l2.os, v4l2.fcntl, v4l2.mmap) == saved
    assert cam.served == 6 and not cam.streaming
    dec = Decoder(device="cpu")
    assert len(outs) == 4
    for o, f in zip(outs, good):
        assert np.array_equal(o, dec.decode(f))
