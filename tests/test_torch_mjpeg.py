"""The port's MJPEG stream plumbing (compeg_tpu_torch.mjpeg), a small mirror
of tests/test_mjpeg.py on device="cpu": splitting, junk between frames, a
file read in chunks, a pipe, a growing file, a marker split across chunks,
and a DHT-less MJPEG stream decoded by the port's StreamDecoder equal to
the port's Decoder and golden."""

import io
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from compeg_tpu_torch import Decoder, StreamDecoder, encoder, golden  # noqa: E402
from compeg_tpu_torch import mjpeg  # noqa: E402


def make_stream(test_image, n=4):
    frames = [
        encoder.encode(test_image(16, 32, "noise", seed=s), sampling="422",
                       emit_dht=False,  # MJPEG-style: Annex K defaults
                       restart_interval_mcus=1)
        for s in range(n)
    ]
    return frames, mjpeg.concat_frames(frames)


def test_split_roundtrip(test_image):
    frames, stream = make_stream(test_image)
    assert list(mjpeg.split_frames(stream)) == frames


def test_split_with_junk_between_frames(test_image):
    frames, _ = make_stream(test_image, n=2)
    stream = b"junk" + frames[0] + b"\x00\x01pad" + frames[1] + b"tail"
    assert list(mjpeg.split_frames(stream)) == frames


def test_frames_from_file(test_image, tmp_path):
    frames, stream = make_stream(test_image, n=5)
    path = tmp_path / "cap.mjpeg"
    path.write_bytes(stream)
    assert list(mjpeg.frames_from_file(str(path), chunk_size=700)) == frames


def test_frames_from_stream_pipe(test_image):
    frames, stream = make_stream(test_image, n=4)
    got = list(mjpeg.frames_from_stream(io.BytesIO(stream), chunk_size=333))
    assert got == frames


def test_follow_frames_growing_file(test_image, tmp_path):
    """Frames appended after the reader starts are still yielded."""
    frames, _ = make_stream(test_image, n=3)
    path = tmp_path / "live.mjpeg"
    path.write_bytes(frames[0])

    def writer():
        for f in frames[1:]:
            time.sleep(0.05)
            with open(path, "ab") as fh:
                fh.write(f)

    t = threading.Thread(target=writer)
    t.start()
    got = list(mjpeg.follow_frames(str(path), poll_s=0.01,
                                   idle_timeout_s=1.0))
    t.join(timeout=10)
    assert not t.is_alive() and got == frames


def test_frames_from_stream_marker_split_across_chunks(test_image):
    """A chunk that ends on the 0xFF of the next frame's SOI must not drop
    that frame; every split point through the assembler too."""
    frames, _ = make_stream(test_image, n=2)
    stream = frames[0] + frames[1]
    cut = len(frames[0]) + 1

    class TwoChunk(io.RawIOBase):
        def __init__(self):
            self.parts = [stream[:cut], stream[cut:]]

        def read(self, n=-1):
            return self.parts.pop(0) if self.parts else b""

    assert list(mjpeg.frames_from_stream(TwoChunk())) == frames
    for cut in range(len(stream)):
        asm = mjpeg.FrameAssembler()
        got = list(asm.feed(stream[:cut])) + list(asm.feed(stream[cut:]))
        assert got == frames, cut


def test_mjpeg_stream_decode(test_image):
    """The reference's headline use case on the port: a DHT-less MJPEG
    stream through StreamDecoder, every frame equal to the port's Decoder
    byte for byte and within 1 of golden."""
    frames, stream = make_stream(test_image, n=3)
    dec = StreamDecoder(device="cpu", prepare_threads=2)
    outs = list(dec.decode_iter_rgb(mjpeg.split_frames(stream)))
    assert len(outs) == 3
    single = Decoder(device="cpu")
    for f, o in zip(frames, outs):
        assert np.array_equal(o, single.decode(f))
        want = golden.decode_rgb(f)
        assert np.abs(o.astype(int) - want.astype(int)).max() <= 1
