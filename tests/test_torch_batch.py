"""compeg_tpu_torch's BatchDecoder and StreamDecoder on the CPU (the kernels'
plain versions) against the JAX classes (interpret mode), the golden decoder
and the port's own single-frame Decoder: the mirror of tests/test_batch.py
and of the stream tests of tests/test_stream.py.

Tolerances: the float default within 1 of golden and of the JAX classes (the
f32 IDCT sums in another order in each); ``exact_idct`` byte-identical to
``golden.decode_rgb(idct="int")``; fancy + exact byte-identical to the
single-frame fancy decode; a batch or a stream byte-identical to the port's
own single-frame decode of each frame, in order. The JAX side compiles one
interpret-mode kernel per stream, so it is asked three times in all."""

import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from compeg_tpu import encoder, golden  # noqa: E402
from compeg_tpu.batch import BatchDecoder as JaxBatchDecoder  # noqa: E402
from compeg_tpu.batch import StreamDecoder as JaxStreamDecoder  # noqa: E402
from compeg_tpu_torch import (BatchDecoder, CompegError, Decoder,  # noqa: E402
                              StreamDecoder)
from compeg_tpu_torch import batch as B  # noqa: E402
from compeg_tpu_torch.ops import fused as F  # noqa: E402


def frames_of(test_image, n=3, h=16, w=32, sampling="422", ri=1, quality=80,
              kind="noise"):
    return [encoder.encode(test_image(h, w, kind, seed=s), sampling=sampling,
                           quality=quality, restart_interval_mcus=ri)
            for s in range(n)]


def max_diff(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def test_batch_matches_golden_and_the_jax_batch(test_image):
    frames = frames_of(test_image)
    out = BatchDecoder(device="cpu").decode(frames)
    assert out.shape == (3, 16, 32, 3) and out.dtype == np.uint8
    jax_out = JaxBatchDecoder(interpret=True).decode(frames)
    for i, f in enumerate(frames):
        assert max_diff(out[i], golden.decode_rgb(f)) <= 1
        assert max_diff(out[i], jax_out[i]) <= 1


@pytest.mark.parametrize("sampling,ri,h,w", [
    ("422", 1, 16, 32), ("420", 1, 32, 48), ("gray", 1, 16, 24),
    ("444", 3, 16, 40), ("411", None, 16, 64)])
def test_batch_exact_is_golden_byte_for_byte(sampling, ri, h, w, test_image):
    frames = frames_of(test_image, sampling=sampling, ri=ri, h=h, w=w)
    out = BatchDecoder(device="cpu", exact_idct=True).decode(frames)
    for i, f in enumerate(frames):
        assert np.array_equal(out[i], golden.decode_rgb(f, idct="int")), i


@pytest.mark.parametrize("sampling", ["422", "420"])
def test_batch_fancy_exact_equals_the_single_frame_decode(sampling,
                                                           test_image):
    """Batched fancy upsampling is bit-identical to the per-frame fancy
    decode, 4:2:0 included, where the vertical filter must not reach into
    the neighbouring frame of the batch."""
    frames = frames_of(test_image, n=3, sampling=sampling)
    out = BatchDecoder(device="cpu", fancy_upsampling=True,
                       exact_idct=True).decode(frames)
    dec = Decoder(device="cpu", fancy_upsampling=True, exact_idct=True)
    for i, f in enumerate(frames):
        assert np.array_equal(out[i], dec.decode(f)), (sampling, i)
    # Not the nearest decode by accident.
    nearest = Decoder(device="cpu", exact_idct=True).decode(frames[0])
    assert not np.array_equal(out[0], nearest)


def test_batch_fancy_float_matches_the_jax_batch(test_image):
    frames = frames_of(test_image, n=2, sampling="420")
    out = BatchDecoder(device="cpu", fancy_upsampling=True).decode(frames)
    jax_out = JaxBatchDecoder(interpret=True,
                              fancy_upsampling=True).decode(frames)
    dec = Decoder(device="cpu", fancy_upsampling=True)
    for i, f in enumerate(frames):
        assert np.array_equal(out[i], dec.decode(f))
        # one IDCT sample off by 1 moves a filtered chroma by at most 1,
        # and a pixel through BT.601 by at most 2
        assert max_diff(out[i], jax_out[i]) <= 2


def test_batch_fancy_where_the_jax_package_cannot_tile(test_image):
    """24x48 4:2:2 with Ri = 2: the JAX package falls back to its staged
    tier there; the port's fancy batch takes K3 like any other and equals
    the single-frame fancy decode."""
    frames = frames_of(test_image, n=2, h=24, w=48, ri=2)
    bdec = BatchDecoder(device="cpu", fancy_upsampling=True)
    out = bdec.to_rgb(bdec.decode_prepared(bdec.prepare_batch(frames)))
    dec = Decoder(device="cpu", fancy_upsampling=True)
    for i, f in enumerate(frames):
        assert np.array_equal(out[i], dec.decode(f))


@pytest.mark.parametrize("sampling,ri,h,w", [
    ("422", 1, 48, 128),   # 48 segments: one full block of 32 and a part
    ("422", 5, 16, 48),    # 6 MCUs in segments of 5: a short last interval
    ("420", 5, 40, 136),   # 27 MCUs: five full intervals and one of 2
    ("422", 3, 24, 80)])   # 15 MCUs wrapping MCU rows
def test_batch_frames_do_not_mix(sampling, ri, h, w, test_image):
    """Segment counts that are no multiple of the kernel's 32 segments per
    block and short last intervals: every frame of the batch is its own
    single-frame decode, and the frames differ."""
    frames = frames_of(test_image, n=4, sampling=sampling, ri=ri, h=h, w=w)
    out = BatchDecoder(device="cpu", exact_idct=True).decode(frames)
    for i, f in enumerate(frames):
        assert np.array_equal(out[i], golden.decode_rgb(f, idct="int")), i
    assert not np.array_equal(out[0], out[1])
    # The same frames in another order come back in that order.
    back = BatchDecoder(device="cpu", exact_idct=True).decode(frames[::-1])
    assert np.array_equal(back, out[::-1])


def test_batch_rejects_mixed_geometry_and_tables(test_image):
    a = encoder.encode(test_image(16, 32), sampling="422",
                       restart_interval_mcus=1)
    b = encoder.encode(test_image(16, 48), sampling="422",
                       restart_interval_mcus=1)
    c = encoder.encode(test_image(16, 32), sampling="422", quality=40,
                       restart_interval_mcus=1)  # another DQT
    bdec = BatchDecoder(device="cpu")
    for pair in ([a, b], [a, c]):
        with pytest.raises(CompegError, match="share geometry and tables"):
            bdec.prepare_batch(pair)
    assert bdec.decode([a, a]).shape == (2, 16, 32, 3)
    with pytest.raises(CompegError):
        bdec.prepare_batch([])


def test_batch_is_one_upload_and_one_kernel_call(monkeypatch, test_image):
    frames = frames_of(test_image, n=5)
    calls = []
    real = F.fused_decode_rgba

    def spy(rows, *args):
        calls.append(tuple(rows.shape))
        return real(rows, *args)

    monkeypatch.setattr(F, "fused_decode_rgba", spy)
    bdec = BatchDecoder(device="cpu")
    pfs = bdec.prepare_batch(frames)
    # every frame's rows are a slot of the one staging buffer
    staged = bdec._staging.tensor.numpy().view(np.uint32)
    assert all(np.shares_memory(pf.rows, staged[i])
               for i, pf in enumerate(pfs))
    out = bdec.decode_prepared(pfs)
    assert calls == [(5, 1024, pfs[0].rows.shape[1])]
    assert out.shape == (5, 16, 32) and out.dtype == torch.int32


def test_decode_prepared_takes_only_its_own_batch(test_image):
    """The batch's rows lie in the decoder's one staging buffer, so frames
    prepared elsewhere, another order or a batch since overwritten are
    refused, not decoded from the wrong rows."""
    frames = frames_of(test_image, n=3)
    bdec = BatchDecoder(device="cpu")
    pfs = bdec.prepare_batch(frames)
    dec = Decoder(device="cpu")
    for wrong in ([dec.prepare(f) for f in frames], pfs[::-1], pfs[:2]):
        with pytest.raises(ValueError, match="last prepare_batch"):
            bdec.decode_prepared(wrong)
    assert bdec.decode_prepared(pfs).shape == (3, 16, 32)
    bdec.prepare_batch(frames[::-1])  # overwrites the buffer pfs point into
    with pytest.raises(ValueError, match="last prepare_batch"):
        bdec.decode_prepared(pfs)


def test_batch_row_width_grows_with_the_longest_segment(test_image):
    """The batch packs at one width: a later frame (or batch) with longer
    segments re-measures every frame and repacks."""
    flat = frames_of(test_image, n=2, kind="flat", quality=90)
    noisy = frames_of(test_image, n=2, kind="noise", quality=90)
    bdec = BatchDecoder(device="cpu", exact_idct=True)
    for batch in (flat, [flat[0], noisy[1]], noisy, flat):
        out = bdec.decode(batch)
        for i, f in enumerate(batch):
            assert np.array_equal(out[i], golden.decode_rgb(f, idct="int"))
    narrow = BatchDecoder(device="cpu").prepare_batch(flat)[0].rows.shape[1]
    assert bdec._dec._cached_width > narrow


def test_batch_device_budget_is_per_batch(test_image):
    frames = frames_of(test_image, n=4, h=64, w=64)
    bdec = BatchDecoder(device="cpu", max_device_bytes=3 * 64 * 64 * 6)
    assert bdec.decode(frames[:1]).shape == (1, 64, 64, 3)
    with pytest.raises(CompegError, match="budget"):
        bdec.decode(frames)


def test_batch_unported_and_unknown_knobs():
    assert BatchDecoder(device="cpu", fused=False).fused is False  # staged
    with pytest.raises(TypeError):
        BatchDecoder(device="cpu", interpret=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            BatchDecoder()
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            StreamDecoder()


def test_plain_batch_kernels_equal_the_single_frame_ones(test_image):
    """ops/fused.py on a [B, R, W] tensor: K2, K2x and K3 give the stacked
    single-frame results."""
    frames = frames_of(test_image, n=3, sampling="420", h=32, w=48, ri=2)
    for exact in (False, True):
        bdec = BatchDecoder(device="cpu", exact_idct=exact)
        pf = bdec.prepare_batch(frames)[0]
        rows = bdec._staging.tensor  # [B, R, W] on the host
        args = (pf.nseg, pf.tables, pf.op, pf.geom)
        fn = F.fused_decode_rgba_exact if exact else F.fused_decode_rgba
        got = fn(rows, *args)
        planes = F.fused_decode_planes(rows, *args, exact=exact)
        for i in range(3):
            assert torch.equal(got[i], fn(rows[i], *args))
            one = F.fused_decode_planes(rows[i], *args, exact=exact)
            assert all(torch.equal(p[i], q) for p, q in zip(planes, one))
    with pytest.raises(ValueError, match="one frame"):
        F.fused_decode_scaled(rows, pf.nseg, pf.tables, pf.op, pf.geom, 2)


# -- streams ---------------------------------------------------------------


def stream_frames(test_image, n=5, quality=85):
    return [encoder.encode(test_image(24, 48, "noise", seed=i),
                           sampling="422", quality=quality,
                           restart_interval_mcus=1) for i in range(n)]


def test_stream_decoder_matches_golden_and_the_jax_stream(test_image):
    frames = stream_frames(test_image)
    outs = list(StreamDecoder(device="cpu").decode_iter_rgb(frames))
    jax_outs = list(JaxStreamDecoder(interpret=True,
                                     prepare_threads=1).decode_iter_rgb(frames))
    assert len(outs) == 5
    for f, o, j in zip(frames, outs, jax_outs):
        assert max_diff(o, golden.decode_rgb(f)) <= 1
        assert max_diff(o, j) <= 1


@pytest.mark.parametrize("threads,depth", [(1, 1), (1, 3), (2, 2), (4, 1)])
def test_stream_yields_in_order(threads, depth, test_image):
    frames = stream_frames(test_image, 7)
    sd = StreamDecoder(device="cpu", depth=depth, prepare_threads=threads)
    outs = [sd.to_rgb(o) for o in sd.decode_iter(frames)]
    dec = Decoder(device="cpu")
    assert len(outs) == 7
    for f, out in zip(frames, outs):
        assert np.array_equal(out, dec.decode(f))
    assert not np.array_equal(outs[0], outs[1])
    # An iterator that is not a list, and a second run on the same ring.
    again = list(sd.decode_iter_rgb(iter(frames[:3])))
    assert all(np.array_equal(a, o) for a, o in zip(again, outs))
    assert sd._ring.qsize() == max(threads + 1, depth) + 1


def test_stream_alternating_streams_no_crosstalk(test_image):
    """Two interleaved streams of one geometry but other quantization tables
    through the worker threads' shared header cache."""
    a = stream_frames(test_image, 3, quality=85)
    b = stream_frames(test_image, 3, quality=45)
    mixed = [f for pair in zip(a, b) for f in pair]
    want = [Decoder(device="cpu").decode(f) for f in mixed]
    sd = StreamDecoder(device="cpu", prepare_threads=3)
    for _ in range(2):
        got = list(sd.decode_iter_rgb(mixed))
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_stream_failure_and_abandonment_keep_the_ring_whole(test_image):
    frames = stream_frames(test_image, 6)
    bad = frames[2][: len(frames[2]) // 2] + b"\xff\xd9"
    sd = StreamDecoder(device="cpu", prepare_threads=2)
    size = sd._ring.qsize()
    with pytest.raises(CompegError):
        list(sd.decode_iter(frames[:2] + [bad] + frames[3:]))
    assert sd._ring.qsize() == size
    it = sd.decode_iter(frames)
    next(it)
    it.close()  # abandoned with frames prepared and not launched
    assert sd._ring.qsize() == size
    assert len(list(sd.decode_iter_rgb(frames))) == 6


def test_stream_many_workers_stress(test_image):
    """More workers than cores and a short switch interval: every frame of
    a long stream still comes back as itself, in order."""
    base = stream_frames(test_image, 4)
    frames = [base[i % 4] for i in range(48)]
    dec = Decoder(device="cpu")
    want = [dec.decode(f) for f in base]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t0 = time.monotonic()
    try:
        sd = StreamDecoder(device="cpu", prepare_threads=16, depth=3)
        got = list(sd.decode_iter_rgb(frames))
    finally:
        sys.setswitchinterval(old)
    assert len(got) == 48 and time.monotonic() - t0 < 120
    assert all(np.array_equal(g, want[i % 4]) for i, g in enumerate(got))


def test_staging_buffers_are_reused_and_resized():
    s = B._Staging(cuda=False)
    a = s.array(4, 3)
    assert a.dtype == np.uint32 and a.shape == (4, 3)
    a[...] = 7
    assert s.array(4, 3).ctypes.data == a.ctypes.data  # the same memory
    assert s.array(8, 3).shape == (8, 3)
    up = s.upload(torch.device("cpu"), 2)
    assert up.shape == (2, 3) and up.dtype == torch.int32 and s.event is None
