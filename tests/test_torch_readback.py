"""The one-shot readback: every ``Decoder`` call that returns host pixels
(``decode``, ``decode_rgba``, ``DecodeOp.rgb``, ``decode_scaled``,
``decode_ycbcr``) gives an array of its own, which later decodes leave as
it is. On a CUDA device the array is a block of torch's pinned-memory
cache (``pipeline.to_host``), which the cache takes back when the array is
dropped and hands to the next readback; the card's tests hold it to that.

The card's tests are the CPU tests with three more checks, and skip
without a card. This file imports neither jax nor ``compeg_tpu``: on the
card, run it alone (``python -m pytest tests/test_torch_readback.py
--noconftest``)."""

import logging
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from compeg_tpu_torch import Decoder, encoder, golden  # noqa: E402
from compeg_tpu_torch import profiling as P  # noqa: E402
from compeg_tpu_torch.metadata import analyze  # noqa: E402

METHODS = ["decode", "decode_rgba", "DecodeOp.rgb", "decode_scaled",
           "decode_ycbcr"]
# The methods whose readback is the `readback` span of the one-shot decode.
SPANNED = ("decode", "decode_rgba")
H, W = 24, 40


def frame(seed: int) -> bytes:
    rgb = np.random.default_rng(seed).integers(0, 256, (H, W, 3), np.uint8)
    return encoder.encode(rgb, sampling="420", quality=90,
                          restart_interval_mcus=1)


def arrays(dec: Decoder, method: str, data: bytes) -> list:
    """The host arrays one call of ``method`` returns."""
    if method == "DecodeOp.rgb":
        return [dec.start_decode(data).rgb()]
    if method == "decode_scaled":
        return [dec.decode_scaled(data, 2)]
    out = getattr(dec, method)(data)
    return out if method == "decode_ycbcr" else [out]


def assert_golden(method: str, data: bytes, got: list) -> None:
    """``got`` is golden's decode of ``data``: byte for byte on the integer
    IDCT, within 1 on the scaled decode's float IDCT (the bound of
    tests/test_torch_scaled.py)."""
    if method == "decode_scaled":
        want = golden.decode_rgb(data, scale_blocks=2)
        assert got[0].shape == want.shape
        assert np.abs(got[0].astype(int) - want.astype(int)).max() <= 1
        return
    if method == "decode_ycbcr":
        img = analyze(data)
        planes = golden.assemble_planes(img, golden.idct_pixels_int(
            golden.decode_coefficients(img, dequant=False), img))
        crops = [(-(-H * c.v_sample // img.max_v),
                  -(-W * c.h_sample // img.max_h)) for c in img.components]
        want = [p[:h, :w] for p, (h, w) in zip(planes, crops)]
    else:
        want = [golden.decode_rgb(data, idct="int")]
        if method == "decode_rgba":
            assert (got[0][..., 3] == 255).all()
            got = [got[0][..., :3]]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and np.array_equal(g, w)


def kept_frame_survives(device: str, method: str):
    """Decode frame A and keep its arrays, decode B and C, and check that
    A's arrays are unchanged, share no memory with B's or C's and equal
    golden's A. Returns the decoder, A's arrays and B's."""
    dec = Decoder(device=device, exact_idct=True)
    a_data, b_data, c_data = frame(0), frame(1), frame(2)
    a = arrays(dec, method, a_data)
    a_copy = [x.copy() for x in a]
    b = arrays(dec, method, b_data)
    c = arrays(dec, method, c_data)
    for x, x_copy in zip(a, a_copy):
        assert np.array_equal(x, x_copy)
        for y in b + c:
            assert not np.shares_memory(x, y)
    assert_golden(method, a_data, a)
    assert_golden(method, b_data, b)
    assert not all(np.array_equal(x, y) for x, y in zip(a, b))
    return dec, a, b


@pytest.mark.parametrize("method", METHODS)
def test_a_kept_frame_survives_later_decodes(method):
    kept_frame_survives("cpu", method)


def test_counts_are_exact_across_threads_and_logged(caplog):
    threads, each = 8, 5000
    P.reset_stats()
    start = threading.Barrier(threads)

    def work():
        start.wait(timeout=60)
        for _ in range(each):
            P.count(P.PINNED_READBACKS)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    assert P.get_counts() == {P.PINNED_READBACKS: threads * each}
    assert P.get_stats() == {}
    with caplog.at_level(logging.INFO, logger=P.log.name):
        P.log_stats()
    assert f"{P.PINNED_READBACKS}: n={threads * each}" in caplog.text
    share = 1 - P.host_allocs() / (threads * each)  # 1 without a card
    assert f"hit share >= {share:.4f}" in caplog.text
    P.reset_stats()
    assert P.get_counts() == {}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned readback runs on a "
                    "card only")
    return "cuda"


@pytest.mark.parametrize("method", METHODS)
def test_on_the_card_a_kept_frame_is_pinned_and_its_block_recycled(
        method, cuda):
    dec, a, b = kept_frame_survives(cuda, method)
    for x in a + b:
        assert torch.from_numpy(x).is_pinned()
    data = frame(3)
    del a, b
    P.reset_stats()
    per_call = len(arrays(dec, method, data))
    allocs = P.host_allocs()
    for _ in range(32):
        got = arrays(dec, method, data)
        assert len(got) == per_call
        assert all(torch.from_numpy(x).is_pinned() for x in got)
        del got
    assert P.host_allocs() == allocs
    stats, counts = P.get_stats(), P.get_counts()
    assert counts[P.PINNED_READBACKS] == 33 * per_call
    if method in SPANNED:
        assert stats["readback"].count == stats["decode"].count == 33
    P.reset_stats()
