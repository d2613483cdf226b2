"""compeg_tpu_torch's scaled (thumbnail) decode on the CPU (kernel K2s's
plain twin), mirroring tests/test_scaled.py: within 1 of
``golden.decode_rgb(scale_blocks=k)`` (the f32 sum order; the bound of
tests/test_scaled.py:34), and of the JAX Decoder (Pallas, interpret mode)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from compeg_tpu import analyze, encoder, golden  # noqa: E402
from compeg_tpu.pipeline import Decoder as JaxDecoder  # noqa: E402
from compeg_tpu_torch import CompegError, Decoder  # noqa: E402
from compeg_tpu_torch.ops import fused as F  # noqa: E402
from compeg_tpu_torch.ops import idct as D  # noqa: E402
from test_torch_smoke_vectors import rgb_ids  # noqa: E402


def _gradient(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack(
        [xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
         (xx + yy) * 128 // max(h + w - 2, 1) + 64],
        axis=-1,
    ).astype(np.uint8)


def assert_within_one(got, want):
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("sampling",
                         ["422", "420", "444", "gray", "440", "411"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_scaled_matches_golden(sampling, k, test_image):
    data = encoder.encode(test_image(24, 48, "noise"), sampling=sampling,
                          quality=92, restart_interval_mcus=1)
    got = Decoder(device="cpu").decode_scaled(data, k)
    assert got.shape == (24 * k // 8, 48 * k // 8, 3)
    assert_within_one(got, golden.decode_rgb(data, scale_blocks=k))


@pytest.mark.parametrize("ri,retained,rgb", [
    (2, 64, False), (None, 64, False), (3, 64, False), (1, 32, False),
    (1, 64, True)])
def test_scaled_restarts_retained_rgb_ids(ri, retained, rgb, test_image):
    """Short final intervals (16x48 at Ri 2 and 3), one interval, the
    ``retained_coefficients`` knob and an RGB-ID frame, at every k."""
    data = encoder.encode(test_image(16, 48, "edges"),
                          sampling="444" if rgb else "422", quality=90,
                          restart_interval_mcus=ri)
    data = rgb_ids(data) if rgb else data
    dec = Decoder(device="cpu", retained_coefficients=retained)
    for k in (1, 2, 4):
        assert_within_one(dec.decode_scaled(data, k), golden.decode_rgb(
            data, retained_coefficients=retained, scale_blocks=k))


def test_scaled_matches_jax_kernel():
    """One stream through the JAX package's K2s (interpret mode)."""
    data = encoder.encode(_gradient(16, 32), sampling="420", quality=92,
                          restart_interval_mcus=1)
    got = Decoder(device="cpu").decode_scaled(data, 2)
    assert_within_one(got, JaxDecoder(interpret=True).decode_scaled(data, 2))


def test_scaled_k8_is_full_decode():
    data = encoder.encode(_gradient(32, 48), sampling="422", quality=90,
                          restart_interval_mcus=1)
    dec = Decoder(device="cpu")
    assert np.array_equal(dec.decode_scaled(data, 8), dec.decode(data))


def test_scaled_odd_dimensions_ceil_crop():
    """Non-multiple-of-8 sizes crop to ceil(dim*k/8), libjpeg's rounding."""
    data = encoder.encode(_gradient(17, 37), sampling="422", quality=90,
                          restart_interval_mcus=1)
    dec = Decoder(device="cpu")
    for k, hw in ((1, (3, 5)), (2, (5, 10)), (4, (9, 19))):
        out = dec.decode_scaled(data, k)
        assert out.shape == hw + (3,), (k, out.shape)
        assert_within_one(out, golden.decode_rgb(data, scale_blocks=k))


def test_scaled_flat_image_is_flat_at_every_scale():
    img = np.full((32, 64, 3), 128, np.uint8)
    data = encoder.encode(img, sampling="422", quality=90,
                          restart_interval_mcus=1)
    dec = Decoder(device="cpu")
    for k in (1, 2, 4, 8):
        out = dec.decode_scaled(data, k)
        assert np.abs(out.astype(int) - 128).max() <= 2, k


@pytest.mark.parametrize("k", [0, 3, 16])
def test_scaled_invalid_k_raises(k):
    data = encoder.encode(_gradient(16, 16), sampling="422", quality=90,
                          restart_interval_mcus=1)
    with pytest.raises(CompegError, match="scale_blocks"):
        Decoder(device="cpu").decode_scaled(data, k)


def test_scaled_ignores_exact_and_fancy():
    """decode_scaled always takes the float IDCT and nearest chroma."""
    data = encoder.encode(_gradient(24, 48), sampling="420", quality=90,
                          restart_interval_mcus=1)
    want = Decoder(device="cpu").decode_scaled(data, 4)
    got = Decoder(device="cpu", exact_idct=True,
                  fancy_upsampling=True).decode_scaled(data, 4)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_scaled_operators_vanish_past_their_prefix(k, test_image):
    """The kernel reads only the first SCALED_ZLEN[k] zigzag coefficients:
    every later operator row is zero, for any quantizers."""
    img = analyze(encoder.encode(test_image(16, 16), sampling="420"))
    op = D.scaled_operators(D.qz_by_slot_array(img), k)
    assert tuple(op.shape) == (6, 64, k * k)
    z = D.SCALED_ZLEN[k]
    assert (op[:, z:] == 0).all() and (op[:, z - 1] != 0).any()


def test_scaled_wrapper_checks_k_and_operators(test_image):
    dec = Decoder(device="cpu")
    pf = dec.prepare(encoder.encode(test_image(16, 16), sampling="422"))
    rows = dec.upload(pf)
    lq2 = D.scaled_operators(D.qz_by_slot_array(pf.image), 2)
    with pytest.raises(ValueError, match="k in 1, 2, 4"):
        F.fused_decode_scaled(rows, pf.nseg, pf.tables, lq2, pf.geom, 8)
    with pytest.raises(ValueError, match="lq_t"):
        F.fused_decode_scaled(rows, pf.nseg, pf.tables, lq2, pf.geom, 4)
    out = F.fused_decode_scaled(rows, pf.nseg, pf.tables, lq2, pf.geom, 2)
    assert tuple(out.shape) == (4, 4) and out.dtype == torch.int32
