"""compeg_tpu_torch's exact integer IDCT (kernel K2x's plain twin) and the
``zrl_compat`` entropy semantics on the CPU, against the golden decoder and
the JAX Decoder (Pallas, interpret mode). Everything here is integer
arithmetic, so every comparison is exact (tolerance 0)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from compeg_tpu import analyze, encoder, golden  # noqa: E402
from compeg_tpu.ops.int_idct import idct_2d_rows  # noqa: E402
from compeg_tpu.pipeline import Decoder as JaxDecoder  # noqa: E402
from compeg_tpu.tables import ZIGZAG  # noqa: E402
from compeg_tpu_torch import Decoder  # noqa: E402
from compeg_tpu_torch.ops import entropy as E  # noqa: E402
from compeg_tpu_torch.ops import fused as F  # noqa: E402
from compeg_tpu_torch.ops import idct as D  # noqa: E402
from compeg_tpu_torch.ops import int_idct as I  # noqa: E402
from test_torch_smoke_vectors import rgb_ids, wrap_stream, zrl_stream  # noqa: E402

# (sampling, restart interval, height, width, retained, RGB-ID)
CASES = [(s, 1, 24, 40, 64, False)
         for s in ("422", "444", "420", "440", "411", "gray")]
CASES += [("444", 1, 24, 40, 64, True), ("422", 2, 16, 48, 64, False),
          ("422", None, 16, 48, 64, False), ("420", 1, 24, 40, 32, False),
          ("422", 1, 17, 37, 64, False)]


def case_id(c):
    s, ri, h, w, r, rgb = c
    return f"{s}{'-rgbid' if rgb else ''}-ri{ri}-{h}x{w}-r{r}"


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_exact_decode_equals_golden_int(case, test_image):
    sampling, ri, h, w, retained, rgb = case
    data = encoder.encode(test_image(h, w, "noise"), sampling=sampling,
                          quality=90, restart_interval_mcus=ri)
    data = rgb_ids(data) if rgb else data
    got = Decoder(device="cpu", exact_idct=True,
                  retained_coefficients=retained).decode(data)
    want = golden.decode_rgb(data, retained_coefficients=retained, idct="int")
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want), np.abs(got.astype(int) - want).max()


def test_exact_decode_equals_jax_kernel(test_image):
    """One stream through the JAX package's K2x in interpret mode."""
    data = encoder.encode(test_image(16, 32, "noise"), sampling="420",
                          quality=90, restart_interval_mcus=1)
    got = Decoder(device="cpu", exact_idct=True).decode(data)
    want = JaxDecoder(interpret=True, exact_idct=True).decode(data)
    assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def zrl():
    return zrl_stream()


def test_plain_k1_zrl17_equals_golden_compat(zrl):
    img = analyze(zrl)
    dec = Decoder(device="cpu", zrl_compat=True)
    pf = dec.prepare(zrl)
    assert pf.tables.zrl17
    g = pf.geom
    out = E.entropy_decode(dec.upload(pf), pf.nseg, pf.tables, g.ri,
                           g.total_mcus, g.du_to_comp)
    got = E.coefficients_natural_order(out, g.total_mcus).numpy()
    compat = golden.decode_coefficients(img, dequant=False, zrl17=True)
    spec = golden.decode_coefficients(img, dequant=False)
    assert np.array_equal(got, compat)
    assert not np.array_equal(compat, spec)  # the stream exercises ZRL


@pytest.mark.parametrize("retained", [64, 32])
@pytest.mark.parametrize("planes", [None, True])
def test_compat_mode_bit_exact(zrl, retained, planes):
    """zrl_compat + exact_idct (retained 32: the reference's default, the
    documented Compeg-compat configuration), through K2x and through K3 +
    the nearest epilogue, equal golden's compat decode."""
    got = Decoder(device="cpu", zrl_compat=True, exact_idct=True,
                  retained_coefficients=retained,
                  planes_epilogue=planes).decode(zrl)
    want = golden.decode_rgb(zrl, retained_coefficients=retained, idct="int",
                             zrl17=True)
    assert np.array_equal(got, want)


def test_spec_mode_unaffected(zrl):
    got = Decoder(device="cpu", exact_idct=True).decode(zrl)
    assert np.array_equal(got, golden.decode_rgb(zrl, idct="int"))
    assert not np.array_equal(
        got, golden.decode_rgb(zrl, idct="int", zrl17=True))


def test_plain_int_idct_wraps_like_golden():
    """Random int16-range blocks: the int32 sums wrap (int64 evaluation of
    the same butterfly differs), and the plain twin equals
    golden.idct_pixels_int, wraps included."""
    data = wrap_stream()
    img = analyze(data)
    coeffs = golden.decode_coefficients(img, dequant=False)
    qz = I.int_quantizers(D.qz_by_slot_array(img))
    got = I.idct_pixels_int(torch.from_numpy(coeffs)[:, None], qz)[:, 0]
    assert np.array_equal(got.numpy().astype(np.uint8),
                          golden.idct_pixels_int(coeffs, img))
    deq = I.dequantize(torch.from_numpy(coeffs)[:, None], qz)[:, 0].numpy()
    zz = ZIGZAG.reshape(8, 8)
    wide = idct_2d_rows([[deq[:, zz[r, c]].astype(np.int64) for c in range(8)]
                         for r in range(8)])
    wide = np.clip(np.stack([wide[r][c] for r in range(8) for c in range(8)],
                            axis=-1), 0, 255)
    assert (wide != got.numpy()).mean() > 0.1  # most blocks wrap
    # And the whole decode of the stream, through the Decoder.
    assert np.array_equal(Decoder(device="cpu", exact_idct=True).decode(data),
                          golden.decode_rgb(data, idct="int"))


def test_dequant_product_in_int64_then_clamped():
    """Golden multiplies coefficient x quantizer in int64 and clamps to the
    int16 range (golden.py:286-287); the port does the same. A product past
    2**31, which an int32 multiply would wrap, saturates instead."""
    data = wrap_stream()
    img = analyze(data)
    qz = I.int_quantizers(D.qz_by_slot_array(img))
    q0 = int(qz[0, 0])
    coeffs = np.zeros((3, 64), np.int32)
    coeffs[0, 0] = (1 << 31) // q0 + 7  # product just past 2**31
    coeffs[1, 0] = -((1 << 31) // q0 + 7)
    coeffs[2, 0] = 1000  # 32,000-48,000: the clamp alone
    deq = I.dequantize(torch.from_numpy(coeffs)[:, None], qz)[:, 0, 0]
    assert deq.tolist() == [32767, -32768, min(1000 * q0, 32767)]
    prod = coeffs[:2, 0].astype(np.int64) * q0
    wrapped32 = (prod + 2**31) % 2**32 - 2**31
    assert (np.sign(wrapped32) == -np.sign(prod)).all()  # int32 flips sign
    got = I.idct_pixels_int(torch.from_numpy(coeffs)[:, None], qz)[:, 0]
    assert np.array_equal(got.numpy().astype(np.uint8),
                          golden.idct_pixels_int(coeffs, img))
    assert (got[0] == 255).all() and (got[1] == 0).all()


def test_int_quantizers_zero_past_retained(test_image):
    img = analyze(encoder.encode(test_image(16, 16), sampling="420"))
    qz = D.qz_by_slot_array(img)
    q = I.int_quantizers(qz, 32)
    assert q.dtype == torch.int32 and tuple(q.shape) == (6, 64)
    assert (q[:, 32:] == 0).all()
    assert np.array_equal(q[:, :32].numpy(), qz[:, :32])


def test_exact_wrapper_checks_its_quantizers(test_image):
    dec = Decoder(device="cpu", exact_idct=True)
    pf = dec.prepare(encoder.encode(test_image(16, 16), sampling="422"))
    rows = dec.upload(pf)
    assert pf.op.dtype == torch.int32
    with pytest.raises(ValueError, match="qz"):
        F.fused_decode_rgba_exact(rows, pf.nseg, pf.tables,
                                  pf.op.to(torch.int64), pf.geom)
