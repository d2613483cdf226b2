"""compeg_tpu_torch's staged tier on the CPU: ``Decoder(fused=False)`` and
``BatchDecoder(fused=False)`` (kernel K1's plain twin, then the IDCT, the
component planes, the upsampling and the colour conversion as torch ops)
against the golden decoder, the JAX package's colour functions and the JAX
``Decoder(fused=False)`` (its Pallas entropy kernel in interpret mode, two
streams), on streams encoded from seeded numpy images.

Tolerances: ``exact_idct`` byte for byte, with and without fancy upsampling;
the float IDCT inside PARITY.md's envelope against golden (max |diff| 2, at
most 1e-5 of samples off by more than 1) and within 1 of the JAX staged
decode (the f32 sums run in another order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from compeg_tpu import analyze, encoder, golden  # noqa: E402
from compeg_tpu.pipeline import Decoder as JaxDecoder  # noqa: E402
from compeg_tpu_torch import CompegError, Decoder  # noqa: E402
from compeg_tpu_torch.batch import BatchDecoder  # noqa: E402
from compeg_tpu_torch.ops import _build  # noqa: E402
from compeg_tpu_torch.ops import idct as D  # noqa: E402
from compeg_tpu_torch.pipeline import decode_frame_device  # noqa: E402
from test_torch_smoke_vectors import jax_fancy_rgb, rgb_ids  # noqa: E402

# (sampling, restart interval, height, width, retained, RGB-ID)
CASES = [(s, 1, 24, 40, 64, False)
         for s in ("422", "444", "420", "440", "411", "gray")]
CASES += [("444", None, 24, 40, 64, True), ("422", 3, 16, 48, 64, False),
          ("422", None, 16, 48, 64, False), ("420", 3, 40, 72, 64, False),
          ("422", 1, 24, 40, 32, False), ("422", 1, 17, 37, 64, False),
          ("420", 1, 17, 37, 64, False), ("420", 1, 18, 38, 64, False)]


def case_id(c):
    s, ri, h, w, r, rgb = c
    return f"{s}{'-rgbid' if rgb else ''}-ri{ri}-{h}x{w}-r{r}"


def stream(case, test_image):
    sampling, ri, h, w, _, rgb = case
    data = encoder.encode(test_image(h, w, "noise"), sampling=sampling,
                          quality=90, restart_interval_mcus=ri)
    return rgb_ids(data) if rgb else data


def envelope(got, want):
    """max |diff| and the fraction of samples off by more than 1."""
    d = np.abs(got.astype(int) - want.astype(int))
    return int(d.max()), float((d > 1).mean())


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_staged_exact_equals_golden_integer_rgb(case, test_image):
    data = stream(case, test_image)
    got = Decoder(device="cpu", fused=False, exact_idct=True,
                  retained_coefficients=case[4]).decode(data)
    want = golden.decode_rgb(data, retained_coefficients=case[4], idct="int")
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_staged_float_inside_the_envelope_and_on_the_fused_decode(
        case, test_image):
    data = stream(case, test_image)
    got = Decoder(device="cpu", fused=False,
                  retained_coefficients=case[4]).decode(data)
    mx, frac = envelope(got, golden.decode_rgb(
        data, retained_coefficients=case[4]))
    assert mx <= 2 and frac <= 1e-5
    # the same plain IDCT and the same integer colour arithmetic as the
    # fused tier's plain twin
    fused = Decoder(device="cpu", retained_coefficients=case[4]).decode(data)
    assert np.array_equal(got, fused)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_staged_fancy_equals_jax_colour_functions(case, test_image):
    """Fancy + exact byte for byte the JAX package's staged colour functions
    over golden's integer planes; fancy with the float IDCT within 1 of the
    same over golden's float planes."""
    data = stream(case, test_image)
    retained = case[4]
    img = analyze(data)
    coeffs = golden.decode_coefficients(img, dequant=False)
    got = Decoder(device="cpu", fused=False, exact_idct=True,
                  fancy_upsampling=True,
                  retained_coefficients=retained).decode(data)
    want = jax_fancy_rgb(img, golden.assemble_planes(
        img, golden.idct_pixels_int(coeffs, img, retained)))
    assert np.array_equal(got, want)
    got = Decoder(device="cpu", fused=False, fancy_upsampling=True,
                  retained_coefficients=retained).decode(data)
    want = jax_fancy_rgb(img, golden.assemble_planes(
        img, golden.idct_pixels_raw(coeffs, img, retained)))
    # one step of a sample moves a colour channel by up to 2 (113/64, 45/32)
    assert envelope(got, want)[0] <= 2
    fused = Decoder(device="cpu", fancy_upsampling=True,
                    retained_coefficients=retained).decode(data)
    assert np.array_equal(got, fused)


@pytest.mark.parametrize("knobs,tol", [
    ({}, 1),
    ({"exact_idct": True, "fancy_upsampling": True}, 0),
], ids=["float", "fancy-exact"])
def test_staged_against_the_jax_staged_decoder(knobs, tol, test_image):
    """The JAX ``Decoder(fused=False)`` with its entropy kernel in interpret
    mode: one compile per case."""
    case = (("422", 1, 24, 40, 64, False) if not knobs
            else ("420", 3, 17, 37, 64, False))
    data = stream(case, test_image)
    want = JaxDecoder(interpret=True, fused=False, **knobs).decode(data)
    got = Decoder(device="cpu", fused=False, **knobs).decode(data)
    assert got.shape == want.shape == (case[2], case[3], 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= tol


def test_result_forms_of_both_tiers(test_image):
    """decode_prepared: [H, W, 3] u8 staged, packed RGBA int32 fused, as in
    the JAX package; decode, decode_rgba, start_decode and DecodeOp take
    both."""
    data = stream(("422", 1, 24, 40, 64, False), test_image)
    staged = Decoder(device="cpu", fused=False, exact_idct=True)
    fused = Decoder(device="cpu", exact_idct=True)
    s = staged.decode_prepared(staged.prepare(data))
    f = fused.decode_prepared(fused.prepare(data))
    assert s.dtype == torch.uint8 and tuple(s.shape) == (24, 40, 3)
    assert f.dtype == torch.int32 and tuple(f.shape) == (24, 40)
    rgb = fused.decode(data)
    assert np.array_equal(staged.decode(data), rgb)
    rgba = staged.decode_rgba(data)
    assert rgba.shape == (24, 40, 4) and (rgba[..., 3] == 255).all()
    assert np.array_equal(rgba, fused.decode_rgba(data))
    op = staged.start_decode(data)
    assert op.geometry_changed and op.result.dtype == torch.uint8
    assert np.array_equal(op.block_until_ready().rgb(), rgb)
    assert not staged.start_decode(data).geometry_changed


def test_decode_frame_device_from_the_quantizers(test_image):
    """The function on its own, the operand made from ``qz_by_slot``."""
    data = stream(("420", 3, 40, 72, 64, False), test_image)
    dec = Decoder(device="cpu", fused=False)
    pf = dec.prepare(data)
    rows = dec.upload(pf)
    qz = D.qz_by_slot_array(pf.image)
    for exact in (False, True):
        for fancy in (False, True):
            for retained in (64, 32):
                want = Decoder(device="cpu", fused=False, exact_idct=exact,
                               fancy_upsampling=fancy,
                               retained_coefficients=retained).decode(data)
                got = decode_frame_device(rows, pf.nseg, pf.tables, qz,
                                          pf.geom, retained, fancy, exact)
                assert np.array_equal(got.numpy(), want)


def test_staged_zrl_compat_equals_golden(test_image):
    from test_torch_smoke_vectors import zrl_stream

    data = zrl_stream()
    got = Decoder(device="cpu", fused=False, zrl_compat=True,
                  exact_idct=True, retained_coefficients=32).decode(data)
    assert np.array_equal(got, golden.decode_rgb(
        data, retained_coefficients=32, idct="int", zrl17=True))


def test_staged_tier_counts_no_kernel_on_the_cpu(test_image):
    data = stream(("422", 1, 24, 40, 64, False), test_image)
    before = dict(_build.LAUNCHES)
    Decoder(device="cpu", fused=False).decode(data)
    BatchDecoder(device="cpu", fused=False).decode([data, data])
    assert _build.LAUNCHES == before


BATCH_KNOBS = [{}, {"exact_idct": True}, {"fancy_upsampling": True},
               {"exact_idct": True, "fancy_upsampling": True},
               {"retained_coefficients": 32}]


@pytest.mark.parametrize("knobs", BATCH_KNOBS, ids=lambda k: "-".join(k) or
                         "float")
@pytest.mark.parametrize("sampling,ri,h,w", [("422", 1, 24, 40),
                                             ("420", 5, 40, 72),
                                             ("gray", 1, 17, 37)])
def test_staged_batch_equals_its_single_frame_decodes(knobs, sampling, ri, h,
                                                      w, test_image):
    frames = [encoder.encode(test_image(h, w, "noise", seed=s),
                             sampling=sampling, quality=90,
                             restart_interval_mcus=ri) for s in range(3)]
    bdec = BatchDecoder(device="cpu", fused=False, **knobs)
    out = bdec.decode_prepared(bdec.prepare_batch(frames))
    assert out.dtype == torch.uint8 and tuple(out.shape) == (3, h, w, 3)
    got = bdec.to_rgb(out)
    assert got.shape == (3, h, w, 3) and not np.array_equal(got[0], got[1])
    dec = Decoder(device="cpu", fused=False, **knobs)
    for i, f in enumerate(frames):
        assert np.array_equal(got[i], dec.decode(f)), i
    assert np.array_equal(bdec.decode(frames), got)
    if knobs == {"exact_idct": True}:
        for i, f in enumerate(frames):
            assert np.array_equal(got[i], golden.decode_rgb(f, idct="int"))


def test_budget_counts_the_coefficients_on_the_staged_tier(test_image):
    """64 x 64 at 4:2:2: 32 MCUs of 16 x 8 pixels, 4 data units: the fused
    tiers' estimate is 32 * (512 + 256) bytes plus the scan; the staged tier
    adds K1's [nseg, ri, 4, 64] int32, 32 KB."""
    data = encoder.encode(test_image(64, 64), sampling="422",
                          restart_interval_mcus=1)
    img = analyze(data)
    fused_est = (img.total_mcus * (16 * 8 * 4 + 4 * 64) + len(img.scan_data)
                 + 4 * img.total_restart_intervals)
    coeff_bytes = img.total_restart_intervals * 1 * 4 * 64 * 4
    assert coeff_bytes == 32768
    budget = fused_est + coeff_bytes // 2
    assert Decoder(device="cpu", max_device_bytes=budget).decode(
        data).shape == (64, 64, 3)
    with pytest.raises(CompegError, match="budget"):
        Decoder(device="cpu", fused=False, max_device_bytes=budget).decode(
            data)
    assert Decoder(device="cpu", fused=False, max_device_bytes=fused_est
                   + coeff_bytes).decode(data).shape == (64, 64, 3)
    with pytest.raises(CompegError, match="budget"):
        BatchDecoder(device="cpu", fused=False,
                     max_device_bytes=budget).decode([data])
