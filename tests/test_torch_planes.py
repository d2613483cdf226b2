"""compeg_tpu_torch's planes path on the CPU (kernel K3's plain twin and the
torch epilogue of ops/color.py): ``decode_ycbcr``, fancy upsampling and
``planes_epilogue``, against the golden decoder, the JAX package's staged
colour functions and the JAX Decoder (Pallas, interpret mode).

Tolerances: integer paths exact; ``decode_ycbcr`` with the float IDCT
within 1 of golden's float planes (the f32 sum order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from compeg_tpu import analyze, encoder, golden  # noqa: E402
from compeg_tpu.ops import color as JC  # noqa: E402
from compeg_tpu.pipeline import Decoder as JaxDecoder  # noqa: E402
from compeg_tpu_torch import Decoder  # noqa: E402
from compeg_tpu_torch.batch import BatchDecoder  # noqa: E402
from compeg_tpu_torch.ops import _build  # noqa: E402
from compeg_tpu_torch.ops import color as C  # noqa: E402
from test_torch_smoke_vectors import (golden_planes, jax_fancy_rgb,  # noqa: E402
                                      rgb_ids, ycbcr_crops)

# (sampling, restart interval, height, width, retained, RGB-ID)
CASES = [(s, 1, 24, 40, 64, False)
         for s in ("422", "444", "420", "440", "411", "gray")]
CASES += [("444", 1, 24, 40, 64, True), ("422", 2, 16, 48, 64, False),
          ("422", None, 16, 48, 64, False), ("422", 1, 24, 40, 32, False),
          ("420", 1, 17, 37, 64, False)]


def case_id(c):
    s, ri, h, w, r, rgb = c
    return f"{s}{'-rgbid' if rgb else ''}-ri{ri}-{h}x{w}-r{r}"


def stream(case, test_image):
    sampling, ri, h, w, _, rgb = case
    data = encoder.encode(test_image(h, w, "noise"), sampling=sampling,
                          quality=90, restart_interval_mcus=ri)
    return rgb_ids(data) if rgb else data


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_ycbcr_planes_equal_golden(case, test_image):
    data = stream(case, test_image)
    retained = case[4]
    img = analyze(data)
    coeffs = golden.decode_coefficients(img, dequant=False)
    # Integer IDCT: byte-identical to golden's integer planes.
    got = Decoder(device="cpu", exact_idct=True,
                  retained_coefficients=retained).decode_ycbcr(data)
    want = golden_planes(img, golden.idct_pixels_int(coeffs, img, retained))
    assert [p.shape for p in got] == ycbcr_crops(img)
    for p, q in zip(got, want):
        assert p.dtype == np.uint8 and np.array_equal(p, q)
    # Float IDCT: within 1 of golden's float planes.
    got = Decoder(device="cpu",
                  retained_coefficients=retained).decode_ycbcr(data)
    want = golden_planes(img, golden.idct_pixels_raw(coeffs, img, retained))
    for p, q in zip(got, want):
        assert np.abs(p.astype(int) - q.astype(int)).max() <= 1


@pytest.mark.parametrize("sampling,h,w", [
    ("422", 24, 40), ("420", 24, 40), ("440", 24, 40), ("411", 24, 40),
    ("422", 17, 37), ("420", 17, 37), ("440", 17, 37), ("420", 18, 38)])
def test_fancy_equals_jax_staged_functions(sampling, h, w, test_image):
    """Fancy + exact: byte-identical to compeg_tpu.ops.color's
    upsample_fancy_v/h + ycbcr_to_rgb over golden's integer planes, which
    filter the MCU-padded planes and crop afterwards."""
    data = encoder.encode(test_image(h, w, "noise"), sampling=sampling,
                          quality=90, restart_interval_mcus=1)
    img = analyze(data)
    planes = golden.assemble_planes(img, golden.idct_pixels_int(
        golden.decode_coefficients(img, dequant=False), img))
    got = Decoder(device="cpu", exact_idct=True,
                  fancy_upsampling=True).decode(data)
    assert np.array_equal(got, jax_fancy_rgb(img, planes))


def test_fancy_clamps_at_the_padded_edge_not_the_image_edge(test_image):
    """At 18x38 4:2:0 the filter's last row and column differ between
    clamping at the MCU-padded plane's edge (the JAX package's choice) and
    at the cropped image's edge; the port clamps at the padded edge. (An
    odd size such as 17x37 ends on an even output sample, which reads only
    its upper or left neighbour, so there the two agree.)"""
    data = encoder.encode(test_image(18, 38, "noise"), sampling="420",
                          quality=90, restart_interval_mcus=1)
    img = analyze(data)
    planes = golden.assemble_planes(img, golden.idct_pixels_int(
        golden.decode_coefficients(img, dequant=False), img))
    cropped = [p[:h, :w] for p, (h, w) in zip(planes, ycbcr_crops(img))]
    got = Decoder(device="cpu", exact_idct=True,
                  fancy_upsampling=True).decode(data)
    assert np.array_equal(got, jax_fancy_rgb(img, planes))
    assert not np.array_equal(got, jax_fancy_rgb(img, cropped))


def test_fancy_equals_jax_kernel(test_image):
    """One stream through the JAX package's K3 + fancy epilogue
    (interpret mode)."""
    data = encoder.encode(test_image(16, 32, "noise"), sampling="420",
                          quality=90, restart_interval_mcus=1)
    got = Decoder(device="cpu", exact_idct=True,
                  fancy_upsampling=True).decode(data)
    want = JaxDecoder(interpret=True, exact_idct=True,
                      fancy_upsampling=True).decode(data)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("sampling", ["422", "420", "444", "440", "411"])
def test_composite_matches_planes_epilogue(sampling, test_image):
    """Nearest upsampling through K3 + the epilogue equals K2's in-kernel
    composite bit for bit (tests/test_pipeline.py's pin)."""
    data = encoder.encode(test_image(24, 48, "noise"), sampling=sampling,
                          quality=88, restart_interval_mcus=1)
    a = Decoder(device="cpu").decode(data)
    b = Decoder(device="cpu", planes_epilogue=True).decode(data)
    assert np.array_equal(a, b)


def test_fancy_ignores_planes_epilogue_false(test_image):
    """Fancy takes the planes path whatever planes_epilogue says, like the
    JAX package's fused fancy path."""
    data = encoder.encode(test_image(24, 48, "noise"), sampling="422",
                          quality=88, restart_interval_mcus=1)
    a = Decoder(device="cpu", fancy_upsampling=True,
                planes_epilogue=False).decode(data)
    b = Decoder(device="cpu", fancy_upsampling=True).decode(data)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, Decoder(device="cpu").decode(data))


def test_routing_counts_no_kernel_on_the_cpu(test_image):
    """On CPU tensors every path takes its plain twin: no launch counted,
    the planes epilogue E's included, a fancy batch's too."""
    data = encoder.encode(test_image(16, 32), sampling="420")
    assert "epilogue" in _build.LAUNCHES
    before = dict(_build.LAUNCHES)
    Decoder(device="cpu", fancy_upsampling=True).decode(data)
    Decoder(device="cpu", planes_epilogue=True).decode(data)
    Decoder(device="cpu", exact_idct=True).decode_ycbcr(data)
    BatchDecoder(device="cpu", fancy_upsampling=True).decode([data] * 2)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("fy", [1, 2])
@pytest.mark.parametrize("fx", [1, 2, 4])
@pytest.mark.parametrize("fancy", [False, True])
def test_upsample_equals_jax(fx, fy, fancy):
    """ops/color.upsample against compeg_tpu.ops.color on random planes."""
    p = np.random.default_rng(fx * 10 + fy).integers(0, 256, (6, 10))
    got = C.upsample(torch.from_numpy(p).to(torch.int32), fx, fy, fancy)
    q = jnp.asarray(p, jnp.int32)
    if fancy:
        q = JC.upsample_fancy_v(q) if fy > 1 else q
        q = (JC.upsample_fancy_h(q) if fx == 2
             else JC.upsample_nearest(q, fx, 1))
    else:
        q = JC.upsample_nearest(q, fx, fy)
    assert np.array_equal(got.numpy(), np.asarray(q))
