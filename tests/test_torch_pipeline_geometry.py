"""compeg_tpu_torch Decoder on the CPU against the JAX Decoder (interpret
mode) and golden, max |diff| <= 1: the 6-data-unit samplings, an odd frame
size and an RGB-ID frame. See test_torch_pipeline.py."""

import pytest

pytest.importorskip("torch")

from compeg_tpu import analyze, encoder  # noqa: E402
from test_torch_pipeline import check_against_jax_and_golden  # noqa: E402
from test_torch_smoke_vectors import rgb_ids  # noqa: E402


@pytest.mark.parametrize("sampling", ["420", "411"])
def test_decode_matches_jax_and_golden(sampling, test_image):
    data = encoder.encode(test_image(24, 40, "gradient"), sampling=sampling,
                          quality=85, restart_interval_mcus=1)
    check_against_jax_and_golden(data)


def test_odd_dimensions(test_image):
    """17x37: padding MCUs are decoded but cropped from the raster."""
    data = encoder.encode(test_image(17, 37, "gradient"), sampling="422",
                          quality=90, restart_interval_mcus=1)
    check_against_jax_and_golden(data)


def test_rgb_id_frame(test_image):
    """Components named 'R','G','B': samples are RGB, no YCbCr transform."""
    data = rgb_ids(encoder.encode(test_image(16, 24, "edges"), sampling="444",
                                  quality=90))
    assert analyze(data).color_space == "rgb"
    check_against_jax_and_golden(data)
