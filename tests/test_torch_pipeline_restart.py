"""compeg_tpu_torch Decoder on the CPU against the JAX Decoder (interpret
mode) and golden, max |diff| <= 1: restart intervals that leave a short final
segment or none at all, and the ``retained_coefficients`` knob. See
test_torch_pipeline.py."""

import pytest

pytest.importorskip("torch")

from compeg_tpu import encoder  # noqa: E402
from test_torch_pipeline import check_against_jax_and_golden  # noqa: E402


@pytest.mark.parametrize("ri", [2, 5, None])
def test_restart_intervals(ri, test_image):
    """16x48 at 4:2:2 is 3x2 MCUs: Ri 2 and 5 wrap MCU rows and end short."""
    data = encoder.encode(test_image(16, 48, "edges"), sampling="422",
                          quality=80, restart_interval_mcus=ri)
    check_against_jax_and_golden(data)


def test_retained_32(test_image):
    data = encoder.encode(test_image(16, 32, "gradient"), sampling="422",
                          quality=85)
    check_against_jax_and_golden(data, retained=32)
