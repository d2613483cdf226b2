"""compeg_tpu_torch on the reference's own corpus, on the CPU (the kernels'
plain twins), mirroring tests/test_ref_corpus.py's pixel tests: the 64x8
reftests against the reference's PNG ground truth at its tolerance of 3
(src/tests.rs:18), multi-segment corpus files against golden (float within
1, exact byte-identical), and the real webcam frame mjpeg.jpg with fancy +
exact within 4 of Pillow and nearest + exact equal to golden.

The corpus is mounted read-only; the tests skip where it is absent."""

import io
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from compeg_tpu import golden  # noqa: E402
from compeg_tpu_torch import Decoder  # noqa: E402
from test_ref_corpus import ABS_TOLERANCE, REFS, TI  # noqa: E402

pytestmark = pytest.mark.skipif(
    not os.path.isdir(TI), reason="reference corpus not mounted"
)


def _load(name):
    path = (os.path.join(REFS, name[len("refs-"):] + ".jpg")
            if name.startswith("refs-") else os.path.join(TI, name + ".jpg"))
    with open(path, "rb") as f:
        return f.read()


def _png_64x8():
    PIL = pytest.importorskip("PIL.Image")
    return np.asarray(
        PIL.open(os.path.join(REFS, "64x8.png")).convert("RGB")
    ).astype(int)


def _pillow(data):
    PIL = pytest.importorskip("PIL.Image")
    return np.asarray(PIL.open(io.BytesIO(data)).convert("RGB")).astype(int)


@pytest.mark.parametrize("name", ["refs-64x8-Ri-1", "refs-64x8-Ri-2"])
@pytest.mark.parametrize("retained", [32, 64])
def test_reftest_pixels(name, retained):
    got = Decoder(retained_coefficients=retained,
                  device="cpu").decode(_load(name)).astype(int)
    diff = np.abs(got - _png_64x8())
    assert diff.max() <= ABS_TOLERANCE, (name, retained, diff.max())


def test_reftest_pixels_444():
    got = Decoder(device="cpu").decode(_load("refs-64x8-Hi1-Vi1")).astype(int)
    assert np.abs(got - _png_64x8()).max() <= ABS_TOLERANCE


@pytest.mark.parametrize("name", ["restarts", "extraneous-data",
                                  "grayscale_square"])
def test_decode_matches_golden(name):
    data = _load(name)
    got = Decoder(device="cpu").decode(data).astype(int)
    assert np.abs(got - golden.decode_rgb(data).astype(int)).max() <= 1
    got_exact = Decoder(device="cpu", exact_idct=True).decode(data)
    assert np.array_equal(got_exact, golden.decode_rgb(data, idct="int"))


def test_mjpeg_decode():
    """The webcam frame (960x720 4:2:2, Ri 10, no DHT): fancy + exact within
    the colour-constant envelope of libjpeg (the BT.601 constants follow the
    reference, not libjpeg; PARITY.md), nearest + exact equal to golden."""
    data = _load("mjpeg")
    got = Decoder(device="cpu", fancy_upsampling=True,
                  exact_idct=True).decode(data).astype(int)
    assert np.abs(got - _pillow(data)).max() <= 4
    got_n = Decoder(device="cpu", exact_idct=True).decode(data)
    assert np.array_equal(got_n, golden.decode_rgb(data, idct="int"))
