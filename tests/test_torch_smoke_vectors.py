"""The reference data of chip_smoke.py, compeg_tpu_torch/testdata/smoke.npz.

chip_smoke.py runs on the card and imports nothing of the JAX package, so
golden's answers travel to it in this file: small streams of every supported
sampling with golden's raw coefficients and RGB, and, for the 4K benchmark
frame, digests of golden's coefficients and RGB plus three of golden's MCU
rows of RGB. These tests recompute all of it with compeg_tpu's encoder and
golden decoder and must find the file's contents; the plain PyTorch K1 must
reproduce the stored coefficients exactly.

After changing a case, rewrite the file with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_smoke_vectors.py
"""

import hashlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from compeg_tpu import analyze, encoder, golden  # noqa: E402
from compeg_tpu_torch import testdata  # noqa: E402
from compeg_tpu_torch.ops import entropy as E  # noqa: E402
from compeg_tpu_torch.pipeline import Decoder  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench_assets", "bench4k.jpg")
# First pixel row of three 4:2:2 MCU rows of the 4K frame (8 rows each):
# the top, the middle and the bottom of the picture.
BENCH_MCU_ROWS = (0, 1080, 2152)


def smoke_image(h, w, seed=0):
    """Gradient plus noise, so every stream has real AC content."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                    (xx + yy) * 255 // max(h + w - 2, 1)], axis=-1)
    img = img + rng.integers(-40, 41, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def rgb_ids(data: bytes) -> bytes:
    """Rename a 3-component frame's components to 'R','G','B' in SOF0 and
    SOS, which makes it an RGB-ID frame (no YCbCr transform)."""
    buf = bytearray(data)
    for marker, first, stride in ((b"\xff\xc0", 8, 3), (b"\xff\xda", 3, 2)):
        at = buf.find(marker) + 2
        for i, cid in enumerate(b"RGB"):
            buf[at + first + i * stride] = cid
    return bytes(buf)


# (label, sampling, restart interval, height, width, retained, RGB-ID)
CASES = [(f"{s} ri=1 24x40", s, 1, 24, 40, 64, False)
         for s in ("422", "444", "420", "440", "411", "gray")]
# 16x48 at 4:2:2 is 3 MCU columns: Ri 2 and 5 wrap MCU rows and end short.
CASES += [(f"422 ri={ri} 16x48", "422", ri, 16, 48, 64, False)
          for ri in (2, 5, None)]
CASES += [("422 ri=1 17x37", "422", 1, 17, 37, 64, False),
          ("420 ri=3 40x72", "420", 3, 40, 72, 64, False),
          ("444 RGB-ID 24x40", "444", None, 24, 40, 64, True),
          ("422 ri=1 24x40 retained=32", "422", 1, 24, 40, 32, False)]


def case_stream(i: int) -> bytes:
    _, sampling, ri, h, w, _, rgb = CASES[i]
    data = encoder.encode(smoke_image(h, w), sampling=sampling,
                          quality=90, restart_interval_mcus=ri)
    return rgb_ids(data) if rgb else data


def case_vectors(i: int) -> dict:
    data = case_stream(i)
    retained = CASES[i][5]
    return {
        f"jpeg_{i}": np.frombuffer(data, np.uint8),
        f"coeffs_{i}": golden.decode_coefficients(analyze(data), dequant=False),
        f"rgb_{i}": golden.decode_rgb(data, retained_coefficients=retained),
    }


def bench4k_vectors() -> dict:
    with open(BENCH, "rb") as f:
        data = f.read()
    coeffs = golden.decode_coefficients(analyze(data), dequant=False)
    rgb = golden.decode_rgb(data)
    rows = np.concatenate([np.arange(r, r + 8) for r in BENCH_MCU_ROWS])
    return {
        "bench4k_jpeg_sha256": np.array(hashlib.sha256(data).hexdigest()),
        "bench4k_coeffs_sha256": np.array(testdata.digest(coeffs)),
        "bench4k_rgb_sha256": np.array(testdata.digest(rgb)),
        "bench4k_rows": rows.astype(np.int32),
        "bench4k_rgb_rows": rgb[rows],
    }


def write_vectors(path: str = testdata.PATH) -> None:
    arrays = {
        "labels": np.array([c[0] for c in CASES]),
        "retained": np.array([c[5] for c in CASES], np.int32),
    }
    for i in range(len(CASES)):
        arrays.update(case_vectors(i))
    arrays.update(bench4k_vectors())
    np.savez_compressed(path, **arrays)


@pytest.fixture(scope="module")
def stored():
    return testdata.load()


@pytest.mark.parametrize("i", range(len(CASES)), ids=[c[0] for c in CASES])
def test_stream_vectors_are_golden(i, stored):
    assert str(stored["labels"][i]) == CASES[i][0]
    assert int(stored["retained"][i]) == CASES[i][5]
    for key, want in case_vectors(i).items():
        assert stored[key].dtype == want.dtype, key
        assert np.array_equal(stored[key], want), key


@pytest.mark.parametrize("i", range(len(CASES)), ids=[c[0] for c in CASES])
def test_plain_k1_reproduces_stored_coefficients(i, stored):
    """What chip_smoke holds K1 to on the card, here through the plain K1."""
    dec = Decoder(device="cpu")
    pf = dec.prepare(stored[f"jpeg_{i}"].tobytes())
    g = pf.geom
    out = E.entropy_decode(dec.upload(pf), pf.nseg, pf.tables, g.ri,
                           g.total_mcus, g.du_to_comp)
    got = E.coefficients_natural_order(out, g.total_mcus).numpy()
    assert np.array_equal(got, stored[f"coeffs_{i}"])


def test_bench4k_vectors_are_golden(stored):
    """The 4K frame's golden decode on the CPU (about 16 s, 0.8 GB)."""
    want = bench4k_vectors()
    for key in ("bench4k_jpeg_sha256", "bench4k_coeffs_sha256",
                "bench4k_rgb_sha256"):
        assert str(stored[key]) == str(want[key]), key
    assert np.array_equal(stored["bench4k_rows"], want["bench4k_rows"])
    assert np.array_equal(stored["bench4k_rgb_rows"], want["bench4k_rgb_rows"])


if __name__ == "__main__":
    write_vectors()
    print(f"wrote {testdata.PATH} ({os.path.getsize(testdata.PATH)} B)")
