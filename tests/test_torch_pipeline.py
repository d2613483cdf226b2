"""compeg_tpu_torch Decoder on the CPU (the kernels' plain versions) against
the JAX Decoder (fused Pallas kernel, interpret mode) and the golden decoder.

Pixels may differ by 1 between the three, the bound of
tests/test_pipeline.py: the f32 IDCT sums in another order in each. The
integer stages (coefficients, upsampling, colour) are exact.

The sampling, geometry and restart-interval cases are spread over this file
and test_torch_pipeline_geometry.py / test_torch_pipeline_restart.py, because
each JAX decode compiles its kernel anew (10-25 s on the CPU)."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from compeg_tpu import encoder, golden  # noqa: E402
from compeg_tpu.pipeline import Decoder as JaxDecoder  # noqa: E402
from compeg_tpu_torch import CompegError, Decoder, decode_rgb  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_close(got, want, tol=1):
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= tol, (diff.max(), np.argwhere(diff > tol)[:5])


def check_against_jax_and_golden(data: bytes, retained: int = 64):
    got = Decoder(retained_coefficients=retained, device="cpu").decode_rgba(data)
    jax_rgba = JaxDecoder(retained_coefficients=retained,
                          interpret=True).decode_rgba(data)
    assert got.dtype == np.uint8 and (got[..., 3] == 255).all()
    assert_close(got, jax_rgba)
    assert_close(got[..., :3], golden.decode_rgb(data, retained_coefficients=retained))


@pytest.mark.parametrize("sampling", ["422", "444", "gray", "440"])
def test_decode_matches_jax_and_golden(sampling, test_image):
    data = encoder.encode(test_image(24, 40, "gradient"), sampling=sampling,
                          quality=85, restart_interval_mcus=1)
    check_against_jax_and_golden(data)


def test_float_decode_equals_jax_where_golden_rounds_the_other_way():
    """tools/tpu_validate.py's 4:2:0, Ri = 5, q = 85, 96 x 128 stream, where
    the float decode is 2 off golden's matrix IDCT at four samples
    (tests/test_torch_validation.py): the port's decode equals the JAX
    package's there, and both equal the reference's AAN arithmetic."""
    from compeg_tpu_torch.tools import validate

    name, data = validate.streams(0)[6]
    assert name == "420 ri=5 q=85 96x128"
    got = Decoder(device="cpu").decode(data)
    assert np.array_equal(got, JaxDecoder(interpret=True).decode(data))
    assert np.array_equal(got, golden.decode_rgb(data, idct="aan"))


def test_decoder_reuse_across_frames_hits_header_cache(test_image):
    dec = Decoder(device="cpu")
    hdr = None
    for seed in range(3):
        data = encoder.encode(test_image(16, 32, "noise", seed=seed),
                              sampling="422", quality=80,
                              restart_interval_mcus=1)
        assert_close(dec.decode(data), golden.decode_rgb(data))
        if hdr is None:
            hdr = dec._hdr_cache
        # Same quality and geometry: byte-identical headers, one cache entry.
        assert dec._hdr_cache is hdr


def test_python_packer_without_the_native_library(monkeypatch, test_image):
    """Without the port's native library the scan is packed by the Python
    twin (scan.split_intervals), header-cache hits included."""
    from compeg_tpu_torch import native

    monkeypatch.setattr(native, "available", lambda: False)
    dec = Decoder(device="cpu")
    for seed in range(2):
        data = encoder.encode(test_image(16, 48, "noise", seed=seed),
                              sampling="420", restart_interval_mcus=2)
        pf = dec.prepare(data)
        assert pf.packer == "python"
        assert_close(dec.decode(data), golden.decode_rgb(data))


def test_start_decode_reports_geometry_changes(test_image):
    dec = Decoder(device="cpu")
    small = encoder.encode(test_image(16, 32), sampling="422")
    large = encoder.encode(test_image(24, 40), sampling="422")
    ops = [dec.start_decode(d) for d in (small, small, large)]
    assert [op.geometry_changed for op in ops] == [True, False, True]
    assert ops[2].geometry.width == 40 and ops[2].geometry.height == 24
    op = ops[2].block_until_ready()
    assert_close(op.rgb(), golden.decode_rgb(large))
    # DLPack hands over the packed RGBA words without a copy.
    assert torch.equal(torch.from_dlpack(op), op.result)


def test_truncated_stream_raises_interval_count(test_image):
    data = encoder.encode(test_image(32, 64), sampling="422",
                          restart_interval_mcus=1)
    cut = data[: len(data) * 2 // 3] + b"\xFF\xD9"
    with pytest.raises(CompegError, match=r"scan contains \d+ restart "
                                          r"intervals, expected \d+"):
        Decoder(device="cpu").decode(cut)


def test_device_budget_raises(test_image):
    data = encoder.encode(test_image(64, 64), sampling="422")
    with pytest.raises(CompegError, match="budget"):
        Decoder(device="cpu", max_device_bytes=1024).decode(data)


def test_fused_false_takes_the_staged_tier(test_image):
    """fused=False is the staged tier: [H, W, 3] u8 from decode_prepared,
    the same picture from decode (tests/test_torch_staged.py has the
    parity)."""
    data = encoder.encode(test_image(24, 40), sampling="422",
                          restart_interval_mcus=1)
    dec = Decoder(device="cpu", fused=False)
    out = dec.decode_prepared(dec.prepare(data))
    assert out.dtype == torch.uint8 and tuple(out.shape) == (24, 40, 3)
    assert np.array_equal(dec.decode(data), out.numpy())
    assert Decoder(device="cpu").fused is True  # the default


def test_unknown_knob_is_refused():
    with pytest.raises(TypeError):
        Decoder(device="cpu", interpret=True)


def test_cuda_decoder_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        Decoder()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        decode_rgb(b"")


def test_port_imports_no_jax():
    """A fresh interpreter decodes on the CPU through compeg_tpu_torch
    without ever importing jax: the default, an exact, a planes (fancy and
    decode_ycbcr) and a scaled decode."""
    code = (
        "import sys, numpy as np\n"
        "import compeg_tpu_torch as T\n"
        "from compeg_tpu import encoder, golden\n"
        "img = (np.arange(16 * 24 * 3) % 251).astype(np.uint8)"
        ".reshape(16, 24, 3)\n"
        "data = encoder.encode(img, sampling='420', restart_interval_mcus=1)\n"
        "got = T.Decoder(device='cpu').decode(data)\n"
        "exact = T.Decoder(device='cpu', exact_idct=True).decode(data)\n"
        "fancy = T.Decoder(device='cpu', fancy_upsampling=True).decode(data)\n"
        "planes = T.Decoder(device='cpu').decode_ycbcr(data)\n"
        "thumb = T.Decoder(device='cpu').decode_scaled(data, 2)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert [p.shape for p in planes] == [(16, 24), (8, 12), (8, 12)]\n"
        "assert thumb.shape == (4, 6, 3) and fancy.shape == (16, 24, 3)\n"
        # golden's integer IDCT is jax-free; its float IDCT is not
        "assert np.array_equal(exact, golden.decode_rgb(data, idct='int'))\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        # golden's float IDCT imports compeg_tpu.ops.idct, which imports jax
        "d = np.abs(got.astype(int) - golden.decode_rgb(data).astype(int))\n"
        "assert d.max() <= 1, d.max()\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "ok"
