"""compeg_tpu_torch's CUDA kernels against their plain PyTorch versions and
the golden decoder on small streams: K1 (entropy) exactly, K2 (fused decode)
within 1, the f32 IDCT summing in another order. These need a CUDA device
and nvcc (the kernels have no CPU mode) and skip without one;
``python3 chip_smoke.py`` runs the same checks and the 4K frame on the card.

What the CPU can check of the kernels' interface runs here: the launch
parameter block matches the C struct, and a CPU tensor takes the plain
version."""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from compeg_tpu import encoder, golden  # noqa: E402
from compeg_tpu_torch.ops import _build  # noqa: E402
from compeg_tpu_torch.ops import entropy as E  # noqa: E402
from compeg_tpu_torch.ops import fused as F  # noqa: E402
from compeg_tpu_torch.pipeline import Decoder  # noqa: E402

CASES = [("422", 1), ("444", 1), ("420", 1), ("440", 1), ("411", 1),
         ("gray", 1), ("422", 2), ("422", 5), ("422", None)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def prepared(device, sampling, ri, test_image, h=24, w=40):
    data = encoder.encode(test_image(h, w, "noise"), sampling=sampling,
                          quality=90, restart_interval_mcus=ri)
    dec = Decoder(device=device)
    pf = dec.prepare(data)
    return data, pf, dec.upload(pf)


@pytest.mark.parametrize("sampling,ri", CASES)
def test_k1_equals_plain_and_golden(cuda, sampling, ri, test_image):
    data, pf, rows = prepared(cuda, sampling, ri, test_image)
    g = pf.geom
    args = (rows, pf.nseg, pf.tables, g.ri, g.total_mcus, g.du_to_comp)
    before = _build.LAUNCHES["entropy"]
    got = E.entropy_decode(*args)
    assert _build.LAUNCHES["entropy"] == before + 1
    assert torch.equal(got, E.entropy_decode_reference(*args))
    want = golden.decode_coefficients(pf.image, dequant=False)
    assert np.array_equal(
        E.coefficients_natural_order(got, g.total_mcus).cpu().numpy(), want)


@pytest.mark.parametrize("sampling,ri", CASES)
def test_k2_within_one_of_plain(cuda, sampling, ri, test_image):
    data, pf, rows = prepared(cuda, sampling, ri, test_image, h=17, w=37)
    args = (rows, pf.nseg, pf.tables, pf.lq_t, pf.geom)
    before = _build.LAUNCHES["fused"]
    got = F.fused_decode_rgba(*args)
    assert _build.LAUNCHES["fused"] == before + 1
    want = F.fused_decode_rgba_reference(*args)
    got_rgba = got.cpu().numpy().view(np.uint8).reshape(17, 37, 4)
    want_rgba = want.cpu().numpy().view(np.uint8).reshape(17, 37, 4)
    assert np.abs(got_rgba.astype(int) - want_rgba.astype(int)).max() <= 1
    assert (got_rgba[..., 3] == 255).all()
    gold = golden.decode_rgb(data)
    assert np.abs(got_rgba[..., :3].astype(int) - gold.astype(int)).max() <= 1


def test_params_mirror_the_c_struct():
    """The ctypes block must list the C struct's fields in order: a
    mismatch would misread every launch parameter on the card."""
    path = os.path.join(_build.CSRC, "entropy.cuh")
    with open(path) as f:
        body = re.search(r"struct DecodeParams \{(.*?)\};", f.read(), re.S)[1]
    c_fields = re.findall(r"^\s*int (\w+)(?:\[(\d+)\])?;", body, re.M)
    py_fields = [(n, getattr(t, "_length_", 1)) for n, t in
                 _build.DecodeParams._fields_]
    assert [(n, int(k or 1)) for n, k in c_fields] == py_fields


def test_params_layout_of_420():
    p = _build.make_params(7, 3, 2, 13, (0, 0, 0, 0, 1, 2),
                           samplings=((2, 2), (1, 1), (1, 1)), width=40,
                           height=24, width_mcus=3)
    assert (p.dus, p.ncomp) == (6, 3)
    assert list(p.comp_slot) == [0, 4, 5]
    assert list(p.du_to_comp) == [0, 0, 0, 0, 1, 2]
    with pytest.raises(ValueError):
        _build.make_params(1, 1, 1, 1, (0,) * 7, samplings=((1, 1),))


def test_cpu_tensors_take_the_plain_version(test_image):
    data, pf, rows = prepared("cpu", "422", 2, test_image)
    args = (rows, pf.nseg, pf.tables, pf.lq_t, pf.geom)
    before = dict(_build.LAUNCHES)
    assert torch.equal(F.fused_decode_rgba(*args),
                       F.fused_decode_rgba_reference(*args))
    assert _build.LAUNCHES == before  # no kernel launched


def test_wrappers_check_their_inputs(test_image):
    data, pf, rows = prepared("cpu", "422", 1, test_image)
    g = pf.geom
    with pytest.raises(ValueError, match="int32"):
        E.entropy_decode(rows.to(torch.int64), pf.nseg, pf.tables, g.ri,
                         g.total_mcus, g.du_to_comp)
    with pytest.raises(ValueError, match="fewer than"):
        E.entropy_decode(rows[:1], pf.nseg, pf.tables, g.ri, g.total_mcus,
                         g.du_to_comp)
    with pytest.raises(ValueError, match="lq_t"):
        F.fused_decode_rgba(rows, pf.nseg, pf.tables, pf.lq_t[:1], g)
