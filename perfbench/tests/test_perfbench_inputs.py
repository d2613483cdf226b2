"""The benchmark's frames: valid JPEGs of the configuration's geometry,
distinct, and decoded by the plain reference as the port's CPU path
decodes them, in both configurations' modes."""

import json
import os

import numpy as np
import pytest

from perfbench.inputs import frames as F
from perfbench.reference import jpeg as R

from .small import SMALL

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def small_config(name, **kw):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        cfg = json.load(f)
    cfg.update(SMALL["config"], **kw)
    return cfg


@pytest.mark.parametrize("name", ["uvc4k_422", "cam1080_420_exact_fancy"])
def test_draws_are_distinct_valid_frames(name):
    cfg = small_config(name)
    frames = F.pool(cfg, 2**31 + 5, 4)
    assert len(set(frames)) == 4
    assert F.pool(cfg, 2**31 + 5, 4) == frames  # the seed fixes them
    assert F.pool(cfg, 2**31 + 6, 4) != frames
    for data in frames:
        f = R.parse(data)
        assert (f.width, f.height) == (cfg["width"], cfg["height"])
        assert f.ri == cfg["restart_interval_mcus"]
        # split_segments checks RST0..RST7 in order
        _, starts, _ = R.split_segments(f.scan)
        assert len(starts) == F.source(cfg).segments


def test_draws_reach_the_cells_size_from_a_smaller_base():
    cfg = small_config("uvc4k_422", width=256, height=256)
    [data] = F.pool(cfg, 3, 1)
    f = R.parse(data)
    assert (f.width, f.height) == (256, 256)
    assert R.entropy_decode(f).shape == (16 * 32, 4, 64)


@pytest.mark.parametrize("name", ["uvc4k_422", "cam1080_420_exact_fancy"])
def test_reference_agrees_with_the_ports_cpu_decode(name):
    from compeg_tpu_torch import Decoder

    cfg = small_config(name)
    rc = cfg["reference"]
    dec = Decoder(device="cpu", **cfg["decoder"])
    for data in F.pool(cfg, 11, 3):
        ref = R.decode(data, rc["idct"], rc["chroma"])
        got = dec.decode(data)
        d = np.abs(ref.astype(int) - got)
        if rc["idct"] == "islow":
            assert (d == 0).all()
        else:
            assert d.max() <= 2 and (d > 1).mean() <= 1e-5


def test_reference_float_and_islow_match_golden():
    """The float mode within golden's own +-1 of itself (here equal), the
    integer mode byte for byte, on a frame with another sampling too."""
    from compeg_tpu_torch import golden

    from perfbench.inputs.encoder import encode

    img = F.base_image(48, 80, 5)
    for sampling, ri in (("422", 1), ("420", 4), ("444", 2), ("411", 1)):
        data = encode(img, sampling=sampling, quality=85,
                      restart_interval_mcus=ri, emit_dht=False)
        assert np.array_equal(R.decode(data, "islow"),
                              golden.decode_rgb(data, idct="int"))
        d = np.abs(R.decode(data, "float").astype(int)
                   - golden.decode_rgb(data))
        assert d.max() <= 1


def test_frozen_encoder_is_the_ports():
    from compeg_tpu_torch.encoder import encode as port_encode

    from perfbench.inputs.encoder import encode

    img = F.base_image(40, 72, 9)
    for sampling in ("422", "420"):
        for dht in (True, False):
            kw = dict(sampling=sampling, quality=85,
                      restart_interval_mcus=2, emit_dht=dht)
            assert encode(img, **kw) == port_encode(img, **kw)


def test_reference_rejects_markers_out_of_order():
    cfg = small_config("uvc4k_422")
    [data] = F.pool(cfg, 1, 1)
    i = data.index(b"\xff\xd1")
    bad = data[:i] + b"\xff\xd3" + data[i + 2:]
    with pytest.raises(R.JpegError):
        R.decode(bad)
