"""CPU mirrors of the JAX package's robustness, geometry-soak and reftest
cases for the port, on ``device="cpu"`` (the plain versions of the kernels)
and the port's own golden decoder and encoder, a few cases each; and the
validation tool (compeg_tpu_torch/tools/validate.py) end to end on the CPU.
The same checks run on the card's compiled kernels through
``python -m compeg_tpu_torch.tools.validate`` (chip_smoke.py phase j)."""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from compeg_tpu_torch import (  # noqa: E402
    CompegError, Decoder, analyze, encoder, golden, metadata)
from compeg_tpu_torch.tools import validate  # noqa: E402

CPU = "cpu"


def small(test_image, sampling="422", ri=1, h=16, w=32, quality=80):
    return encoder.encode(test_image(h, w), sampling=sampling,
                          quality=quality, restart_interval_mcus=ri)


# -- tests/test_robustness.py -------------------------------------------------


def test_fuzz_header_single_byte_mutations_then_decode(test_image, rng):
    """tests/test_robustness.py:159-176, and the decode the JAX test leaves
    out: a mutated header either fails to parse with CompegError or decodes
    to its own shape or fails with CompegError, through one Decoder that
    sees every mutation in turn (its header cache must notice each)."""
    data = small(test_image)
    hdr_len = analyze(data).scan_offset
    dec = Decoder(device=CPU)
    outcomes = {"refused": 0, "decoded": 0, "error": 0}
    for _ in range(60):
        pos = int(rng.integers(0, hdr_len))
        bad = data[:pos] + bytes([int(rng.integers(0, 256))]) + data[pos + 1:]
        try:
            head = analyze(bad)
        except CompegError:
            outcomes["refused"] += 1
            continue
        try:
            out = dec.decode(bad)
        except CompegError:
            outcomes["error"] += 1
            continue
        assert out.shape == (head.height, head.width, 3) and out.dtype == \
            np.uint8, pos
        outcomes["decoded"] += 1
    assert outcomes["refused"] and outcomes["decoded"], outcomes
    assert dec.decode(data).shape == (16, 32, 3)


def test_fuzz_scan_byte_mutations(test_image, rng):
    """tests/test_robustness.py:178-197: random scan-byte mutations give an
    image of the right shape or CompegError, on the float and the exact
    decode; the clean stream still decodes like golden afterwards."""
    data = small(test_image, ri=2)
    img = analyze(data)
    off = img.scan_offset
    decs = [Decoder(device=CPU), Decoder(device=CPU, exact_idct=True)]
    for i in range(16):
        scan = bytearray(img.scan_data)
        for _ in range(int(rng.integers(1, 6))):
            scan[int(rng.integers(0, len(scan)))] = int(rng.integers(0, 256))
        bad = data[:off] + bytes(scan) + data[off + len(img.scan_data):]
        try:
            out = decs[i % 2].decode(bad)
            assert out.shape == (16, 32, 3)
        except CompegError:
            pass
    assert np.array_equal(decs[1].decode(data),
                          golden.decode_rgb(data, idct="int"))


def test_not_a_jpeg():
    dec = Decoder(device=CPU)
    for junk in (b"not a jpeg at all", b"\xFF\xD8\xFF\xD9", b""):
        with pytest.raises(CompegError):
            dec.decode(junk)


def test_scan_component_order_mismatch_rejected(test_image):
    data = small(test_image)
    i = data.find(b"\xff\xda")
    assert data[i + 4] == 3
    b = bytearray(data)
    p = i + 5
    b[p:p + 2], b[p + 2:p + 4] = data[p + 2:p + 4], data[p:p + 2]
    for use_native in (True, False):
        with pytest.raises(CompegError, match="order"):
            metadata.analyze(bytes(b), use_native=use_native)
    with pytest.raises(CompegError, match="order"):
        Decoder(device=CPU).decode(bytes(b))


def test_scan_component_count_mismatch_rejected(test_image):
    data = small(test_image)
    i = data.find(b"\xff\xda")
    ln = (data[i + 2] << 8) | data[i + 3]
    nl = ln - 2
    b = (data[:i + 2] + bytes([nl >> 8, nl & 0xFF, 2]) + data[i + 5:i + 9]
         + data[i + 2 + ln - 3:])
    for use_native in (True, False):
        with pytest.raises(CompegError, match="count"):
            metadata.analyze(bytes(b), use_native=use_native)
    with pytest.raises(CompegError, match="count"):
        Decoder(device=CPU).decode(bytes(b))


def test_restart_interval_cap():
    """More than 64 * 65535 restart intervals bail, as the reference does
    (src/lib.rs:295-298): a 65500 x 65500 4:2:2 header at Ri = 1."""
    sof = bytes([0xFF, 0xC0, 0, 17, 8, 0xFF, 0xDC, 0xFF, 0xDC, 3,
                 1, 0x21, 0, 2, 0x11, 0, 3, 0x11, 0])
    dri = bytes([0xFF, 0xDD, 0, 4, 0, 1])
    dqt = bytes([0xFF, 0xDB, 0, 67, 0]) + bytes([1] * 64)
    sos = bytes([0xFF, 0xDA, 0, 12, 3, 1, 0, 2, 0x11, 3, 0x11, 0, 63, 0])
    data = b"\xff\xd8" + dqt + sof + dri + sos + b"\x00" + b"\xff\xd9"
    with pytest.raises(CompegError, match="restart intervals"):
        analyze(data)
    with pytest.raises(CompegError, match="restart intervals"):
        Decoder(device=CPU).decode(data)


def test_device_budget_cap(test_image):
    data = small(test_image)
    for knobs in ({}, {"fused": False}):
        with pytest.raises(CompegError, match="budget"):
            Decoder(device=CPU, max_device_bytes=1024, **knobs).prepare(data)
    # A header mutated to a larger frame parses where the scan is one
    # interval (no DRI), and the budget refuses it before any allocation.
    data = small(test_image, ri=None)
    i = data.find(b"\xff\xc0")
    big = bytearray(data)
    big[i + 5:i + 9] = bytes([0x7F, 0xF0, 0x7F, 0xF0])  # 32752 x 32752
    assert analyze(bytes(big)).height == 32752
    with pytest.raises(CompegError, match="budget"):
        Decoder(device=CPU, max_device_bytes=64 << 20).decode(bytes(big))


def test_ff00_marker_outside_scan_rejected(test_image):
    data = small(test_image)
    b = data[:2] + b"\xff\x00" + data[2:]
    for use_native in (True, False):
        with pytest.raises(CompegError, match="0x00"):
            metadata.analyze(bytes(b), use_native=use_native)


# -- tests/test_geometry_soak.py ----------------------------------------------


GEOMETRIES = validate.grid(4, seed=7)  # test_geometry_soak's exact subset


@pytest.mark.parametrize("h,w,sampling,quality,ri", GEOMETRIES)
def test_geometry_soak_float_and_exact(h, w, sampling, quality, ri,
                                       test_image):
    """Odd sizes x samplings x restart intervals: the float decode within 1
    of golden and the exact decode byte for byte."""
    img = test_image(h, w, "noise", seed=h * 1000 + w)
    data = encoder.encode(img, sampling=sampling, quality=quality,
                          restart_interval_mcus=ri)
    got = Decoder(device=CPU).decode(data)
    want = golden.decode_rgb(data)
    assert got.shape == want.shape == (h, w, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert np.array_equal(Decoder(device=CPU, exact_idct=True).decode(data),
                          golden.decode_rgb(data, idct="int"))


# -- tests/test_reftests.py ---------------------------------------------------


def ref_image():
    """A 64 x 8 gradient with detail, like the reference's 64x8.png."""
    yy, xx = np.mgrid[0:8, 0:64]
    img = np.stack([xx * 4, 255 - xx * 2 - yy * 8, (xx * 3 + yy * 11) % 256],
                   axis=-1).astype(np.uint8)
    img[3:5, 20:24] = [255, 0, 0]
    return img


@pytest.mark.parametrize("sampling,ri", [("422", 1), ("422", 2),
                                         ("444", 1)])
def test_reftest_64x8(sampling, ri):
    data = encoder.encode(ref_image(), sampling=sampling, quality=90,
                          restart_interval_mcus=ri)
    got = Decoder(device=CPU).decode(data)
    assert np.abs(got.astype(int)
                  - golden.decode_rgb(data).astype(int)).max() <= 1
    try:
        from PIL import Image
    except ImportError:
        return  # libjpeg's view is a bonus; golden's is the contract
    theirs = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    if sampling == "444":
        assert np.abs(got.astype(int) - theirs.astype(int)).max() <= 3
    else:  # nearest against libjpeg's fancy chroma: compare by PSNR
        mse = np.mean((got.astype(float) - theirs.astype(float)) ** 2)
        assert 10 * np.log10(255.0 ** 2 / mse) > 28, mse


# -- the validation tool ------------------------------------------------------


def test_validate_tool_on_the_cpu(monkeypatch, capsys):
    """The tool end to end on the plain versions, cut to one configuration,
    a one-stream grid (and its batch) and a short soak; every line OK, exit
    0."""
    monkeypatch.setattr(validate, "CONFIGS", validate.CONFIGS[:1])
    monkeypatch.setattr(validate, "SIZES", {True: (1, 4, 40)})
    rc = validate.main(["--device", "cpu", "--quick"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0, "\n".join(out[-20:])
    assert out[-2] == "ALL OK" and not any(ln.startswith("FAIL") for ln in out)
    import json

    summary = json.loads(out[-1])
    assert summary["ok"] and summary["failures"] == 0
    assert summary["streams"] == 2 and not summary["bench4k"]
    assert summary["checks"] == sum(ln.startswith("OK") for ln in out)
    modes = {ln[34:58].strip() for ln in out if ln.startswith("OK")}
    assert {"Decoder()", "exact_idct", "zrl_compat + exact",
            "decode_ycbcr (exact)", "fancy + exact", "decode_scaled(4)",
            "fused=False", "fused=False, exact", "BatchDecoder",
            "StreamDecoder", "BatchDecoder, exact"} <= modes
    assert summary["soak"]["unconstrained_errors"] > 0


def test_validate_tool_reports_a_wrong_answer(monkeypatch, capsys):
    """A decode off by one where the tolerance is byte for byte is a FAIL
    line and exit status 1: the tool does not pass what it cannot hold."""
    real = golden.decode_rgb

    def off_by_one(data, *args, **kwargs):
        out = real(data, *args, **kwargs)
        if kwargs.get("idct") == "int":
            out = out.copy()
            out[0, 0, 0] ^= 1
        return out

    monkeypatch.setattr(validate.golden, "decode_rgb", off_by_one)
    rep = validate.Report()
    data = encoder.encode(ref_image(), sampling="422", quality=90,
                          restart_interval_mcus=1)
    validate.validate_stream(rep, "422 ri=1 8x64", data, CPU)
    out = capsys.readouterr().out
    failed = {f[34:58].strip() for f in rep.failures}
    assert failed == {"exact_idct", "zrl_compat + exact",
                      "fused=False, exact"}, rep.failures
    assert all("max|diff| 1" in f for f in rep.failures)
    assert out.count("FAIL") == 3 and out.count("OK") == rep.checks - 3


def test_validate_tool_refuses_a_missing_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert validate.main(["--quick"]) == 1
    assert "no CUDA device" in capsys.readouterr().out


def test_float_decode_off_by_two_only_where_the_reference_arithmetic_is():
    """ROADMAP queue 3: tools/tpu_validate.py's 4:2:0, Ri = 5, q = 85,
    96 x 128 stream. The float decode is 2 off golden's matrix IDCT at 4
    samples (one Cb sample rounded the other way, B moved by 2 after BT.601)
    and equal there, as everywhere, to the reference's own float arithmetic
    (golden idct="aan"); the tool passes it for that reason and no other."""
    name, data = validate.streams(0)[6]
    assert name == "420 ri=5 q=85 96x128"
    got = Decoder(device=CPU).decode(data).astype(int)
    d = np.abs(got - golden.decode_rgb(data).astype(int))
    assert d.max() == 2 and (d > 1).sum() == 4
    assert {tuple(i) for i in np.argwhere(d > 1)} == {
        (38, 28, 2), (38, 29, 2), (39, 28, 2), (39, 29, 2)}
    aan = golden.decode_rgb(data, idct="aan")
    assert np.array_equal(got, aan)
    assert np.array_equal(Decoder(device=CPU, fused=False).decode(data), aan)
    rep = validate.Report()
    assert rep.compare(name, "Decoder()", got.astype(np.uint8),
                       golden.decode_rgb(data), 1, lambda: aan)
    wrong = aan.copy()
    wrong[38, 28, 2] ^= 4
    assert not rep.compare(name, "Decoder()", got.astype(np.uint8),
                           golden.decode_rgb(data), 1, lambda: wrong)
    assert not rep.compare(name, "Decoder()", got.astype(np.uint8),
                           golden.decode_rgb(data), 1)
    assert len(rep.failures) == 2
