"""compeg_tpu_torch entropy decode (K1's plain version) against the JAX
entropy kernel (Pallas, interpret mode) and the golden decoder: raw zigzag
coefficients must be EXACTLY equal. Both kernels are fed the same packed
words, and the port gets the JAX plan's own table constants
(``tables_from_plan``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from compeg_tpu import analyze, encoder, golden  # noqa: E402
from compeg_tpu import scan as S  # noqa: E402
from compeg_tpu.ops import entropy as JE  # noqa: E402
from compeg_tpu.pipeline import seg_mcu_counts  # noqa: E402
from compeg_tpu_torch.ops import entropy as E  # noqa: E402


def both_decoders(data: bytes):
    """(ImageData, JAX kernel coefficients, port coefficients), each
    ``[total_mcus * DUS, 64]`` in raster MCU order."""
    img = analyze(data)
    dscan = S.preprocess(img.scan_data, img.total_restart_intervals)
    plan = JE.plan_from_image(img, dscan)
    words = np.asarray(dscan.words, dtype=np.uint32)  # [G, W, 8, 128]
    seg_mcus = seg_mcu_counts(dscan.active, img.restart_interval, img.total_mcus)
    jout = JE.entropy_decode(words, seg_mcus, plan, interpret=True)
    jax_coeffs = np.asarray(JE.coefficients_natural_order(jout, plan))
    # The same words as linear per-segment rows [G*1024, W].
    rows = np.ascontiguousarray(
        words.transpose(0, 2, 3, 1).reshape(-1, dscan.words_per_segment)
    )
    out = E.entropy_decode(
        torch.from_numpy(rows.view(np.int32)), img.total_restart_intervals,
        E.tables_from_plan(plan), img.restart_interval, img.total_mcus,
        img.du_to_comp,
    )
    assert tuple(out.shape) == (img.total_restart_intervals,
                                img.restart_interval, img.dus_per_mcu, 64)
    port = E.coefficients_natural_order(out, img.total_mcus).numpy()
    return img, jax_coeffs, port


def assert_exact(img, jax_coeffs, port):
    want = golden.decode_coefficients(img, dequant=False)
    assert port.shape == want.shape == jax_coeffs.shape
    assert np.array_equal(port, jax_coeffs), np.argwhere(port != jax_coeffs)[:5]
    assert np.array_equal(port, want), np.argwhere(port != want)[:5]


@pytest.mark.parametrize("sampling", ["422", "444", "420", "gray"])
def test_plain_k1_matches_jax_and_golden(sampling, test_image):
    data = encoder.encode(test_image(24, 40, "gradient"), sampling=sampling,
                          quality=85, restart_interval_mcus=1)
    assert_exact(*both_decoders(data))


@pytest.mark.parametrize("ri", [1, 2, 5, None])
def test_plain_k1_restart_intervals(ri, test_image):
    """Ri 2 and 5 leave a short final interval (3 MCU columns x 2 rows)."""
    data = encoder.encode(test_image(16, 48, "edges"), sampling="422",
                          quality=75, restart_interval_mcus=ri)
    assert_exact(*both_decoders(data))


def reserved_symbol_stream() -> bytes:
    """Gray 8x8, flat qtable, custom AC table {'00': 0x30 (reserved run-3,
    size-0), '01': (0, 1), '10': EOB}; scan = DC 0, reserved, +1, EOB
    (the stream of tests/test_entropy.py's reserved-symbol test)."""
    dqt = bytes([0xFF, 0xDB, 0x00, 0x43, 0x00]) + bytes([1] * 64)
    sof = bytes([0xFF, 0xC0, 0x00, 0x0B, 0x08, 0x00, 0x08, 0x00, 0x08,
                 0x01, 0x01, 0x11, 0x00])
    dht_dc = bytes([0xFF, 0xC4, 0x00, 0x14, 0x00, 0x01] + [0] * 15 + [0x00])
    dht_ac = bytes([0xFF, 0xC4, 0x00, 0x16, 0x10, 0x00, 0x03] + [0] * 14
                   + [0x30, 0x01, 0x00])
    sos = bytes([0xFF, 0xDA, 0x00, 0x08, 0x01, 0x01, 0x00, 0x00, 0x3F, 0x00])
    scan = bytes([0b00001110])
    return b"\xFF\xD8" + dqt + sof + dht_dc + dht_ac + sos + scan + b"\xFF\xD9"


def test_plain_k1_reserved_run0_symbol_keeps_decoding():
    """A reserved (run, 0) AC symbol advances run+1 and writes nothing; the
    +1 after it lands at zigzag position 5."""
    img, jax_coeffs, port = both_decoders(reserved_symbol_stream())
    want = np.zeros(64, np.int32)
    want[5] = 1
    assert np.array_equal(port[0], want), port[0][:8]
    assert_exact(img, jax_coeffs, port)


def test_plain_k1_garbage_bits_terminate_like_the_jax_kernel(test_image):
    """Random entropy bytes (RST and stuffing structure kept, so the interval
    count matches): the decode returns, and equals the JAX kernel on the
    same words bit for bit (clamped word reads, clipped symbols, int32 DC
    predictors)."""
    data = encoder.encode(test_image(16, 32, "noise"), sampling="422",
                          quality=80, restart_interval_mcus=2)
    img = analyze(data)
    scan = np.frombuffer(img.scan_data, np.uint8).copy()
    keep = scan == 0xFF
    keep[1:] |= keep[:-1]
    noise = np.random.default_rng(3).integers(0, 255, scan.size, np.uint8)
    scan[~keep] = noise[~keep]
    off = img.scan_offset
    garbage = data[:off] + scan.tobytes() + data[off + scan.size:]
    _, jax_coeffs, port = both_decoders(garbage)
    assert np.array_equal(port, jax_coeffs), np.argwhere(port != jax_coeffs)[:5]


@pytest.mark.parametrize("kind", ["422", "gray", "reserved"])
def test_tables_from_plan_equal_tables_from_image(kind, test_image):
    if kind == "reserved":
        data = reserved_symbol_stream()
    else:
        data = encoder.encode(test_image(16, 16, "gradient"), sampling=kind)
    img = analyze(data)
    plan = JE.plan_from_image(img, S.preprocess(img.scan_data,
                                                img.total_restart_intervals))
    a, b = E.tables_from_plan(plan), E.tables_from_image(img)
    for name in ("limits", "delta", "values", "max_len", "num_values", "packed"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.table_of == b.table_of
    assert len(a.table_of) == 2 * len(img.components)
    assert tuple(a.packed.shape) == (max(a.table_of) + 1,
                                     E.table_layout()["TAB_WORDS"])
