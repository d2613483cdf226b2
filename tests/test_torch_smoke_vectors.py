"""The reference data of chip_smoke.py, compeg_tpu_torch/testdata/smoke.npz.

chip_smoke.py runs on the card and imports nothing of the JAX package, so
golden's answers travel to it in this file:

* small streams of every supported sampling with golden's raw coefficients,
  float RGB, integer RGB, integer planes (cropped as ``decode_ycbcr`` crops
  them), scaled RGB for k = 1, 2, 4, and the fancy + integer RGB of the JAX
  package's staged colour functions over golden's integer planes;
* the ZRL stream of tests/test_compat.py with golden's compat answers, and a
  stream of random int16-range blocks whose integer IDCT wraps int32;
* for the 4K benchmark frame, digests of golden's coefficients, float and
  integer RGB, integer planes and fancy + integer RGB, and golden's float
  and scaled RGB on three MCU rows. All of it comes from one
  ``decode_coefficients`` call;
* small batches of frames that differ (segment counts that are no multiple
  of 32, short last intervals, 4:2:0 for the fancy filter) with golden's
  float, integer and fancy answer for every frame;
* the answers of the 64-frame 4K batch: frame i is the benchmark frame with
  its restart segments rotated by 240 * i (``testdata.rotate_restart_
  segments``), its answer golden's picture rolled up by 8 * i pixel rows:
  the digest of the rolled integer RGB for every i, and of the rolled float
  and fancy RGB for a few.

These tests recompute all of it with compeg_tpu's encoder, golden decoder
and colour functions and must find the file's contents; the port's plain
versions must reproduce what chip_smoke holds the kernels to.

After changing a case, rewrite the file with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_smoke_vectors.py
"""

import hashlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from compeg_tpu import analyze, encoder, golden  # noqa: E402
from compeg_tpu import huffman as H  # noqa: E402
from compeg_tpu.ops import color as JC  # noqa: E402
from compeg_tpu.ops.luts import idct_matrix_zigzag  # noqa: E402
from compeg_tpu_torch import BatchDecoder, testdata  # noqa: E402
from compeg_tpu_torch.ops import entropy as E  # noqa: E402
from compeg_tpu_torch.pipeline import Decoder  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench_assets", "bench4k.jpg")
# First pixel row of three 4:2:2 MCU rows of the 4K frame (8 rows each):
# the top, the middle and the bottom of the picture.
BENCH_MCU_ROWS = (0, 1080, 2152)
SCALES = (1, 2, 4)


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


def zrl_stream() -> bytes:
    """The stream of tests/test_compat.py: isolated high-zigzag coefficients,
    so the encoder emits ZRL symbols, the only place where the spec's +16
    and the reference's +17 differ."""
    L = idct_matrix_zigzag(64)  # [64 pix, 64 zig]
    rng = np.random.RandomState(7)
    H_, W_ = 32, 48
    img = np.zeros((H_, W_), np.uint8)
    for by in range(H_ // 8):
        for bx in range(W_ // 8):
            zc = np.zeros(64, np.float32)
            pos = rng.choice([20, 25, 35, 45, 55, 63])
            zc[pos] = rng.choice([300, -300, 500])
            if rng.rand() < 0.5:
                zc[min(63, pos + rng.randint(1, 17))] = 200
            pix = zc @ L.T + 128.0
            img[by * 8:(by + 1) * 8, bx * 8:(bx + 1) * 8] = np.clip(
                np.round(pix), 0, 255).astype(np.uint8).reshape(8, 8)
    rgb = np.stack([img, img, img], -1)
    return encoder.encode(rgb, sampling="444", quality=97,
                          restart_interval_mcus=1)


def _magnitude(v: int):
    if v == 0:
        return 0, 0
    s = abs(v).bit_length()
    return s, v if v > 0 else v + (1 << s) - 1


def coefficient_stream(blocks: np.ndarray, q: np.ndarray) -> bytes:
    """A gray ``8 x 8n`` JPEG, restart interval 1, whose n blocks carry the
    raw zigzag coefficients ``blocks [n, 64]`` (|value| <= 1023) under the
    zigzag quantizer ``q [64]`` (1..255), coded with the Annex K tables."""
    n = len(blocks)
    base = encoder.encode(np.zeros((8, 8 * n), np.uint8), sampling="gray",
                          restart_interval_mcus=1)
    head = bytearray(base[:analyze(base).scan_offset])
    at = head.find(b"\xff\xdb") + 5  # marker, length, Pq/Tq
    head[at:at + 64] = bytes(int(v) for v in q)
    tables = H.default_tables()
    dc, ac = tables[(0, 0)].encode_map(), tables[(1, 0)].encode_map()
    bw = encoder.BitWriter()
    for i, zz in enumerate(blocks):
        if i:
            bw.raw_marker(0xD0 + (i - 1) % 8)
        s, bits = _magnitude(int(zz[0]))  # the predictor restarts at 0
        bw.put(*dc[s])
        bw.put(bits, s)
        nz = np.nonzero(zz[1:])[0]
        last = int(nz[-1]) + 1 if len(nz) else 0
        run = 0
        for k in range(1, last + 1):
            if zz[k] == 0:
                run += 1
                continue
            while run > 15:
                bw.put(*ac[0xF0])
                run -= 16
            s, bits = _magnitude(int(zz[k]))
            bw.put(*ac[(run << 4) | s])
            bw.put(bits, s)
            run = 0
        if last != 63:
            bw.put(*ac[0x00])
    bw.pad_to_byte()
    return bytes(head) + bytes(bw.out) + b"\xff\xd9"


def wrap_stream() -> bytes:
    """512 blocks of random coefficients whose dequantized values span the
    int16 range (a quarter of them zero), under quantizers of 32-48: the
    integer IDCT's int32 sums wrap on most of them."""
    rng = np.random.default_rng(11)
    blocks = rng.integers(-1023, 1024, (512, 64))
    blocks[rng.random(blocks.shape) < 0.25] = 0
    return coefficient_stream(blocks, rng.integers(32, 49, 64))


def golden_rgb(img, pixels: np.ndarray, k: int = 8) -> np.ndarray:
    """golden.decode_rgb's tail (golden.py:397-415) over pixels of golden's
    own IDCTs, so that one decode_coefficients call serves every answer."""
    planes = golden.assemble_planes(img, pixels, blk=k)
    hs, ws = golden.scaled_size(img, k)
    if len(planes) == 1:
        y = planes[0][:hs, :ws]
        return np.stack([y, y, y], axis=-1)
    up = []
    for p, c in zip(planes, img.components):
        p = np.repeat(p, img.max_h // c.h_sample, axis=1)
        p = np.repeat(p, img.max_v // c.v_sample, axis=0)
        up.append(p[:hs, :ws])
    if img.color_space == "rgb":
        return np.stack(up, axis=-1)
    return golden.ycbcr_to_rgb_reference(*up)


def ycbcr_crops(img):
    """``decode_ycbcr``'s plane sizes: ceil(H*v/max_v) x ceil(W*h/max_h)."""
    return [(-(-img.height * c.v_sample // img.max_v),
             -(-img.width * c.h_sample // img.max_h)) for c in img.components]


def golden_planes(img, pixels: np.ndarray):
    """Golden's component planes, cropped as ``decode_ycbcr`` crops them."""
    return [p[:h, :w] for p, (h, w) in
            zip(golden.assemble_planes(img, pixels), ycbcr_crops(img))]


def jax_fancy_rgb(img, planes) -> np.ndarray:
    """Fancy upsampling + colour with the JAX package's staged functions
    (compeg_tpu.ops.color, as finalize_rgb applies them) over MCU-padded
    planes: vertical triangle filter, then horizontal (4:1:1 replicates)."""
    up = []
    for p, c in zip(planes, img.components):
        fx, fy = img.max_h // c.h_sample, img.max_v // c.v_sample
        p = jnp.asarray(p, jnp.int32)
        if fy > 1:
            p = JC.upsample_fancy_v(p)
        if fx == 2:
            p = JC.upsample_fancy_h(p)
        elif fx > 1:
            p = JC.upsample_nearest(p, fx, 1)
        up.append(p[:img.height, :img.width])
    if len(up) == 1:
        y = np.asarray(up[0]).astype(np.uint8)
        return np.stack([y, y, y], axis=-1)
    if img.color_space == "rgb":
        return np.asarray(jnp.stack(up, axis=-1)).astype(np.uint8)
    return np.asarray(JC.ycbcr_to_rgb(*up))


# (label, sampling, restart interval, height, width, retained, RGB-ID)
CASES = [(f"{s} ri=1 24x40", s, 1, 24, 40, 64, False)
         for s in ("422", "444", "420", "440", "411", "gray")]
# 16x48 at 4:2:2 is 3 MCU columns: Ri 2 and 5 wrap MCU rows and end short.
CASES += [(f"422 ri={ri} 16x48", "422", ri, 16, 48, 64, False)
          for ri in (2, 5, None)]
CASES += [("422 ri=1 17x37", "422", 1, 17, 37, 64, False),
          ("420 ri=3 40x72", "420", 3, 40, 72, 64, False),
          ("444 RGB-ID 24x40", "444", None, 24, 40, 64, True),
          ("422 ri=1 24x40 retained=32", "422", 1, 24, 40, 32, False),
          ("420 ri=1 18x38", "420", 1, 18, 38, 64, False)]


def case_stream(i: int) -> bytes:
    _, sampling, ri, h, w, _, rgb = CASES[i]
    data = encoder.encode(smoke_image(h, w), sampling=sampling,
                          quality=90, restart_interval_mcus=ri)
    return rgb_ids(data) if rgb else data


def case_vectors(i: int) -> dict:
    data = case_stream(i)
    retained = CASES[i][5]
    img = analyze(data)
    coeffs = golden.decode_coefficients(img, dequant=False)
    pix_int = golden.idct_pixels_int(coeffs, img, retained)
    out = {
        f"jpeg_{i}": np.frombuffer(data, np.uint8),
        f"coeffs_{i}": coeffs,
        f"rgb_{i}": golden.decode_rgb(data, retained_coefficients=retained),
        f"rgbi_{i}": golden.decode_rgb(data, retained_coefficients=retained,
                                       idct="int"),
        f"fancy_{i}": jax_fancy_rgb(img, golden.assemble_planes(img, pix_int)),
    }
    for c, p in enumerate(golden_planes(img, pix_int)):
        out[f"plane{c}_{i}"] = p
    for k in SCALES:
        out[f"rgbs{k}_{i}"] = golden.decode_rgb(
            data, retained_coefficients=retained, scale_blocks=k)
    return out


def compat_vectors() -> dict:
    """The ZRL stream with golden's compat answers (zrl17, integer IDCT) at
    retained 64 and 32, and the wrap stream with golden's integer RGB."""
    zrl, wrap = zrl_stream(), wrap_stream()
    out = {"zrl_jpeg": np.frombuffer(zrl, np.uint8),
           "wrap_jpeg": np.frombuffer(wrap, np.uint8),
           "wrap_rgbi": golden.decode_rgb(wrap, idct="int")}
    for r in (64, 32):
        out[f"zrl_rgbi_{r}"] = golden.decode_rgb(
            zrl, retained_coefficients=r, idct="int", zrl17=True)
    return out


def bench4k_vectors() -> dict:
    with open(BENCH, "rb") as f:
        data = f.read()
    img = analyze(data)
    coeffs = golden.decode_coefficients(img, dequant=False)
    rgb = golden_rgb(img, golden.idct_pixels_raw(coeffs, img))
    pix_int = golden.idct_pixels_int(coeffs, img)
    rows = np.concatenate([np.arange(r, r + 8) for r in BENCH_MCU_ROWS])
    rgbi = golden_rgb(img, pix_int)
    fancy = jax_fancy_rgb(img, golden.assemble_planes(img, pix_int))
    out = {
        "bench4k_jpeg_sha256": np.array(hashlib.sha256(data).hexdigest()),
        "bench4k_coeffs_sha256": np.array(testdata.digest(coeffs)),
        "bench4k_rgb_sha256": np.array(testdata.digest(rgb)),
        "bench4k_rows": rows.astype(np.int32),
        "bench4k_rgb_rows": rgb[rows],
        "bench4k_rgbi_sha256": np.array(testdata.digest(rgbi)),
        "bench4k_fancy_sha256": np.array(testdata.digest(fancy)),
        # The 64-frame batch: golden's answers rolled by whole MCU rows.
        "bench4k_roll_samples": np.array(BENCH_ROLL_SAMPLES, np.int32),
        "bench4k_rgbi_roll_sha256": rolled_digests(rgbi, range(BENCH_BATCH)),
        "bench4k_rgb_roll_sha256": rolled_digests(rgb, BENCH_ROLL_SAMPLES),
        "bench4k_fancy_roll_sha256": rolled_digests(fancy,
                                                    BENCH_ROLL_SAMPLES),
    }
    for c, p in enumerate(golden_planes(img, pix_int)):
        out[f"bench4k_plane{c}_sha256"] = np.array(testdata.digest(p))
    for k in SCALES:
        # The scaled frame's MCU rows are k pixel rows high.
        rk = np.concatenate([np.arange(r * k // 8, r * k // 8 + k)
                             for r in BENCH_MCU_ROWS])
        scaled = golden_rgb(img, golden.idct_pixels_scaled(coeffs, img, k), k)
        out[f"bench4k_rows{k}"] = rk.astype(np.int32)
        out[f"bench4k_rgbs{k}_rows"] = scaled[rk]
    return out


# (label, sampling, restart interval, height, width), four frames each
BATCH_CASES = [
    ("422 ri=1 48x128", "422", 1, 48, 128),  # 48 segments: 32 + a part
    ("422 ri=5 16x48", "422", 5, 16, 48),    # a short last interval
    ("420 ri=5 40x136", "420", 5, 40, 136),  # short last interval, fancy v
    ("444 ri=3 24x40", "444", 3, 24, 40),    # intervals wrapping MCU rows
]
BATCH_FRAMES = 4
BENCH_BATCH = 64
BENCH_ROLL_SAMPLES = (0, 1, 37, 63)  # frames whose float and fancy digests


def batch_stream(c: int, f: int) -> bytes:
    _, sampling, ri, h, w = BATCH_CASES[c]
    return encoder.encode(smoke_image(h, w, seed=100 + f), sampling=sampling,
                          quality=90, restart_interval_mcus=ri)


def batch_vectors(c: int) -> dict:
    out = {}
    for f in range(BATCH_FRAMES):
        data = batch_stream(c, f)
        img = analyze(data)
        pix_int = golden.idct_pixels_int(
            golden.decode_coefficients(img, dequant=False), img)
        out[f"batch{c}_jpeg_{f}"] = np.frombuffer(data, np.uint8)
        out[f"batch{c}_rgb_{f}"] = golden.decode_rgb(data)
        out[f"batch{c}_rgbi_{f}"] = golden_rgb(img, pix_int)
        out[f"batch{c}_fancy_{f}"] = jax_fancy_rgb(
            img, golden.assemble_planes(img, pix_int))
    return out


def rolled_digests(rgb: np.ndarray, frames) -> np.ndarray:
    """Digests of ``rgb`` rolled up by one 4:2:2 MCU row (8 pixel rows) per
    frame index."""
    return np.array([testdata.digest(np.roll(rgb, -8 * i, axis=0))
                     for i in frames])


def write_vectors(path: str = testdata.PATH) -> None:
    arrays = {
        "labels": np.array([c[0] for c in CASES]),
        "retained": np.array([c[5] for c in CASES], np.int32),
    }
    for i in range(len(CASES)):
        arrays.update(case_vectors(i))
    arrays.update(compat_vectors())
    arrays["batch_labels"] = np.array([c[0] for c in BATCH_CASES])
    for c in range(len(BATCH_CASES)):
        arrays.update(batch_vectors(c))
    arrays.update(bench4k_vectors())
    np.savez_compressed(path, **arrays)


@pytest.fixture(scope="module")
def stored():
    return testdata.load()


def assert_stored(stored, want: dict):
    for key, value in want.items():
        assert stored[key].dtype == value.dtype, key
        assert np.array_equal(stored[key], value), key


@pytest.mark.parametrize("i", range(len(CASES)), ids=[c[0] for c in CASES])
def test_stream_vectors_are_golden(i, stored):
    assert str(stored["labels"][i]) == CASES[i][0]
    assert int(stored["retained"][i]) == CASES[i][5]
    assert_stored(stored, case_vectors(i))


@pytest.mark.parametrize("c", range(len(BATCH_CASES)),
                         ids=[c[0] for c in BATCH_CASES])
def test_batch_vectors_are_golden(c, stored):
    assert str(stored["batch_labels"][c]) == BATCH_CASES[c][0]
    assert_stored(stored, batch_vectors(c))


@pytest.mark.parametrize("c", range(len(BATCH_CASES)),
                         ids=[c[0] for c in BATCH_CASES])
def test_plain_batch_reproduces_stored_answers(c, stored):
    """What chip_smoke holds the batched K2, K2x and K3 to on the card, here
    through their plain twins: float within 1, integer and fancy exactly,
    every frame in its own place."""
    frames = [stored[f"batch{c}_jpeg_{f}"].tobytes()
              for f in range(BATCH_FRAMES)]
    got = BatchDecoder(device="cpu").decode(frames).astype(int)
    exact = BatchDecoder(device="cpu", exact_idct=True).decode(frames)
    fancy = BatchDecoder(device="cpu", exact_idct=True,
                         fancy_upsampling=True).decode(frames)
    for f in range(BATCH_FRAMES):
        assert np.abs(got[f] - stored[f"batch{c}_rgb_{f}"]).max() <= 1, f
        assert np.array_equal(exact[f], stored[f"batch{c}_rgbi_{f}"]), f
        assert np.array_equal(fancy[f], stored[f"batch{c}_fancy_{f}"]), f
    assert not np.array_equal(exact[0], exact[1])


def test_rotated_segments_roll_the_picture():
    """testdata.rotate_restart_segments on a small stream with 8 MCUs per
    row: rotating by 8 * i segments is golden's picture rolled up by i MCU
    rows, and the marker numbering stays valid for the Python parser."""
    data = encoder.encode(smoke_image(64, 128), sampling="422", quality=90,
                          restart_interval_mcus=1)
    img = analyze(data)
    assert img.width_mcus == 8 and img.total_restart_intervals == 64
    want = golden.decode_rgb(data, idct="int")
    for i in (0, 1, 5, 7):
        rot = testdata.rotate_restart_segments(
            data, img.scan_offset, len(img.scan_data), 8 * i)
        assert len(rot) == len(data)
        assert np.array_equal(golden.decode_rgb(rot, idct="int"),
                              np.roll(want, -8 * i, axis=0)), i
        got = Decoder(device="cpu", exact_idct=True).decode(rot)
        assert np.array_equal(got, np.roll(want, -8 * i, axis=0)), i
    with pytest.raises(ValueError):
        testdata.rotate_restart_segments(data, img.scan_offset,
                                         len(img.scan_data), 3)


def test_the_packer_accepts_the_rotated_4k_frames():
    """Frame i of chip_smoke's 64-frame batch: the port's packer takes it,
    and its rows are the benchmark frame's rows rotated by 240 * i."""
    with open(BENCH, "rb") as f:
        data = f.read()
    dec = Decoder(device="cpu")
    pf = dec.prepare(data)
    img = pf.image
    assert (img.width_mcus, img.restart_interval) == (240, 1)
    assert pf.nseg == 64800 and pf.nseg % 8 == 0
    for i in (1, 63):
        rot = testdata.rotate_restart_segments(
            data, img.scan_offset, len(img.scan_data), 240 * i)
        rows = dec.prepare(rot).rows[: pf.nseg]
        assert np.array_equal(rows, np.roll(pf.rows[: pf.nseg], -240 * i,
                                            axis=0)), i


def test_compat_vectors_are_golden(stored):
    assert_stored(stored, compat_vectors())


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


@pytest.mark.parametrize("i", [0, 2, 5, 7, 11, 12], ids=lambda i: CASES[i][0])
def test_plain_modes_reproduce_stored_answers(i, stored):
    """What chip_smoke holds K2x, K3 and K2s to on the card, here through
    their plain twins: integer RGB and planes exactly, scaled within 1."""
    data = stored[f"jpeg_{i}"].tobytes()
    r = int(stored["retained"][i])
    exact = Decoder(device="cpu", exact_idct=True, retained_coefficients=r)
    assert np.array_equal(exact.decode(data), stored[f"rgbi_{i}"])
    for c, p in enumerate(exact.decode_ycbcr(data)):
        assert np.array_equal(p, stored[f"plane{c}_{i}"]), c
    fancy = Decoder(device="cpu", exact_idct=True, fancy_upsampling=True,
                    retained_coefficients=r)
    assert np.array_equal(fancy.decode(data), stored[f"fancy_{i}"])
    dec = Decoder(device="cpu", retained_coefficients=r)
    for k in SCALES:
        got = dec.decode_scaled(data, k).astype(int)
        want = stored[f"rgbs{k}_{i}"]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1, k


@pytest.mark.parametrize("i", [0, 3, 4, 5, 9, 11], ids=lambda i: CASES[i][0])
def test_golden_tail_equals_decode_rgb(i):
    """golden_rgb, which derives the 4K answers from one coefficient decode,
    is golden.decode_rgb's own tail: float, integer and scaled."""
    data = case_stream(i)
    img = analyze(data)
    coeffs = golden.decode_coefficients(img, dequant=False)
    assert np.array_equal(golden_rgb(img, golden.idct_pixels_raw(coeffs, img)),
                          golden.decode_rgb(data))
    assert np.array_equal(golden_rgb(img, golden.idct_pixels_int(coeffs, img)),
                          golden.decode_rgb(data, idct="int"))
    for k in SCALES:
        pix = golden.idct_pixels_scaled(coeffs, img, k)
        assert np.array_equal(golden_rgb(img, pix, k),
                              golden.decode_rgb(data, scale_blocks=k)), k


def test_bench4k_vectors_are_golden(stored):
    """The 4K frame's golden answers on the CPU (one coefficient decode)."""
    want = bench4k_vectors()
    for key, value in want.items():
        if value.dtype.kind == "U":
            assert str(stored[key]) == str(value), key
        else:
            assert np.array_equal(stored[key], value), key


if __name__ == "__main__":
    write_vectors()
    print(f"wrote {testdata.PATH} ({os.path.getsize(testdata.PATH)} B)")
