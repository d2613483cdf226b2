"""What the CPU can check of the RGBA kernels' composite (csrc/decode.cu,
composite_rgba): the sample offsets the host hands the kernel
(``ops/fused.composite_offsets``) against the plain twin's index maps and
against the JAX package's own composite (golden's planes, nearest
upsampling and BT.601), for every sampling, gray, RGB-ID streams, 17 x 37
and 18 x 38 frames and every output block size; the kernel's walk over
quads of four pixels, followed index by index in numpy on those offsets;
and the tile stride the kernel pads its segments to. The kernel itself is
held to the plain twin and to golden on the card (tests/test_torch_kernels.py,
chip_smoke.py)."""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from compeg_tpu import encoder, golden  # noqa: E402
from compeg_tpu.metadata import analyze  # noqa: E402
from compeg_tpu_torch.ops import _build  # noqa: E402
from compeg_tpu_torch.ops import fused as F  # noqa: E402
from compeg_tpu_torch.pipeline import Decoder  # noqa: E402
from test_torch_smoke_vectors import rgb_ids  # noqa: E402

SAMPLINGS = ["444", "422", "420", "440", "411", "gray"]
SIZES = [(17, 37), (18, 38)]
BLOCKS = [1, 2, 4, 8]
SEGS = 32  # K2_SEGS of csrc/decode.cu


def tile_stride(dus: int, elem_bytes: int = 4) -> int:
    """csrc/decode.cu's tile_stride (elements a segment takes in a tile of
    ``elem_bytes`` elements), read from the source."""
    with open(os.path.join(_build.CSRC, "decode.cu")) as f:
        body = re.search(r"int tile_stride\(int dus, int elem_bytes\) \{\s*"
                         r"return (.*?);\s*\}", f.read())[1]
    return eval(body.replace("/", "//"), {"dus": dus,
                                          "elem_bytes": elem_bytes})


def stream(sampling, h, w, rgb, test_image):
    data = encoder.encode(test_image(h, w, "noise"), sampling=sampling,
                          quality=90, restart_interval_mcus=1)
    return rgb_ids(data) if rgb else data


def golden_composite(img, pixels, k):
    """The JAX package's composite of pixel blocks ``[N_du, k*k]`` u8:
    golden.decode_rgb's steps after the IDCT (golden.py:397-415)."""
    planes = golden.assemble_planes(img, pixels, blk=k)
    hs, ws = golden.scaled_size(img, k)
    if len(planes) == 1:
        return np.stack([planes[0][:hs, :ws]] * 3, axis=-1)
    up = [np.repeat(np.repeat(p, img.max_h // c.h_sample, axis=1),
                    img.max_v // c.v_sample, axis=0)[:hs, :ws]
          for p, c in zip(planes, img.components)]
    if img.color_space == "rgb":
        return np.stack(up, axis=-1)
    return golden.ycbcr_to_rgb_reference(*up)


def kernel_composite(tiles, geom, blk):
    """composite_rgba of csrc/decode.cu in numpy, index by index: blocks of
    32 segments (Ri 1, so MCUs), a thread per quad of four pixels, the
    offsets of ``composite_offsets``, a 16-byte store where the raster takes
    it and word by word with the right edge checked elsewhere. ``tiles`` is
    ``[MCUs, tile_stride]`` int32; returns the raster and how many quads
    went out as one store."""
    samp = tuple(map(tuple, geom.samplings))
    mw, mh, row_off, col_off = F.composite_offsets(samp, blk)
    dus = len(geom.du_to_comp)
    gray = len(samp) == 1
    c2_off = 0 if gray else samp[1][0] * samp[1][1] * 64
    out = np.zeros(geom.height * geom.width, np.uint32)
    written = np.zeros(out.size, np.int32)
    qw = (mw + 3) >> 2
    assert qw & (qw - 1) == 0 and 256 % qw == 0  # a thread keeps its columns
    lqw = qw.bit_length() - 1
    vec = mw % 4 == 0 and geom.width % 4 == 0
    stores = 0
    n_mcu = geom.width_mcus * geom.height_mcus
    for seg0 in range(0, n_mcu, SEGS):
        for i in range(SEGS * qw * mh):
            x0 = (i & (qw - 1)) * 4
            t = i >> lqw
            sl, r = t & (SEGS - 1), t >> 5
            mcu = seg0 + sl
            if mcu >= n_mcu:
                continue
            my, mx = divmod(mcu, geom.width_mcus)
            yy, xx = my * mh + r, mx * mw + x0
            if yy >= geom.height or xx >= geom.width:
                continue
            px = tiles[mcu]
            words = []
            for j in range(4):
                e = col_off[min(x0 + j, mw - 1)]
                y = px[(row_off[r] & 0xFFFF) + (e & 0xFFFF)]
                c1 = c2 = y
                if not gray:
                    at = (row_off[r] >> 16) + (e >> 16)
                    c1, c2 = px[at], px[at + c2_off]
                if gray or geom.rgb:
                    rgb = (y, c1, c2)
                else:
                    cb, cr = int(c1) - 128, int(c2) - 128
                    rgb = (y + ((45 * cr) >> 5),
                           y - ((11 * cb + 23 * cr) >> 5),
                           y + ((113 * cb) >> 6))
                rr, gg, bb = (min(max(int(v), 0), 255) for v in rgb)
                words.append(rr | gg << 8 | bb << 16 | 0xFF << 24)
            at = yy * geom.width + xx
            if vec:
                assert at % 4 == 0  # a 16-byte aligned store
                out[at:at + 4] = words
                written[at:at + 4] += 1
                stores += 1
            else:
                for j in range(4):
                    if x0 + j < mw and xx + j < geom.width:
                        out[at + j] = words[j]
                        written[at + j] += 1
    assert (written == 1).all()  # every pixel once, none outside
    assert dus * 64 < tile_stride(dus)
    return out.reshape(geom.height, geom.width), stores


def cases():
    for sampling in SAMPLINGS:
        yield sampling, False
    yield "444", True  # component IDs R, G, B


@pytest.mark.parametrize("blk", BLOCKS)
@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("sampling,rgb", list(cases()))
def test_offsets_agree_with_the_plain_twin_and_the_jax_composite(
        sampling, rgb, h, w, blk, test_image):
    data = stream(sampling, h, w, rgb, test_image)
    img = analyze(data)
    geom = Decoder(device="cpu").prepare(data).geom
    sgeom = F.scaled_geometry(geom, blk)
    assert bool(geom.rgb) == rgb
    dus, n_mcu = len(geom.du_to_comp), geom.width_mcus * geom.height_mcus
    pixels = np.random.default_rng(blk).integers(
        0, 256, (n_mcu * dus, blk * blk), dtype=np.uint8)
    want = golden_composite(img, pixels, blk)
    assert want.shape == (sgeom.height, sgeom.width, 3)
    # the plain twin, on the same blocks
    blocks = torch.from_numpy(pixels.astype(np.int32)).reshape(
        n_mcu, 1, dus, blk * blk)
    plain = F.composite_rgba(blocks, sgeom, blk)
    assert np.array_equal(F.rgba_to_rgb(plain).numpy(), want)
    # the kernel's walk, on the kernel's tile: 64 words a data unit, the
    # segment stride padded
    tiles = np.full((n_mcu, tile_stride(dus)), -1, np.int32)
    tiles[:, :dus * 64].reshape(n_mcu, dus, 64)[:, :, :blk * blk] = (
        pixels.reshape(n_mcu, dus, blk * blk))
    got, stores = kernel_composite(tiles, sgeom, blk)
    assert np.array_equal(got.view(np.int32), plain.numpy())
    # 16-byte stores exactly where rows are whole quads
    mw = F.composite_offsets(tuple(map(tuple, geom.samplings)), blk)[0]
    whole = mw % 4 == 0 and sgeom.width % 4 == 0
    assert (stores > 0) == whole


@pytest.mark.parametrize("blk", BLOCKS)
@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_offsets_are_the_index_maps_split_in_row_and_column(sampling, blk,
                                                            test_image):
    """(row_off[r] + col_off[x]) is _composite_index's sample of pixel
    (r, x) of an MCU, for luma and both other components."""
    geom = Decoder(device="cpu").prepare(
        stream(sampling, 40, 72, False, test_image)).geom
    samp = tuple(map(tuple, geom.samplings))
    mw, mh, row_off, col_off = F.composite_offsets(samp, blk)
    assert len(row_off) == mh <= 16 and len(col_off) == mw <= 32
    sgeom = F.scaled_geometry(geom, blk)
    maps = F._composite_index(sgeom, "cpu", blk)
    dus, npx = len(geom.du_to_comp), blk * blk
    rows = np.arange(sgeom.height)[:, None]
    cols = np.arange(sgeom.width)[None, :]
    base = ((rows // mh) * geom.width_mcus + cols // mw) * (dus * npx)
    ro, co = np.array(row_off)[rows % mh], np.array(col_off)[cols % mw]

    def plain_index(word):  # tile word -> index into [DUS, blk*blk]
        assert (word % 64 < npx).all()
        return base + (word // 64) * npx + word % 64

    luma = (ro & 0xFFFF) + (co & 0xFFFF)
    assert np.array_equal(plain_index(luma), maps["y"].numpy())
    if len(samp) > 1:
        chroma = (ro >> 16) + (co >> 16)
        assert np.array_equal(plain_index(chroma), maps["c1"].numpy())
        third = chroma + samp[1][0] * samp[1][1] * 64
        assert np.array_equal(plain_index(third), maps["c2"].numpy())


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("dus", [1, 3, 4, 6])
def test_tile_stride_spreads_the_segments_over_the_banks(dus, elem_bytes):
    """A segment takes a whole number of 4-byte words, odd, so that 32
    segments' words of one sample lie in 32 different banks; and the tile is
    a whole number of 16-byte vectors for the zero fill."""
    stride = tile_stride(dus, elem_bytes)
    assert stride > dus * 64 and stride * elem_bytes % 4 == 0
    words = stride * elem_bytes // 4
    assert len({(s * words) % 32 for s in range(SEGS)}) == SEGS
    assert (SEGS * stride * elem_bytes) % 16 == 0


def test_params_carry_the_offsets():
    samp = ((2, 1), (1, 1), (1, 1))
    comp = F.composite_offsets(samp, 8)
    p = _build.make_params(7, 3, 2, 13, (0, 0, 1, 2), samplings=samp,
                           composite=comp)
    assert (p.mcu_w, p.mcu_h) == (16, 8)
    assert tuple(p.row_off[:8]) == comp[2] and tuple(p.col_off[:16]) == comp[3]
    assert not any(p.row_off[8:]) and not any(p.col_off[16:])
    # pixel (3, 9): luma in data unit 1 at row 3, column 1; chroma in data
    # unit 2 at row 3, column 4
    assert (p.row_off[3] & 0xFFFF) + (p.col_off[9] & 0xFFFF) == 64 + 3 * 8 + 1
    assert (p.row_off[3] >> 16) + (p.col_off[9] >> 16) == 128 + 3 * 8 + 4
    none = _build.make_params(7, 3, 2, 13, (0, 0, 1, 2), samplings=samp)
    assert (none.mcu_w, none.mcu_h) == (0, 0)


def test_wrapper_params_follow_the_geometry(test_image):
    data = stream("420", 33, 50, False, test_image)
    dec = Decoder(device="cpu")
    pf = dec.prepare(data)
    rows = dec.upload(pf)
    p = F._params(rows, pf.nseg, pf.tables, pf.geom)
    assert (p.mcu_w, p.mcu_h) == (16, 16)
    p2 = F._params(rows, pf.nseg, pf.tables,
                   F.scaled_geometry(pf.geom, 2), blk=2)
    assert (p2.mcu_w, p2.mcu_h, p2.blk, p2.zlen) == (4, 4, 2, 5)
