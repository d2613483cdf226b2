"""What the CPU can check of the planes kernels' phase 3 and of the integer
IDCT's register transposition (csrc/decode.cu, store_planes and transpose8):
the store units the host hands the kernel (``ops/fused.plane_offsets``),
followed index by index in numpy as the kernel walks them, against
``ops/color.component_planes`` and golden's own planes for every sampling,
RGB-ID streams, 17 x 37 and 18 x 38 frames, restart interval 1 and longer;
which store a plane's base address selects (``plane_store_route``); the
shuffle network of transpose8, read from the table in the source's comment,
against ``.T``; the launch parameters that carry all of it; and the ``out``
planes of the wrapper. The kernels themselves are held to their plain twins
and to golden on the card (tests/test_torch_kernels.py, chip_smoke.py)."""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from compeg_tpu import encoder, golden  # noqa: E402
from compeg_tpu.metadata import analyze  # noqa: E402
from compeg_tpu_torch.ops import _build  # noqa: E402
from compeg_tpu_torch.ops import color as C  # noqa: E402
from compeg_tpu_torch.ops import fused as F  # noqa: E402
from compeg_tpu_torch.pipeline import Decoder  # noqa: E402
from test_torch_composite import tile_stride  # noqa: E402
from test_torch_smoke_vectors import rgb_ids  # noqa: E402

SEGS = 32  # K2_SEGS of csrc/decode.cu
THREADS = 128  # Tile::THREADS
# (sampling, RGB-ID)
STREAMS = [("444", False), ("422", False), ("420", False), ("440", False),
           ("411", False), ("gray", False), ("444", True)]
SIZES = [(17, 37), (18, 38), (40, 72)]
INTERVALS = [1, 3]


def source() -> str:
    with open(os.path.join(_build.CSRC, "decode.cu")) as f:
        return f.read()


def kernel_store_planes(tiles, geom, ri, bases):
    """store_planes of csrc/decode.cu in numpy, index by index: blocks of 32
    segments of ``ri`` MCUs, one pass per MCU of a segment, 128 threads, a
    thread's lane its segment, a row of a store unit per step; 16, 8 or
    single bytes by the address, which starts at ``bases[comp]``. ``tiles``
    is ``[MCUs, tile_stride]`` int16. Returns the planes and the number of
    stores of each width."""
    samp = tuple(map(tuple, geom.samplings))
    units = F.plane_offsets(samp)
    dus = len(geom.du_to_comp)
    shapes = F.plane_shapes(geom)
    planes = [np.zeros(h * w, np.uint8) for h, w in shapes]
    written = [np.zeros(h * w, np.int32) for h, w in shapes]
    stores = {16: 0, 8: 0, 1: 0}
    n_mcu = geom.width_mcus * geom.height_mcus
    nseg = -(-n_mcu // ri)

    def put(comp, at, samples):
        addr = bases[comp] + at
        if len(samples) == 16 and addr % 16 == 0:
            chunks = [samples]
        else:
            chunks = [samples[i:i + 8] for i in range(0, len(samples), 8)]
        for chunk in chunks:
            a = bases[comp] + at
            if len(chunk) == 16 or a % 8 == 0:
                stores[len(chunk)] += 1
            else:
                stores[1] += 8
            planes[comp][at:at + len(chunk)] = chunk
            written[comp][at:at + len(chunk)] += 1
            at += len(chunk)

    for seg0 in range(0, nseg, SEGS):
        for m in range(ri):
            for tid in range(THREADS):
                sl = tid & (SEGS - 1)
                mcu = (seg0 + sl) * ri + m
                if seg0 + sl >= nseg or mcu >= n_mcu:
                    continue  # pos.my < 0
                my, mx = divmod(mcu, geom.width_mcus)
                px = tiles[mcu]
                for t in range(tid >> 5, len(units) * 8, THREADS >> 5):
                    u, py = t >> 3, t & 7
                    d, pair, urow, ucol = units[u]
                    comp = geom.du_to_comp[d]
                    h, v = samp[comp]
                    pitch = geom.width_mcus * 8 * h
                    row = my * v * 8 + urow + py
                    col = mx * h * 8 + ucol
                    c = d * 64 + py * 8
                    samples = list(px[c:c + 8])
                    if pair:
                        samples += list(px[c + 64:c + 72])
                    put(comp, row * pitch + col, samples)
    for w in written:
        assert (w == 1).all()  # every sample once, none outside
    return [p.reshape(s) for p, s in zip(planes, shapes)], stores


@pytest.mark.parametrize("ri", INTERVALS)
@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("sampling,rgb", STREAMS)
def test_store_units_place_every_sample_like_the_plain_planes_and_golden(
        sampling, rgb, h, w, ri, test_image):
    data = encoder.encode(test_image(h, w, "noise"), sampling=sampling,
                          quality=90, restart_interval_mcus=ri)
    data = rgb_ids(data) if rgb else data
    img = analyze(data)
    geom = Decoder(device="cpu").prepare(data).geom
    assert geom.ri == ri and bool(geom.rgb) == rgb
    dus, n_mcu = len(geom.du_to_comp), geom.total_mcus
    pixels = np.random.default_rng(h + ri).integers(
        0, 256, (n_mcu * dus, 64), dtype=np.uint8)
    want = golden.assemble_planes(img, pixels)
    nseg = -(-n_mcu // ri)
    blocks = np.zeros((nseg * ri, dus, 64), np.int32)
    blocks[:n_mcu] = pixels.reshape(n_mcu, dus, 64)
    plain = C.component_planes(
        torch.from_numpy(blocks).reshape(nseg, ri, dus, 64), geom)
    for p, q in zip(plain, want):
        assert np.array_equal(p.numpy(), q)
    # the kernel's walk over the kernel's tile: 64 elements a data unit,
    # the segment stride padded
    stride = tile_stride(dus, 2)
    tiles = np.full((n_mcu, stride), -1, np.int16)
    tiles[:, :dus * 64] = pixels.reshape(n_mcu, dus * 64)
    hs = [hh for hh, _ in geom.samplings]
    for bases in ([0] * 3, [8] * 3, [3] * 3):
        got, stores = kernel_store_planes(tiles, geom, ri, bases)
        for p, q in zip(got, want):
            assert np.array_equal(p, q)
        routes = {F.plane_store_route(b, hh) for b, hh in zip(bases, hs)}
        assert (stores[16] > 0) == ("16-byte" in routes)
        assert (stores[1] > 0) == ("byte" in routes)
        assert (stores[8] > 0) == ("8-byte" in routes or (
            "byte" not in routes and any(hh % 2 for hh in hs)))


def test_store_units_of_each_sampling():
    """Data units pair up where a component has an even number of them side
    by side: (du, pair, row, col)."""
    one = ((1, 1), (1, 1))
    assert F.plane_offsets(((1, 1),)) == ((0, 0, 0, 0),)
    assert F.plane_offsets(((2, 1),) + one) == (
        (0, 1, 0, 0), (2, 0, 0, 0), (3, 0, 0, 0))
    assert F.plane_offsets(((2, 2),) + one) == (
        (0, 1, 0, 0), (2, 1, 8, 0), (4, 0, 0, 0), (5, 0, 0, 0))
    assert F.plane_offsets(((1, 2),) + one) == (
        (0, 0, 0, 0), (1, 0, 8, 0), (2, 0, 0, 0), (3, 0, 0, 0))
    assert F.plane_offsets(((4, 1),) + one) == (
        (0, 1, 0, 0), (2, 1, 0, 16), (4, 0, 0, 0), (5, 0, 0, 0))
    for samp in (((1, 1),) * 3, ((2, 2),) + one, ((4, 1),) + one):
        units = F.plane_offsets(samp)
        # every data unit in exactly one unit, at most 6 units
        covered = sorted(d + k for d, pair, _, _ in units
                         for k in range(1 + pair))
        assert covered == list(range(sum(h * v for h, v in samp)))
        assert len(units) <= 6


A = 0x7F0000000000  # a 512-byte aligned base, as the allocator hands out


@pytest.mark.parametrize("ptr,h,route", [
    (A, 2, "16-byte"), (A, 4, "16-byte"), (A, 1, "8-byte"),
    (A + 8, 2, "8-byte"), (A + 8, 1, "8-byte"), (A + 16, 2, "16-byte"),
    (A + 1, 2, "byte"), (A + 4, 1, "byte"), (A + 12, 4, "byte"),
])
def test_plane_store_route_is_a_function_of_the_base_address(ptr, h, route):
    assert F.plane_store_route(ptr, h) == route


def test_pitches_and_offsets_keep_the_base_alignment(test_image):
    """Why the base alone decides: every row pitch, MCU step and unit column
    is a multiple of 8, and of 16 where units pair."""
    for sampling, rgb in STREAMS:
        data = encoder.encode(test_image(17, 37), sampling=sampling,
                              restart_interval_mcus=1)
        dec = Decoder(device="cpu")
        pf = dec.prepare(data)
        p = F._params(dec.upload(pf), pf.nseg, pf.tables, pf.geom)
        for u in range(p.plane_units):
            comp = p.du_to_comp[p.unit_du[u]]
            align = 16 if p.unit_pair[u] else 8
            assert p.plane_pitch[comp] % align == 0
            assert p.unit_col[u] % align == 0
            assert (p.comp_h[comp] * 8) % align == 0
            assert p.plane_pitch[comp] == F.plane_shapes(pf.geom)[comp][1]


def transpose8_table():
    """The exchange stages of transpose8, read from the comment table of
    csrc/decode.cu: [(mask, [(lo, hi), ...]), ...] in order."""
    stages = re.findall(r"transpose8 stage mask (\d): ((?:\(\d,\d\) ?)+)",
                        source())
    return [(int(m), [tuple(map(int, p)) for p in
                      re.findall(r"\((\d),(\d)\)", pairs)])
            for m, pairs in stages]


def test_transpose8_table_is_what_the_code_unrolls():
    """transpose8_stage<M> exchanges (lo, lo | M) for every lo without bit
    M; transpose8 runs the masks 4, 2, 1."""
    table = transpose8_table()
    assert [m for m, _ in table] == [4, 2, 1]
    for m, pairs in table:
        assert pairs == [(lo, lo | m) for lo in range(8) if not lo & m]
    src = source()
    calls = re.findall(r"transpose8_stage<(\d)>\(a, lane & (\d)\);", src)
    assert calls == [("4", "4"), ("2", "2"), ("1", "1")]
    assert "const int hi = lo | M;" in src and "if (lo & M) continue;" in src


@pytest.mark.parametrize("seed", [0, 1])
def test_transpose8_shuffle_network_is_a_transposition(seed):
    """Eight lanes, eight registers each, a[lane][r] = M[r][lane]; after the
    stages of the table lane c holds M[c][k] in register k. A lane with the
    stage's bit clear sends `hi` and receives into `hi`, its partner
    (lane ^ mask) sends `lo` and receives into `lo`; uint32 values."""
    m = np.random.default_rng(seed).integers(0, 1 << 32, (8, 8),
                                             dtype=np.uint64).astype(np.uint32)
    a = [[m[r][lane] for r in range(8)] for lane in range(8)]
    for mask, pairs in transpose8_table():
        for lo, hi in pairs:
            sent = [a[lane][lo] if lane & mask else a[lane][hi]
                    for lane in range(8)]
            for lane in range(8):
                got = sent[lane ^ mask]  # __shfl_xor_sync
                if lane & mask:
                    a[lane][lo] = got
                else:
                    a[lane][hi] = got
    assert np.array_equal(np.array(a, dtype=np.uint32), m)  # a[c][k] = M[c][k]
    cols = np.array([[m[r][lane] for r in range(8)] for lane in range(8)])
    assert np.array_equal(np.array(a, dtype=np.uint32), cols.T)


def test_params_carry_the_store_units():
    samp = ((2, 2), (1, 1), (1, 1))
    units = F.plane_offsets(samp)
    p = _build.make_params(7, 3, 2, 13, (0, 0, 0, 0, 1, 2), samplings=samp,
                           width_mcus=5, planes=units)
    assert p.plane_units == 4
    assert list(p.unit_du[:4]) == [0, 2, 4, 5]
    assert list(p.unit_pair[:4]) == [1, 1, 0, 0]
    assert list(p.unit_row[:4]) == [0, 8, 0, 0]
    assert list(p.unit_col[:4]) == [0, 0, 0, 0]
    assert list(p.plane_pitch) == [80, 40, 40]
    assert not any(p.unit_du[4:]) and not any(p.unit_pair[4:])
    none = _build.make_params(7, 3, 2, 13, (0, 0, 0, 0, 1, 2), samplings=samp)
    assert none.plane_units == 0 and not any(none.plane_pitch)


def test_tile_is_16_bit_in_every_mode():
    """No mode specialises the tile any more: 16-bit elements, 128 threads
    and eight blocks a multiprocessor, the DC beside the tile."""
    src = source()
    assert "struct Tile<" not in src
    body = re.search(r"struct Tile \{(.*?)\};", src, re.S)[1]
    assert "using T = short;" in body and "THREADS = 128" in body
    assert "BLOCKS = 8" in body
    assert f"THREADS = {THREADS}" in body
    assert "__shared__ int dc_s[K2_SEGS * 6];" in src


def test_out_planes_of_the_wrapper(test_image):
    """``out``: planes to write into, at any byte offset; the wrong shape,
    dtype or layout is refused."""
    data = encoder.encode(test_image(17, 37, "noise"), sampling="420",
                          quality=90, restart_interval_mcus=1)
    dec = Decoder(device="cpu", exact_idct=True)
    pf = dec.prepare(data)
    rows = dec.upload(pf)
    args = (rows, pf.nseg, pf.tables, pf.op, pf.geom)
    want = F.fused_decode_planes(*args, exact=True)
    shapes = F.plane_shapes(pf.geom)
    bufs = [torch.zeros(h * w + 16, dtype=torch.uint8) for h, w in shapes]
    out = [b[3:3 + h * w].reshape(h, w) for b, (h, w) in zip(bufs, shapes)]
    got = F.fused_decode_planes(*args, exact=True, out=out)
    for g, o, w in zip(got, out, want):
        assert g is o and torch.equal(g, w)
    assert all(int(b[:3].sum()) == 0 for b in bufs)
    with pytest.raises(ValueError, match="out must be"):
        F.fused_decode_planes(*args, exact=True, out=out[:2])
    with pytest.raises(ValueError, match="out must be"):
        F.fused_decode_planes(*args, exact=True,
                              out=[o.to(torch.int32) for o in out])
    with pytest.raises(ValueError, match="out must be"):
        F.fused_decode_planes(*args, exact=True, out=[o.T for o in out])
