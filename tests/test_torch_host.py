"""The port's own host layer against the JAX package's, module by module, on
the same bytes: everything here is integer or table data and must be equal
exactly (the IDCT operators too: both packages build them with the same
numpy expressions)."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import compeg_tpu.huffman as JH  # noqa: E402
import compeg_tpu.metadata as JM  # noqa: E402
import compeg_tpu.native as JN  # noqa: E402
import compeg_tpu.scan as JS  # noqa: E402
import compeg_tpu.tables as JT  # noqa: E402
from compeg_tpu import encoder  # noqa: E402
from compeg_tpu.errors import CompegError as JaxCompegError  # noqa: E402
from compeg_tpu.ops import int_idct as JI  # noqa: E402
from compeg_tpu.ops import luts as JL  # noqa: E402
import compeg_tpu_torch.huffman as H  # noqa: E402
import compeg_tpu_torch.metadata as M  # noqa: E402
import compeg_tpu_torch.native as N  # noqa: E402
import compeg_tpu_torch.scan as S  # noqa: E402
import compeg_tpu_torch.tables as T  # noqa: E402
from compeg_tpu_torch import CompegError, Decoder, ImageData  # noqa: E402
from compeg_tpu_torch.ops import int_idct as I  # noqa: E402
from compeg_tpu_torch.ops import luts as L  # noqa: E402
import compeg_tpu.profiling as JP  # noqa: E402
import compeg_tpu_torch.profiling as P  # noqa: E402
from compeg_tpu import golden as JG  # noqa: E402
from compeg_tpu_torch import encoder as PE  # noqa: E402
from compeg_tpu_torch import golden as PG  # noqa: E402
from test_torch_smoke_vectors import zrl_stream  # noqa: E402

STREAMS = [("422", 1, 24, 40), ("420", 3, 40, 72), ("444", None, 16, 24),
           ("gray", 1, 17, 37), ("411", 2, 16, 64), ("440", 5, 32, 24)]
needs_native = pytest.mark.skipif(
    not (JN.available() and N.available()),
    reason="needs a C++ compiler for both native libraries")


def stream(test_image, sampling, ri, h, w):
    return encoder.encode(test_image(h, w, "noise"), sampling=sampling,
                          quality=88, restart_interval_mcus=ri)


def plain(value):
    """Dataclasses (of either package) down to comparable builtins."""
    if dataclasses.is_dataclass(value):
        return {f.name: plain(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    if isinstance(value, np.ndarray):
        return (str(value.dtype), value.shape, value.tobytes())
    if isinstance(value, memoryview):
        return bytes(value)
    return value


@pytest.mark.parametrize("use_native", [None, False], ids=["native", "python"])
@pytest.mark.parametrize("sampling,ri,h,w", STREAMS)
def test_analyze_gives_the_same_image_data(sampling, ri, h, w, use_native,
                                           test_image):
    data = stream(test_image, sampling, ri, h, w)
    ours, theirs = M.analyze(data, use_native), JM.analyze(data, use_native)
    assert isinstance(ours, ImageData) and not isinstance(theirs, ImageData)
    assert [f.name for f in dataclasses.fields(ours)] == [
        f.name for f in dataclasses.fields(theirs)]
    assert plain(ours) == plain(theirs)
    assert ours.mcu_width == theirs.mcu_width
    assert ours.parallelism() == theirs.parallelism()


def test_errors_are_the_ports_own(test_image):
    assert CompegError is not JaxCompegError
    bad = stream(test_image, "422", 1, 16, 16)[:40]
    with pytest.raises(CompegError) as ours:
        M.analyze(bad)
    with pytest.raises(JaxCompegError) as theirs:
        JM.analyze(bad)
    assert str(ours.value) == str(theirs.value)
    assert not isinstance(ours.value, JaxCompegError)
    progressive = bytearray(stream(test_image, "422", 1, 16, 16))
    progressive[progressive.find(b"\xff\xc0") + 1] = 0xC2
    with pytest.raises(CompegError, match="baseline"):
        M.analyze(bytes(progressive))


def test_tables_and_huffman_are_equal():
    for name in ("ZIGZAG", "UNZIGZAG"):
        assert np.array_equal(getattr(T, name), getattr(JT, name)), name
    names = [n for n in dir(JT) if n.isupper()]
    assert names == [n for n in dir(T) if n.isupper()]
    for name in names:
        assert plain(getattr(T, name)) == plain(getattr(JT, name)), name
    ours, theirs = H.default_tables(), JH.default_tables()
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert plain(ours[key]) == plain(theirs[key])
        assert ours[key].encode_map() == theirs[key].encode_map()
    counts, values = theirs[(1, 0)].counts, theirs[(1, 0)].values
    assert plain(H.build_table(counts, values)) == plain(
        JH.build_table(counts, values))


@needs_native
@pytest.mark.parametrize("sampling,ri,h,w", STREAMS)
def test_native_scan_info_and_pack_rows_are_equal(sampling, ri, h, w,
                                                  test_image):
    data = stream(test_image, sampling, ri, h, w)
    img = M.analyze(data)
    n = img.total_restart_intervals
    span = dict(offset=img.scan_offset, length=len(img.scan_data))
    assert N.scan_info(data, **span) == JN.scan_info(data, **span)
    assert N.scan_info(bytes(img.scan_data)) == (
        n, max(len(s) for s in S.split_intervals(bytes(img.scan_data), n)))
    w_ = S._words_per_segment(N.scan_info(data, **span)[1]) + 1
    g = -(-n // S.SEGMENTS_PER_BLOCK)
    ours, active = N.pack_rows(data, n, w_, g, **span)
    theirs, jactive = JN.pack_rows(data, n, w_, g, **span)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    assert ours.tobytes() == theirs.tobytes()
    assert np.array_equal(active, jactive)
    # ... and equal to the Python packer, the port's and the JAX package's.
    blk = S.to_device_layout(S.split_intervals(bytes(img.scan_data), n), w_)
    jblk = JS.to_device_layout(JS.split_intervals(bytes(img.scan_data), n), w_)
    assert blk.words.tobytes() == jblk.words.tobytes()
    assert np.array_equal(blk.active, jblk.active)
    assert np.array_equal(
        blk.words.transpose(0, 2, 3, 1).reshape(-1, w_), ours)
    # into a caller's buffer, in place
    buf = np.full(ours.shape, 0xDEADBEEF, np.uint32)
    got, _ = N.pack_rows(data, n, w_, g, out=buf, **span)
    assert got is buf and np.array_equal(buf, ours)
    with pytest.raises(ValueError):
        N.pack_rows(data, n, w_, g, out=buf[:, :-1], **span)
    with pytest.raises(CompegError):
        N.pack_rows(data, n + 1, w_, g, **span)


@needs_native
def test_the_two_native_libraries_are_two_files():
    assert N.library_path() != JN._SO
    assert "compeg_tpu_torch" in N.library_path()
    assert N.load()._name == N.library_path()


def _filler(n: int, seed: int = 0) -> bytes:
    """n entropy-coded bytes with no FF among them."""
    b = np.random.default_rng(seed).integers(0, 255, n, dtype=np.uint8)
    return b.tobytes()


SCAN_ENDS = {
    # the scan's bytes after a 7-byte header; the AVX2 loop takes 32 bytes a
    # step, so the interesting bytes also lie past the first 32 and astride
    # a step's end
    "RST markers": _filler(40) + b"\xFF\xD0" + _filler(30, 1) + b"\xFF\xD7"
    + _filler(5, 2) + b"\xFF\xD9",
    "stuffed FF 00": _filler(33) + b"\xFF\x00\xFF\x00" + _filler(40, 1)
    + b"\xFF\xC4\x00",
    "FF FF fill before a marker": _filler(45) + b"\xFF\xFF\xFF\xFF\xD9",
    "a marker astride a 32-byte step": _filler(24) + b"\xFF\xDA",
    "trailing lone FF": _filler(70) + b"\xFF",
    "no terminating marker": _filler(70) + b"\xFF\x00\xFF\xD3"
    + _filler(10, 1),
    "empty scan": b"",
}


@needs_native
@pytest.mark.parametrize("name", list(SCAN_ENDS))
def test_find_scan_end_equals_the_jax_one(name):
    """The port's native scan-end search, the JAX package's and the port
    parser's numpy search agree at every start in the first 40 bytes and on
    a bytearray."""
    from compeg_tpu_torch import parser as PP

    data = b"\xFF\xD8\xFF\xDA\x00\x08\x01" + SCAN_ENDS[name]
    ends = set()
    for offset in range(0, min(len(data), 40)):
        end = N.find_scan_end(data, offset)
        assert end == JN.find_scan_end(data, offset) == PP.scan_end(
            data, offset), offset
        ends.add(end)
    assert N.find_scan_end(bytearray(data), 7) == JN.find_scan_end(data, 7)
    if name in ("trailing lone FF", "no terminating marker", "empty scan"):
        assert N.find_scan_end(data, 7) == len(data)
    else:
        assert data[N.find_scan_end(data, 7) + 1] not in (0x00, 0xFF)


@needs_native
def test_the_parser_calls_the_native_scan_end_search(monkeypatch, test_image):
    """parse_segments finds each scan's end with native.find_scan_end when
    the library is built (one call a scan), and the numpy search finds the
    same segments."""
    from compeg_tpu_torch import parser as PP

    data = stream(test_image, "422", 2, 24, 40)
    calls = []
    find = N.find_scan_end

    def counted(buf, offset=0):
        calls.append(offset)
        return find(buf, offset)

    monkeypatch.setattr(N, "find_scan_end", counted)
    dump = PP.dump_segments(data)
    assert calls == [M.analyze(data).scan_offset]
    monkeypatch.setattr(N, "available", lambda: False)
    assert PP.dump_segments(data) == dump and len(calls) == 1


def test_a_native_scan_end_error_is_raised(monkeypatch, test_image):
    """An error in the native search reaches the caller: the parser does
    not fall back to the numpy search behind it."""
    from compeg_tpu_torch import parser as PP

    def broken(buf, offset=0):
        raise RuntimeError("native scan-end search failed")

    monkeypatch.setattr(N, "available", lambda: True)
    monkeypatch.setattr(N, "find_scan_end", broken)
    with pytest.raises(RuntimeError, match="scan-end search failed"):
        PP.parse_segments(stream(test_image, "422", 1, 16, 16))


def test_python_and_native_prepare_agree(monkeypatch, test_image):
    data = stream(test_image, "420", 2, 40, 72)
    native_pf = Decoder(device="cpu").prepare(data)
    monkeypatch.setattr(N, "available", lambda: False)
    python_pf = Decoder(device="cpu").prepare(data)
    assert python_pf.packer == "python"
    if native_pf.packer == "native":
        assert np.array_equal(native_pf.rows, python_pf.rows)


def test_split_intervals_rejects_a_wrong_count(test_image):
    data = stream(test_image, "422", 1, 16, 32)
    img = M.analyze(data)
    scan = bytes(img.scan_data)
    n = img.total_restart_intervals
    assert S.split_intervals(scan, n) == JS.split_intervals(scan, n)
    with pytest.raises(CompegError, match="restart intervals"):
        S.split_intervals(scan, n + 1)
    with pytest.raises(CompegError, match="too small"):
        S.to_device_layout(S.split_intervals(scan, n), 1)
    assert (S.SEGMENTS_PER_BLOCK, S.GUARD_WORDS) == (
        JS.SEGMENTS_PER_BLOCK, JS.GUARD_WORDS)


@pytest.mark.parametrize("retained", [64, 32, 1])
def test_luts_operators_are_equal(retained):
    rng = np.random.default_rng(3)
    qz = rng.integers(1, 256, (4, 64)).astype(np.int32)
    assert np.array_equal(L.dct_basis(), JL.dct_basis())
    assert np.array_equal(L.idct_matrix_zigzag(retained),
                          JL.idct_matrix_zigzag(retained))
    assert np.array_equal(L.idct_dequant_matrices(qz, retained),
                          JL.idct_dequant_matrices(qz, retained))
    for k in (1, 2, 4, 8):
        assert np.array_equal(L.scaled_idct_matrix_zigzag(k, retained),
                              JL.scaled_idct_matrix_zigzag(k, retained)), k
        assert np.array_equal(
            L.scaled_idct_dequant_matrices(qz, k, retained),
            JL.scaled_idct_dequant_matrices(qz, k, retained)), k
    assert not hasattr(L, "idct_dequant_matrices_paired")


def test_integer_idct_specification_is_equal():
    """idct_2d_rows on random int16-range blocks, whose int32 sums wrap."""
    rng = np.random.default_rng(5)
    blocks = rng.integers(-32768, 32768, (8, 8, 257)).astype(np.int32)
    cols = [[blocks[r, c] for c in range(8)] for r in range(8)]
    with np.errstate(over="ignore"):
        ours, theirs = I.idct_2d_rows(cols), JI.idct_2d_rows(cols)
        one = I.idct_1d(cols[3], 11)
        jone = JI.idct_1d(cols[3], 11)
    for r in range(8):
        assert np.array_equal(one[r], jone[r])
        for c in range(8):
            assert np.array_equal(ours[r][c], theirs[r][c]), (r, c)
    assert I.descale(np.int32(-5), 2) == JI.descale(np.int32(-5), 2)
    assert (I.CONST_BITS, I.PASS1_BITS) == (JI.CONST_BITS, JI.PASS1_BITS)
    assert not hasattr(I, "mxu_operators")


def test_profiling_stage_stats_behave_like_the_jax_packages(test_image):
    import torch

    P.reset_stats()
    JP.reset_stats()
    for mod in (P, JP):
        with mod.stage_timer("parse"):
            pass
        with mod.stage_timer("parse"):
            pass
    ours, theirs = P.get_stats(), JP.get_stats()
    assert ours.keys() == theirs.keys() == {"parse"}
    assert ours["parse"].count == theirs["parse"].count == 2
    assert [f.name for f in dataclasses.fields(ours["parse"])] == [
        f.name for f in dataclasses.fields(theirs["parse"])]
    assert ours["parse"].mean_ms >= 0 and P.StageStats().mean_ms == 0.0
    P.log_stats()
    # the Decoder feeds the port's stats, not the JAX package's
    Decoder(device="cpu").prepare(stream(test_image, "422", 1, 16, 16))
    assert {"parse", "preprocess"} <= P.get_stats().keys()
    assert JP.get_stats().keys() == {"parse"}
    P.reset_stats()
    assert P.get_stats() == {}
    # device timing needs a device: no host clock under that name
    cpu = torch.zeros(4)
    P.hard_sync(cpu)
    P.hard_sync((cpu, cpu))
    with pytest.raises(RuntimeError, match="CUDA"):
        P.trace_device_ms(lambda: cpu)


# -- golden and the encoder ---------------------------------------------------


@pytest.mark.parametrize("quality", [60, 88])
@pytest.mark.parametrize("sampling,ri,h,w", STREAMS)
def test_encoder_gives_the_same_bytes(sampling, ri, h, w, quality,
                                      test_image):
    """The port's encoder against the JAX package's, byte for byte: with
    tables and restart markers, without DHT (the Annex K defaults), without
    DRI, and (gray) from a 2-D array without APP0."""
    img = test_image(h, w, "noise", seed=quality)
    for extra in ({}, {"emit_dht": False}, {"restart_interval_mcus": None}):
        kw = {"sampling": sampling, "quality": quality,
              "restart_interval_mcus": ri, **extra}
        assert PE.encode(img, **kw) == encoder.encode(img, **kw), extra
    if sampling == "gray":
        kw = dict(sampling="gray", quality=quality, app0=False)
        assert PE.encode(img[..., 1], **kw) == encoder.encode(img[..., 1],
                                                              **kw)
    with pytest.raises(CompegError, match="unknown sampling"):
        PE.encode(img, sampling="421")


def same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("sampling,ri,h,w", STREAMS + [("zrl", 1, 32, 48)])
def test_golden_gives_the_same_arrays(sampling, ri, h, w, test_image):
    """The port's golden against the JAX package's, array for array: the
    coefficients (raw and dequantized, +16 and +17 ZRL), every IDCT of
    decode_rgb, the compat ZRL, the scaled decodes, 32 retained
    coefficients, and the component planes."""
    data = (zrl_stream() if sampling == "zrl"
            else stream(test_image, sampling, ri, h, w))
    ours, theirs = M.analyze(data), JM.analyze(data)
    for dequant in (False, True):
        for zrl17 in (False, True):
            assert same(PG.decode_coefficients(ours, dequant, zrl17),
                        JG.decode_coefficients(theirs, dequant, zrl17))
    for kw in ({"idct": "float"}, {"idct": "int"}, {"idct": "aan"},
               {"zrl17": True, "idct": "int"}, {"zrl17": True},
               {"scale_blocks": 1}, {"scale_blocks": 2}, {"scale_blocks": 4},
               {"retained_coefficients": 32},
               {"retained_coefficients": 32, "idct": "int"}):
        got = PG.decode_rgb(data, **kw)
        assert same(got, JG.decode_rgb(data, **kw)), kw
        assert got.shape[:2] == PG.scaled_size(ours, kw.get("scale_blocks",
                                                            8))
    assert same(PG.decode_rgb(ours), JG.decode_rgb(theirs))
    raw = PG.decode_coefficients(ours, dequant=False)
    for pixels, jpixels, blk in (
            (PG.idct_pixels_raw(raw, ours), JG.idct_pixels_raw(raw, theirs),
             8),
            (PG.idct_pixels_int(raw, ours), JG.idct_pixels_int(raw, theirs),
             8),
            (PG.idct_pixels_scaled(raw, ours, 2),
             JG.idct_pixels_scaled(raw, theirs, 2), 2)):
        planes = PG.assemble_planes(ours, pixels, blk)
        jplanes = JG.assemble_planes(theirs, jpixels, blk)
        assert len(planes) == len(jplanes) == len(ours.components)
        assert all(same(a, b) for a, b in zip(planes, jplanes))
    assert same(PG.idct_pixels(raw[:7].astype(np.int32) * 3),
                JG.idct_pixels(raw[:7].astype(np.int32) * 3))


def test_golden_refuses_what_the_jax_packages_refuses(test_image):
    data = stream(test_image, "422", 1, 16, 16)
    with pytest.raises(CompegError, match="idct='float' only"):
        PG.decode_rgb(data, idct="int", scale_blocks=2)
    with pytest.raises(JaxCompegError, match="idct='float' only"):
        JG.decode_rgb(data, idct="int", scale_blocks=2)
    assert PG.huff_extend(5, 3) == JG.huff_extend(5, 3) == 5
    assert PG.huff_extend(2, 3) == JG.huff_extend(2, 3) == -5
    ycc = np.random.default_rng(1).integers(0, 256, (3, 9, 11), np.uint8)
    assert same(PG.ycbcr_to_rgb_reference(*ycc),
                JG.ycbcr_to_rgb_reference(*ycc))


def _mjpeg_buffers(test_image):
    frames = [encoder.encode(test_image(16, 32, "noise", seed=s),
                             sampling="422", emit_dht=False,
                             restart_interval_mcus=1) for s in range(3)]
    return [b"".join(frames),
            b"junk" + frames[0] + b"\x00\x01pad" + frames[1] + b"\xff"
            + frames[2] + b"tail\xff",
            frames[0][:-7],  # a frame cut short: no frame at all
            b"", b"\xff\xd8\xff\xd9"]


def test_mjpeg_splits_like_the_jax_package(test_image):
    """The port's mjpeg module is a copy: split_frames, and the assembler
    fed in chunks, give the JAX package's frames on the same buffers, junk
    between frames and a marker split across chunks included."""
    import compeg_tpu.mjpeg as JMJ
    import compeg_tpu_torch.mjpeg as MJ

    for buf in _mjpeg_buffers(test_image):
        want = list(JMJ.split_frames(buf))
        assert list(MJ.split_frames(buf)) == want
        for cut in (1, 7, len(buf) // 2, len(buf) - 1):
            asm, jasm = MJ.FrameAssembler(), JMJ.FrameAssembler()
            got = list(asm.feed(buf[:cut])) + list(asm.feed(buf[cut:]))
            assert got == list(jasm.feed(buf[:cut])) + list(
                jasm.feed(buf[cut:])) == want
        assert MJ.concat_frames(want) == JMJ.concat_frames(want)


def test_v4l2_abi_is_the_jax_packages():
    """Every ctypes structure's size and every ioctl code of the port's
    v4l2 equal the JAX package's (itself pinned to the kernel's published
    values by tests/test_v4l2.py), and so does fourcc."""
    import ctypes

    import compeg_tpu.v4l2 as JV
    import compeg_tpu_torch.v4l2 as V

    for name in ("Capability", "PixFormat", "Format", "RequestBuffers",
                 "Timecode", "Buffer"):
        assert ctypes.sizeof(getattr(V, name)) == ctypes.sizeof(
            getattr(JV, name)), name
    codes = [n for n in dir(JV) if n.startswith(("VIDIOC_", "BUF_", "CAP_",
                                                 "MEMORY_", "FIELD_",
                                                 "PIX_FMT_"))]
    assert len(codes) >= 15
    for name in codes:
        assert getattr(V, name) == getattr(JV, name), name
    assert V.VIDIOC_DQBUF == 0xC0585611 and V.VIDIOC_S_FMT == 0xC0D05604
    for code in ("MJPG", "JPEG", "YUYV", "\x01\x02\x03\x04"):
        assert V.fourcc(code) == JV.fourcc(code)
