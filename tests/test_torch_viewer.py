"""The port's front ends on device="cpu": the viewer
(compeg_tpu_torch/tools/viewer.py) on a stdin pipe and an MJPEG file
through its CLI, in process with --loop, --scale and --preview, its ANSI
preview held to examples/viewer.py's (loaded by path: its module level
imports only numpy), its refusal of --device cuda without a card; the
encoder tool (compeg_tpu_torch/tools/enc.py) round trip; and the top-level
decode_scaled. Mirrors of tests/test_aux.py:52-72 and :98-197."""

import importlib.util
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import compeg_tpu_torch as T  # noqa: E402
from compeg_tpu_torch.tools import viewer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def frames(test_image, n=3, h=16, w=16):
    return [T.encoder.encode(test_image(h, w, "noise", seed=s),
                             sampling="422", restart_interval_mcus=1)
            for s in range(n)]


def run(args, **kw):
    return subprocess.run([sys.executable, "-m"] + args, capture_output=True,
                          timeout=300, cwd=ROOT, **kw)


def jax_viewer():
    spec = importlib.util.spec_from_file_location(
        "jax_viewer", os.path.join(ROOT, "examples", "viewer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_viewer_stdin_pipe(tmp_path, test_image):
    """'-' decodes an MJPEG byte stream from stdin (a camera daemon or
    ffmpeg piping raw MJPG)."""
    outdir = tmp_path / "out"
    r = run(["compeg_tpu_torch.tools.viewer", "-", "--save-dir", str(outdir),
             "--stats-every", "2", "--device", "cpu"],
            input=b"".join(frames(test_image)))
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert b"done: 3 frames" in r.stdout
    assert len(sorted(outdir.glob("*.png"))) == 3


def test_viewer_mjpeg_cli(tmp_path, test_image):
    """An .mjpeg container end to end through the CLI, the saved PNGs
    equal to the port's Decoder frame by frame."""
    from PIL import Image

    fs = frames(test_image)
    src = tmp_path / "cap.mjpeg"
    src.write_bytes(b"".join(fs))
    outdir = tmp_path / "out"
    r = run(["compeg_tpu_torch.tools.viewer", str(src), "--save-dir",
             str(outdir), "--stats-every", "2", "--device", "cpu"])
    assert r.returncode == 0, (r.stdout, r.stderr)
    pngs = sorted(outdir.glob("*.png"))
    dec = T.Decoder(device="cpu")
    assert len(pngs) == 3
    for png, f in zip(pngs, fs):
        assert np.array_equal(np.asarray(Image.open(png)), dec.decode(f))


def test_viewer_in_process_loop_scale_and_preview(tmp_path, test_image,
                                                  capsys):
    """main(argv) in process: --loop 2 gives every frame twice, in order,
    each equal to Decoder().decode; --scale 2 equals decode_scaled; the
    preview draws a frame with render_ansi."""
    fs = frames(test_image, h=16, w=32)
    src = tmp_path / "cap.mjpg"
    src.write_bytes(b"".join(fs))
    dec = T.Decoder(device="cpu")
    got = []
    n = viewer.main([str(src), "--loop", "2", "--device", "cpu"],
                    on_frame=lambda i, rgb: got.append((i, rgb)))
    assert n == 6 and [i for i, _ in got] == list(range(6))
    for k, (_, rgb) in enumerate(got):
        assert np.array_equal(rgb, dec.decode(fs[k % 3]))
    thumbs = []
    viewer.main([str(src), "--scale", "2", "--device", "cpu"],
                on_frame=lambda i, rgb: thumbs.append(rgb))
    assert len(thumbs) == 3
    for rgb, f in zip(thumbs, fs):
        assert rgb.shape == (4, 8, 3)
        assert np.array_equal(rgb, dec.decode_scaled(f, 2))
    capsys.readouterr()
    viewer.main([str(src), "--preview", "--preview-width", "8",
                 "--device", "cpu", "--scale", "1"])
    out = capsys.readouterr().out
    want = "".join(viewer.render_ansi(dec.decode_scaled(f, 1), 8) + "\n"
                   for f in fs)
    assert out.startswith("\x1b[2J" + want)
    assert out.count("▀") == 3 * 4  # 2 x 4 thumbnails: one row of 4 cells


def test_viewer_cuda_without_a_card_fails(tmp_path, test_image):
    """--device cuda (the default) must fail where there is no card, not
    fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    src = tmp_path / "one.jpg"
    src.write_bytes(frames(test_image, n=1)[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        viewer.main([str(src)])
    with pytest.raises(RuntimeError, match="CUDA"):
        viewer.main([str(src), "--scale", "1"])


def test_render_ansi_is_the_jax_viewers():
    """The preview sink is a copy: the same string as examples/viewer.py's
    render_ansi on flat, split, ragged and tiny frames."""
    ref = jax_viewer()
    rng = np.random.default_rng(3)
    rgb = np.zeros((40, 80, 3), np.uint8)
    rgb[:20] = (255, 0, 0)
    rgb[20:] = (0, 0, 255)
    cases = [(rgb, 20), (np.full((32, 64, 3), 77, np.uint8), 16),
             (rng.integers(0, 256, (37, 53, 3), dtype=np.uint8), 96),
             (rng.integers(0, 256, (9, 200, 3), dtype=np.uint8), 33)]
    for shape in ((1, 16, 3), (16, 1, 3), (1, 1, 3), (8, 8, 3)):
        cases.append((rng.integers(0, 256, shape, dtype=np.uint8), 96))
    for frame, cols in cases:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert viewer.render_ansi(frame, cols) == ref.render_ansi(frame,
                                                                      cols)
    s = viewer.render_ansi(rgb, cols=20)
    lines = s.split("\n")
    assert lines[0] == "\x1b[H"
    assert len(lines[1:]) == 5 and all(r.count("▀") == 20 for r in lines[1:])
    assert "\x1b[38;2;255;0;0m" in lines[1] and "\x1b[48;2;0;0;255m" in lines[-1]


def test_enc_tool_roundtrip(tmp_path, test_image):
    """tools/enc.py encodes a PNG through the port's encoder, byte for byte
    the encoder called directly."""
    from PIL import Image

    img = test_image(16, 16)
    src = tmp_path / "in.png"
    out = tmp_path / "out.jpg"
    Image.fromarray(img).save(src)
    r = run(["compeg_tpu_torch.tools.enc", str(src), str(out), "--sampling",
             "422", "--ri", "1"])
    assert r.returncode == 0, r.stderr
    data = out.read_bytes()
    meta = T.analyze(data)
    assert meta.width == 16 and meta.restart_interval == 1
    assert data == T.encoder.encode(img, sampling="422", quality=90,
                                    restart_interval_mcus=1)


def test_top_level_decode_scaled(test_image):
    data = T.encoder.encode(test_image(24, 40, "noise"), sampling="420",
                            restart_interval_mcus=2)
    dec = T.Decoder(device="cpu")
    for k in (1, 2, 4, 8):
        assert np.array_equal(T.decode_scaled(data, k, device="cpu"),
                              dec.decode_scaled(data, k))
    assert {"decode_scaled", "CanonicalTable", "build_table",
            "default_tables", "parser", "scan", "mjpeg"} <= set(T.__all__)
    assert T.build_table is T.huffman.build_table
