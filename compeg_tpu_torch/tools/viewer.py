"""Streaming decode viewer / throughput monitor on the port.

The counterpart of examples/viewer.py (itself the analogue of the
reference's ``examples/viewer.rs``: decode an MJPEG webcam stream frame by
frame into the render pipeline). Without a display server it streams JPEG
frames — from files, ``.mjpeg`` containers, stdin, a V4L2 camera, or one
file looped — through the port's pipelined ``StreamDecoder`` and reports
live fps; ``--preview`` draws each frame in the terminal and
``--save-dir`` writes PNGs.

    python -m compeg_tpu_torch.tools.viewer frame.jpg --loop 100
    python -m compeg_tpu_torch.tools.viewer capture.mjpeg --scale 1 --preview
    ffmpeg -f v4l2 -i /dev/video0 -c copy -f mjpeg - | \\
        python -m compeg_tpu_torch.tools.viewer -

Full-scale frames go through ``StreamDecoder.decode_iter`` (kernel K2) and
``to_rgb``; ``--scale k < 8`` decodes frame by frame with one ``Decoder`` on
the same device and its public ``decode_scaled`` (kernel K2s).
``--device`` is ``cuda`` by default and fails where there is no card;
``--device cpu`` runs the kernels' plain PyTorch versions.
"""

import argparse
import itertools
import logging
import os
import sys
import time

import numpy as np


def render_ansi(rgb, cols: int) -> str:
    """Render an [H, W, 3] u8 frame as ANSI truecolor half-blocks.

    Each character cell shows two vertically stacked pixels (fg = top via
    '▀', bg = bottom), so a cols-wide preview is cols x (cols*H/W) pixels.
    Box-filter downsample with numpy; one string per frame, drawn with a
    cursor-home so successive frames overdraw in place (flicker-free)."""
    h, w = rgb.shape[:2]
    # Degenerate 1-pixel dimensions: duplicate so every box has area >= 1.
    if h < 2:
        rgb = np.repeat(rgb, 2, axis=0)
        h = rgb.shape[0]
    if w < 2:
        rgb = np.repeat(rgb, 2, axis=1)
        w = rgb.shape[1]
    cols = max(2, min(cols, w))
    # Even row count (2 pixels per cell), capped at h so box edges are
    # strictly increasing (no zero-area boxes, no dropped row/col 0).
    rows = max(2, min(h // 2 * 2, round(cols * h / w / 2) * 2))
    ys = np.arange(rows + 1) * h // rows
    xs = np.arange(cols + 1) * w // cols
    c = np.zeros((h + 1, w + 1, 3), np.float64)
    c[1:, 1:] = rgb.astype(np.float64).cumsum(0).cumsum(1)
    area = (ys[1:] - ys[:-1])[:, None] * (xs[1:] - xs[:-1])[None, :]
    small = (
        c[ys[1:]][:, xs[1:]] - c[ys[:-1]][:, xs[1:]]
        - c[ys[1:]][:, xs[:-1]] + c[ys[:-1]][:, xs[:-1]]
    ) / area[..., None]
    px = small.round().clip(0, 255).astype(np.uint8)
    top, bot = px[0::2], px[1::2]
    lines = ["\x1b[H"]
    for tr, br in zip(top, bot):
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(tr, br)
        ]
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "inputs", nargs="+",
        help="JPEG/.mjpeg files, a /dev/video* camera (captured live as "
        "MJPG via compeg_tpu_torch.v4l2, the reference viewer's webcam "
        "mode), or '-' to read an MJPEG byte stream from stdin (e.g. "
        "`ffmpeg -f v4l2 -i /dev/video0 -c copy -f mjpeg - | viewer -`)",
    )
    ap.add_argument(
        "--max-frames", type=int, default=None,
        help="with a /dev/video* input: stop after this many frames",
    )
    ap.add_argument(
        "--camera-size", default=None, metavar="WxH",
        help="with a /dev/video* input: request this capture size",
    )
    ap.add_argument("--loop", type=int, default=0, help="loop the input N times")
    ap.add_argument(
        "--follow", action="store_true",
        help="tail a growing .mjpeg file, decoding frames as they are "
        "appended (file-based live feed)",
    )
    ap.add_argument(
        "--idle-timeout", type=float, default=None,
        help="with --follow: stop after this many seconds without growth",
    )
    ap.add_argument("--save-dir", default=None,
                    help="write each frame as a PNG here (needs Pillow)")
    ap.add_argument(
        "--preview", action="store_true",
        help="render each decoded frame to the terminal as ANSI truecolor "
        "half-blocks (the render-pass role of the reference viewer, "
        "display-server-free)",
    )
    ap.add_argument(
        "--preview-width", type=int, default=96,
        help="terminal columns for --preview",
    )
    ap.add_argument(
        "--scale", type=int, default=8, choices=(1, 2, 4, 8),
        help="decode at scale/8 resolution (DCT-domain thumbnail decode; "
        "1 = 1/8-scale previews with 64x less output — ideal for --preview)",
    )
    ap.add_argument("--stats-every", type=int, default=30)
    ap.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="torch device of the decode (default cuda; fails when there is "
        "no card)",
    )
    return ap.parse_args(argv)


def frame_source(args):
    """The frames the inputs name, in order: a list for files (looped
    ``--loop`` times), a lazy iterator for live sources."""
    from compeg_tpu_torch import mjpeg

    def frame_iter():
        for f in args.inputs:
            if f.startswith("/dev/video"):
                from compeg_tpu_torch import v4l2

                size = None
                if args.camera_size:
                    w, h = args.camera_size.lower().split("x")
                    size = (int(w), int(h))
                yield from v4l2.capture_frames(
                    f, size=size, max_frames=args.max_frames
                )
            elif f == "-":
                yield from mjpeg.frames_from_stream(sys.stdin.buffer)
            elif args.follow:
                yield from mjpeg.follow_frames(
                    f, idle_timeout_s=args.idle_timeout
                )
            elif f.lower().endswith((".mjpeg", ".mjpg")):
                yield from mjpeg.frames_from_file(f)
            else:
                with open(f, "rb") as fh:
                    yield fh.read()

    live = any(f == "-" or f.startswith("/dev/video") for f in args.inputs)
    if live or args.follow:
        return frame_iter()  # live sources stream lazily
    frames = list(frame_iter())
    if args.loop:
        frames = list(itertools.chain.from_iterable([frames] * args.loop))
    return frames


def main(argv=None, on_frame=None) -> int:
    """Run the viewer on ``argv`` (``sys.argv[1:]`` by default). With
    ``on_frame``, ``on_frame(n, rgb)`` receives each decoded frame as an
    ``[H, W, 3]`` u8 array, in order. Returns the number of frames."""
    args = parse_args(argv)
    from compeg_tpu_torch import Decoder, StreamDecoder
    from compeg_tpu_torch.profiling import log_stats

    logging.basicConfig(level=logging.INFO)
    frames = frame_source(args)
    if args.scale != 8:
        # Thumbnails frame by frame through the public decode_scaled (K2s),
        # each returned on the host; 1/8 of a 4K frame is already smaller
        # than a terminal.
        dec = Decoder(device=args.device)
        outs = (dec.decode_scaled(data, args.scale) for data in frames)
    else:
        dec = StreamDecoder(device=args.device)
        outs = dec.decode_iter(frames)
    want_rgb = args.preview or args.save_dir or on_frame is not None
    t0 = time.perf_counter()
    n = 0
    last = t0
    if args.preview:
        sys.stdout.write("\x1b[2J")  # clear once; frames overdraw in place
    for out in outs:
        rgb = out
        if args.scale == 8 and want_rgb:
            rgb = dec.to_rgb(out)
        if on_frame is not None:
            on_frame(n, rgb)
        if args.preview:
            sys.stdout.write(render_ansi(rgb, args.preview_width))
            sys.stdout.write("\n")
            sys.stdout.flush()
        if args.save_dir:
            from PIL import Image

            os.makedirs(args.save_dir, exist_ok=True)
            Image.fromarray(rgb).save(
                os.path.join(args.save_dir, f"frame_{n:05d}.png"))
        n += 1
        if n % args.stats_every == 0:
            now = time.perf_counter()
            print(
                f"{n} frames | {args.stats_every / (now - last):.1f} fps "
                f"(avg {n / (now - t0):.1f})"
            )
            last = now
    if args.device == "cuda":
        import torch

        torch.cuda.synchronize()  # the last frames' kernels count too
    dt = time.perf_counter() - t0
    print(f"done: {n} frames in {dt:.2f}s = {n / max(dt, 1e-9):.1f} fps")
    log_stats()
    return n


if __name__ == "__main__":
    main()
