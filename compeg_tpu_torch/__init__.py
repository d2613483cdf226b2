"""compeg_tpu_torch — the PyTorch/CUDA port of compeg_tpu.

The host side (container parsing, Huffman tables, scan preprocessing, the
native C++ packer) is the port's own copy of compeg_tpu's, under the same
module names; the device side is PyTorch with hand-written CUDA kernels for
Hopper (csrc/), built with nvcc at first use. Nothing here imports jax or
anything of compeg_tpu.

Public API (mirroring compeg_tpu's):

    ImageData / analyze   — parse + validate a JPEG
    Decoder               — per-stream decode state on one torch device:
                            decode / decode_rgba / start_decode, decode_ycbcr,
                            decode_scaled; knobs exact_idct, zrl_compat,
                            fancy_upsampling, planes_epilogue
    BatchDecoder          — B same-geometry frames in one upload and one launch
    StreamDecoder         — frames in order, host prepare overlapping the
                            upload and the decode of earlier frames
    decode_rgb            — one-shot decode to an [H, W, 3] u8 array
    decode_rgba           — one-shot decode to an [H, W, 4] u8 array
    decode_scaled         — one-shot thumbnail decode at scale_blocks/8
    CompegError           — the single error type
    CanonicalTable / build_table / default_tables
                          — canonical Huffman tables (huffman.py)
    parser, scan          — the container parser and the scan packer
    mjpeg                 — MJPEG byte streams split into frames
    golden                — the CPU reference decoder the kernels are held to
    encoder               — a baseline JPEG encoder for test streams

Not imported here: ``compeg_tpu_torch.v4l2`` (V4L2 webcam capture, Linux
only) and the ``compeg_tpu_torch.parallel`` subpackage (frames and MCU-row
bands over the ranks of a ``torch.distributed`` process group), as in the
JAX package. Front ends live in ``compeg_tpu_torch.tools``: ``viewer``,
``enc`` and ``dryrun_multiproc``.
"""

from . import encoder, golden, mjpeg, parser, scan
from .batch import BatchDecoder, StreamDecoder
from .errors import CompegError
from .huffman import CanonicalTable, build_table, default_tables
from .metadata import ImageData, analyze
from .pipeline import Decoder, DecodeOp, FrameGeometry, decode_rgb, decode_rgba

__all__ = [
    "CompegError",
    "ImageData",
    "analyze",
    "CanonicalTable",
    "build_table",
    "default_tables",
    "Decoder",
    "BatchDecoder",
    "StreamDecoder",
    "DecodeOp",
    "FrameGeometry",
    "decode_rgb",
    "decode_rgba",
    "decode_scaled",
    "golden",
    "encoder",
    "mjpeg",
    "parser",
    "scan",
]


def decode_scaled(data: bytes, scale_blocks: int, **kw):
    """Thumbnail decode at ``scale_blocks/8`` scale (k ∈ {1, 2, 4, 8}) —
    the libjpeg ``scale_denom`` feature as a DCT-domain downsample (kernel
    K2s for k < 8). ``kw`` are :class:`Decoder`'s knobs, ``device``
    included (``"cuda"`` by default)."""
    return Decoder(**kw).decode_scaled(data, scale_blocks)
