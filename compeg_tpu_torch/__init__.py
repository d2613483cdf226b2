"""compeg_tpu_torch — the PyTorch/CUDA port of compeg_tpu.

The host side (container parsing, Huffman tables, scan preprocessing, the
native C++ packer) is the port's own copy of compeg_tpu's, under the same
module names; the device side is PyTorch with hand-written CUDA kernels for
Hopper (csrc/), built with nvcc at first use. Nothing here imports jax or
anything of compeg_tpu.

Public API (mirroring compeg_tpu's fused decode):

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
    CompegError           — the single error type
    golden                — the CPU reference decoder the kernels are held to
    encoder               — a baseline JPEG encoder for test streams
"""

from . import encoder, golden
from .batch import BatchDecoder, StreamDecoder
from .errors import CompegError
from .metadata import ImageData, analyze
from .pipeline import Decoder, DecodeOp, FrameGeometry, decode_rgb, decode_rgba

__all__ = [
    "CompegError",
    "ImageData",
    "analyze",
    "Decoder",
    "BatchDecoder",
    "StreamDecoder",
    "DecodeOp",
    "FrameGeometry",
    "decode_rgb",
    "decode_rgba",
    "golden",
    "encoder",
]
