"""compeg_tpu_torch — the PyTorch/CUDA port of compeg_tpu.

The host side (container parsing, Huffman tables, scan preprocessing, the
native packer) is compeg_tpu's own, reused unchanged; the device side is
PyTorch with hand-written CUDA kernels for Hopper (csrc/), built with nvcc
at first use. Nothing here imports jax.

Public API (mirroring compeg_tpu's single-frame fused decode):

    ImageData / analyze   — parse + validate a JPEG
    Decoder               — per-stream decode state on one torch device:
                            decode / decode_rgba / start_decode, decode_ycbcr,
                            decode_scaled; knobs exact_idct, zrl_compat,
                            fancy_upsampling, planes_epilogue
    decode_rgb            — one-shot decode to an [H, W, 3] u8 array
    decode_rgba           — one-shot decode to an [H, W, 4] u8 array
    CompegError           — the single error type
"""

from compeg_tpu.errors import CompegError
from compeg_tpu.metadata import ImageData, analyze

from .pipeline import Decoder, DecodeOp, FrameGeometry, decode_rgb, decode_rgba

__all__ = [
    "CompegError",
    "ImageData",
    "analyze",
    "Decoder",
    "DecodeOp",
    "FrameGeometry",
    "decode_rgb",
    "decode_rgba",
]
