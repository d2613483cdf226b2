"""The exact integer IDCT: the stream constants of the integer mode (K2x, and
K3 with ``exact_idct``) and its plain PyTorch version.

Counterpart of the ``exact_idct`` branch of the JAX package (the quantizers
of ``compeg_tpu.pipeline.Decoder._stream_consts`` and the butterfly of
:mod:`compeg_tpu.ops.int_idct`). The arithmetic is the JAX package's own
jax-free specification, ``compeg_tpu.ops.int_idct.idct_2d_rows``, evaluated
here on int32 tensors, which wrap in two's complement like numpy's int32:
the golden decoder's arithmetic, bit for bit. The kernel's version is
``csrc/int_idct.cuh``.

Dequantization follows golden (golden.py:286-287): coefficient x quantizer
in int64, then a saturating clamp to the int16 range. (The Pallas kernel
multiplies in int32 first; the two differ only when |coefficient x
quantizer| >= 2**31, which garbage bits can reach through the DC
predictor.)
"""

from __future__ import annotations

import numpy as np
import torch

from compeg_tpu.ops.int_idct import idct_2d_rows
from compeg_tpu.tables import ZIGZAG


def int_quantizers(qz_by_slot: np.ndarray, retained: int = 64,
                   device="cpu") -> torch.Tensor:
    """Per-DU-slot zigzag quantizers ``[DUS, 64]`` int32 on ``device``,
    zeroed from zigzag position ``retained`` on."""
    q = np.array(qz_by_slot, dtype=np.int32)
    q[:, retained:] = 0
    return torch.from_numpy(q).to(device)


def dequantize(coeffs: torch.Tensor, qz: torch.Tensor) -> torch.Tensor:
    """Raw coefficients ``[..., DUS, 64]`` times the quantizers ``[DUS, 64]``
    in int64, clamped to [-32768, 32767], as int32."""
    deq = coeffs.to(torch.int64) * qz.to(torch.int64)
    return torch.clamp(deq, -32768, 32767).to(torch.int32)


def idct_pixels_int(coeffs: torch.Tensor, qz: torch.Tensor) -> torch.Tensor:
    """Raw zigzag coefficients ``[..., DUS, 64]`` int32 -> pixels of the same
    shape, int32 in [0, 255] in raster order (``golden.idct_pixels_int``)."""
    deq = dequantize(coeffs, qz)
    zz = ZIGZAG.reshape(8, 8)
    out = idct_2d_rows([[deq[..., int(zz[r, c])] for c in range(8)]
                        for r in range(8)])
    pix = torch.stack([out[r][c] for r in range(8) for c in range(8)], dim=-1)
    return torch.clamp(pix, 0, 255)
