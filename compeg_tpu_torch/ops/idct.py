"""Dequantization + 8x8 IDCT: the per-slot operators and the plain version.

Counterpart of :mod:`compeg_tpu.ops.idct`. The operator is the JAX
package's f32 ``Lq`` (``ops/luts.idct_dequant_matrices``, the port's copy):
the zigzag de-ordering, the quantizer and the ``retained_coefficients``
truncation folded into one ``[64, 64]`` matrix per DU slot, so that

    pixels[p] = clamp(trunc(sum_z Lq[slot][p][z] * coeff_raw[z] + 128.5), 0, 255)

The port keeps it transposed, ``lq_t[slot][z][p]``, the layout in which the
fused kernel's warps read one contiguous row of 64 pixels per coefficient.
The scaled decode's k-point operators (``luts.scaled_idct_dequant_matrices``)
take the same form with ``k * k`` pixels per data unit.
"""

from __future__ import annotations

import numpy as np
import torch

from .luts import idct_dequant_matrices, scaled_idct_dequant_matrices

# Zigzag positions the k-point operator can read: the prefix that holds the
# k x k lowest frequencies (every later column is zero; a test checks it).
SCALED_ZLEN = {1: 1, 2: 5, 4: 25}


def qz_by_slot_array(img) -> np.ndarray:
    """Per-DU-slot zigzag quantization rows: ``[DUS, 64]`` int32."""
    return np.stack(
        [np.asarray(img.qtable_for_comp(c)) for c in img.du_to_comp]
    ).astype(np.int32)


def idct_operators(qz_by_slot: np.ndarray, retained: int = 64,
                   device="cpu") -> torch.Tensor:
    """``lq_t [DUS, 64 z, 64 p]`` f32 on ``device``: the transposed
    ``idct_dequant_matrices``."""
    lq = idct_dequant_matrices(qz_by_slot, retained)
    return torch.from_numpy(np.ascontiguousarray(lq.transpose(0, 2, 1))).to(device)


def scaled_operators(qz_by_slot: np.ndarray, k: int, retained: int = 64,
                     device="cpu") -> torch.Tensor:
    """``lq_t [DUS, 64 z, k*k p]`` f32 on ``device``: the transposed
    ``scaled_idct_dequant_matrices`` of the ``k/8`` scaled decode."""
    lq = scaled_idct_dequant_matrices(qz_by_slot, k, retained)
    return torch.from_numpy(np.ascontiguousarray(lq.transpose(0, 2, 1))).to(device)


def idct_pixels(coeffs: torch.Tensor, lq_t: torch.Tensor) -> torch.Tensor:
    """Raw zigzag coefficients ``[..., DUS, 64]`` int32 -> pixels
    ``[..., DUS, P]`` int32 in [0, 255], P the operator's pixel count (64,
    or k*k scaled) in raster order.

    A float32 contraction. On a CUDA device it runs in full f32 only while
    ``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default)."""
    pix = torch.einsum("dzp,...dz->...dp", lq_t, coeffs.to(torch.float32))
    return torch.clamp(pix + 128.5, 0.0, 255.0).to(torch.int32)
