"""The exact integer IDCT: the stream constants of the integer mode (K2x, and
K3 with ``exact_idct``) and its plain PyTorch version.

Counterpart of the ``exact_idct`` branch of the JAX package (the quantizers
of ``compeg_tpu.pipeline.Decoder._stream_consts`` and the butterfly of
``compeg_tpu/ops/int_idct.py``). The specification (:func:`descale`,
:func:`idct_1d`, :func:`idct_2d_rows`: 13-bit fixed-point constants, two
scaled 1D passes after Loeffler et al., libjpeg-islow style) is the port's
own copy of compeg_tpu/ops/int_idct.py:46-137, written against operator
overloading and evaluated here on int32 tensors, which wrap in two's
complement like numpy's int32: the golden decoder's arithmetic, bit for
bit. The kernel's version is ``csrc/int_idct.cuh``. The JAX package's
matrix-unit formulation (``pass_operators``, ``mxu_operators``) is the
TPU's and is not carried over.

Dequantization follows golden (golden.py:286-287): coefficient x quantizer
in int64, then a saturating clamp to the int16 range. (The Pallas kernel
multiplies in int32 first; the two differ only when |coefficient x
quantizer| >= 2**31, which garbage bits can reach through the DC
predictor.)
"""

from __future__ import annotations

import numpy as np
import torch

from ..tables import ZIGZAG

CONST_BITS = 13
PASS1_BITS = 2

FIX_0_298631336 = 2446
FIX_0_390180644 = 3196
FIX_0_541196100 = 4433
FIX_0_765366865 = 6270
FIX_0_899976223 = 7373
FIX_1_175875602 = 9633
FIX_1_501321110 = 12299
FIX_1_847759065 = 15137
FIX_1_961570560 = 16069
FIX_2_053119869 = 16819
FIX_2_562915447 = 20995
FIX_3_072711026 = 25172


def descale(x, n: int):
    """Round-half-up arithmetic right shift (two's complement)."""
    return (x + (1 << (n - 1))) >> n


def idct_1d(s, shift_out):
    """One scaled 8-point integer IDCT: ``s`` is a list of 8 int32 arrays
    (numpy or torch — any type with +,-,*,<<,>> semantics), returns 8 arrays
    descaled by ``shift_out``. ``shift_out=None`` returns the raw pre-descale
    sums (used to extract the pass as an integer matrix)."""
    # Even part.
    z2, z3 = s[2], s[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 - z3 * FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (s[0] + s[4]) << CONST_BITS
    tmp1 = (s[0] - s[4]) << CONST_BITS
    t10 = tmp0 + tmp3
    t13 = tmp0 - tmp3
    t11 = tmp1 + tmp2
    t12 = tmp1 - tmp2
    # Odd part.
    t0, t1, t2, t3 = s[7], s[5], s[3], s[1]
    z1 = t0 + t3
    z2 = t1 + t2
    z3 = t0 + t2
    z4 = t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * (-FIX_0_899976223)
    z2 = z2 * (-FIX_2_562915447)
    z3 = z3 * (-FIX_1_961570560) + z5
    z4 = z4 * (-FIX_0_390180644) + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    if shift_out is None:
        return [
            t10 + t3, t11 + t2, t12 + t1, t13 + t0,
            t13 - t0, t12 - t1, t11 - t2, t10 - t3,
        ]
    return [
        descale(t10 + t3, shift_out),
        descale(t11 + t2, shift_out),
        descale(t12 + t1, shift_out),
        descale(t13 + t0, shift_out),
        descale(t13 - t0, shift_out),
        descale(t12 - t1, shift_out),
        descale(t11 - t2, shift_out),
        descale(t10 - t3, shift_out),
    ]


def idct_2d_rows(cols):
    """Full 2D transform from a natural-order 8x8 of arrays.

    ``cols[r][c]`` are int32 arrays (dequantized, clamped). Returns the 8x8
    of pixel arrays (still unclamped ints, level-shifted by +128).
    """
    # Pass 1: transform each column (vary r), scale up by PASS1_BITS.
    p1 = [[None] * 8 for _ in range(8)]
    for c in range(8):
        col = [cols[r][c] for r in range(8)]
        out = idct_1d(col, CONST_BITS - PASS1_BITS)
        for r in range(8):
            p1[r][c] = out[r]
    # Pass 2: transform each row (vary c), final descale + level shift.
    final_shift = CONST_BITS + PASS1_BITS + 3
    out = [[None] * 8 for _ in range(8)]
    for r in range(8):
        o = idct_1d(p1[r], final_shift)
        for c in range(8):
            out[r][c] = o[c] + 128
    return out


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
