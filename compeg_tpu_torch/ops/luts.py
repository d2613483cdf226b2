"""Constant operators for the device pipeline (the port's copy of
compeg_tpu/ops/luts.py, without the TPU's ``[128, 128]`` slot pairing).

The reference runs an 8-thread AAN butterfly IDCT per DU
(src/dct.wgsl:46-201, a port of libjpeg-turbo's jidctflt). The float
mode keeps the JAX package's form, one dense ``[64, 64]`` matrix per DU slot:
the 2D IDCT is linear, and both the zigzag de-ordering and the
``retained_coefficients`` truncation (reference: src/metadata.rs:43,
src/dct.wgsl:80-82) fold into the matrix columns, so the entropy kernel's
zigzag-ordered output multiplies straight into pixels with zero data
reshuffling.
"""

from __future__ import annotations

import numpy as np

from ..tables import UNZIGZAG


def dct_basis() -> np.ndarray:
    """Forward DCT basis C: C[k, n] = c(k)/2 cos((2n+1) k pi/16), f64."""
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    c = np.where(k == 0, 1.0 / np.sqrt(2.0), 1.0)
    return 0.5 * c * np.cos((2 * n + 1) * k * np.pi / 16.0)


def idct_dequant_matrices(
    qz_by_slot: np.ndarray, retained_coefficients: int = 64
) -> np.ndarray:
    """Per-DU-slot fused dequant+IDCT operators: ``[DUS, 64, 64]`` f32 with
    ``pixels = Lq[slot] @ coeff_raw_zigzag``. Folding the quantizer into the
    matrix (libjpeg does the same with its multiplier tables) removes the
    dequant multiply and its table from the kernel."""
    L = idct_matrix_zigzag(retained_coefficients).astype(np.float64)
    q = np.asarray(qz_by_slot, dtype=np.float64)  # [DUS, 64]
    return (L[None, :, :] * q[:, None, :]).astype(np.float32)


def scaled_idct_matrix_zigzag(
    k: int, retained_coefficients: int = 64
) -> np.ndarray:
    """``Lk`` with ``pixels_kxk_flat = Lk @ coeff_zigzag``: [k*k, 64 zigzag].

    The k-point scaled IDCT (libjpeg ``scale_num/scale_denom = k/8``):
    reconstructs a k×k pixel block from the 8×8 block's low k×k
    frequencies — the DCT-domain downsample used for thumbnail decode.

    Derivation (same ``c(u)/2`` basis convention as :func:`dct_basis`): the
    8-point coefficients of a signal relate to the k-point coefficients of
    its (8/k):1 downsample by ``C_k ≈ (k/8)·C_8[:k]``, and the k-point
    basis satisfies ``C_k·C_kᵀ = (k/8)·I``, so its inverse is
    ``(8/k)·C_kᵀ`` and the scale factors cancel exactly:
    ``pixels_k = C_kᵀ · C_8[:k]`` — i.e. the operator is simply the
    truncated-frequency k-point cosine basis with NO extra scaling. k=8
    reduces to :func:`idct_matrix_zigzag`; k=1 gives the DC/8 thumbnail
    pixel (libjpeg jidctred's 1×1 convention).
    """
    if k not in (1, 2, 4, 8):
        raise ValueError(f"scale_blocks must be 1, 2, 4, or 8 (got {k})")
    u = np.arange(8)[None, :]
    n = np.arange(k)[:, None]
    c = np.where(u == 0, 1.0 / np.sqrt(2.0), 1.0)
    Ak8 = np.where(
        u < k, 0.5 * c * np.cos((2 * n + 1) * u * np.pi / (2.0 * k)), 0.0
    )  # [k pixels, 8 freqs]; frequencies >= k discarded
    L = np.kron(Ak8, Ak8)  # pixels[y*k+x] = sum L[(y,x),(u,v)] F[u,v]
    Lz = L[:, UNZIGZAG]
    if retained_coefficients < 64:
        Lz = Lz.copy()
        Lz[:, retained_coefficients:] = 0.0
    return Lz.astype(np.float32)


def scaled_idct_dequant_matrices(
    qz_by_slot: np.ndarray, k: int, retained_coefficients: int = 64
) -> np.ndarray:
    """Per-DU-slot fused dequant + k-point scaled IDCT operators:
    ``[DUS, k*k, 64]`` f32 with ``pixels = Lq[d] @ coeff_zigzag`` (the
    scaled analogue of :func:`idct_dequant_matrices`)."""
    Lk = scaled_idct_matrix_zigzag(k, retained_coefficients)  # [k2, 64]
    q = qz_by_slot.astype(np.float32)  # [DUS, 64] zigzag quantizers
    return (Lk[None, :, :] * q[:, None, :]).astype(np.float32)


def idct_matrix_zigzag(retained_coefficients: int = 64) -> np.ndarray:
    """``L`` with ``pixels_flat = L @ coeff_zigzag``: [64 raster, 64 zigzag].

    Columns for zigzag positions >= ``retained_coefficients`` are zeroed,
    reproducing the reference's truncation knob when set to 32.
    Returned in float32 — the precision the device pipeline computes in.
    """
    C = dct_basis()
    A = C.T  # inverse transform: B = A @ F @ A.T
    L = np.kron(A, A)  # pixels[r*8+c] = sum L[(r,c),(u,v)] F[u,v]
    Lz = L[:, UNZIGZAG]  # column z corresponds to zigzag stream position z
    if retained_coefficients < 64:
        Lz = Lz.copy()
        Lz[:, retained_coefficients:] = 0.0
    return Lz.astype(np.float32)
