"""Golden CPU decoder (the port's copy of compeg_tpu/golden.py): the
bit-exactness oracle for the CUDA kernels.

Plays the role the reference's ``src/bits.rs`` prototype plays (the CPU model
of the device kernels, src/bits.rs:1-6), extended to the full pipeline:
entropy decode -> dequant -> float32 matrix IDCT -> +128.5/clamp/truncate ->
nearest-neighbor chroma upsampling -> integer BT.601 color conversion with
the reference's exact fixed-point constants (src/dct.wgsl:323-334).

Every device stage is required to match this module: exactly for the integer
stages (coefficients, upsample, color, the integer IDCT), and to within +-1
gray level for the float pixel output (the device IDCT sums in another order
than numpy, which moves f32 results by ulps). Pure numpy and Python, like
the original; the functions and their behaviour are the same
(tests/test_torch_host.py holds the two to equal arrays).

Known conscious divergence from the reference: the reference's ZRL handling
advances the coefficient position by 17 (``pos += 16`` plus the loop's
``pos++``, src/huffman.wgsl:182-185), which drops one position per ZRL
relative to ITU T.81 / libjpeg semantics (+16). This engine implements the
spec-correct +16 by default; pass ``zrl17=True`` (Decoder ``zrl_compat``)
for the reference's semantics, bit-checkable against this oracle.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .errors import bail
from .metadata import ImageData
from .ops.luts import idct_matrix_zigzag
from .scan import split_intervals


class BitReader:
    """MSB-first bit reader over destuffed segment bytes, mirroring the
    device kernel's (hi, lo, nbits) 64-bit window semantics."""

    __slots__ = ("data", "bitpos")

    def __init__(self, data: bytes):
        self.data = data
        self.bitpos = 0

    def peek16(self) -> int:
        v = 0
        byte = self.bitpos >> 3
        sh = self.bitpos & 7
        for i in range(3):
            b = self.data[byte + i] if byte + i < len(self.data) else 0
            v = (v << 8) | b
        return (v >> (8 - sh)) & 0xFFFF

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        v = self.peek16() >> (16 - n)
        self.bitpos += n
        return v

    def skip(self, n: int) -> None:
        self.bitpos += n


def huff_extend(v: int, t: int) -> int:
    """T.81 EXTEND: map a t-bit magnitude to its signed value."""
    if t == 0:
        return 0
    if v < (1 << (t - 1)):
        return v - (1 << t) + 1
    return v


def decode_segment_coefficients(
    seg: bytes,
    img: ImageData,
    mcus_in_segment: int,
    dequant: bool = True,
    zrl17: bool = False,
) -> np.ndarray:
    """Entropy-decode one restart segment into coefficients.

    Returns ``[mcus_in_segment * dus_per_mcu, 64]`` int32 in zigzag order.
    With ``dequant=True`` the quantizer multiply is fused like the
    reference's entropy kernel (src/huffman.wgsl:171,195); ``dequant=False``
    yields raw quantized values — the entropy kernel's output (it defers
    dequantization to the IDCT stage).
    """
    r = BitReader(seg)
    ncomp = len(img.components)
    dcpred = [0] * ncomp
    out = np.zeros((mcus_in_segment * img.dus_per_mcu, 64), dtype=np.int64)
    du = 0
    for _ in range(mcus_in_segment):
        for comp in img.du_to_comp:
            q = img.qtable_for_comp(comp)
            dct = img.dc_table_for_comp(comp)
            act = img.ac_table_for_comp(comp)
            # DC
            ssss, ln = dct.decode(r.peek16())
            r.skip(ln)
            diff = huff_extend(r.get(ssss), ssss)
            dcpred[comp] += diff
            out[du, 0] = dcpred[comp] * int(q[0]) if dequant else dcpred[comp]
            # AC
            pos = 1
            while pos < 64:
                rs, ln = act.decode(r.peek16())
                r.skip(ln)
                if rs == 0x00:  # EOB
                    break
                if rs == 0xF0:  # ZRL: 16 zeros (spec; +17 in compat mode)
                    pos += 17 if zrl17 else 16
                    continue
                rrrr, s = rs >> 4, rs & 0xF
                pos += rrrr
                if pos > 63:
                    if not zrl17:
                        bail("AC run past end of block")
                    # Reference semantics: the value bits are consumed but
                    # the out-of-range write is silently dropped and the
                    # loop exits (src/huffman.wgsl:188-196).
                    r.get(s)
                    pos += 1
                    continue
                coeff = huff_extend(r.get(s), s)
                out[du, pos] = coeff * int(q[pos]) if dequant else coeff
                pos += 1
            du += 1
    return out.astype(np.int32)


def decode_coefficients(
    img: ImageData, dequant: bool = True, zrl17: bool = False
) -> np.ndarray:
    """Entropy-decode the whole image: ``[total_mcus * dus_per_mcu, 64]``
    int32, zigzag order, MCUs in raster order."""
    segs = split_intervals(img.scan_data, img.total_restart_intervals)
    ri = img.restart_interval
    total = img.total_mcus
    parts: List[np.ndarray] = []
    for i, seg in enumerate(segs):
        m = min(ri, total - i * ri)
        parts.append(decode_segment_coefficients(seg, img, m, dequant, zrl17))
    return np.concatenate(parts, axis=0)


def idct_pixels(coeffs: np.ndarray, retained_coefficients: int = 64) -> np.ndarray:
    """``[N, 64]`` *dequantized* zigzag coefficients -> u8 raster pixels.

    float32 matrix IDCT, +128.5 shift, clamp to [0, 255], truncate — the
    semantics of the reference's AAN chain (src/dct.wgsl:144,174-181) in
    matrix form. (:func:`decode_rgb` uses :func:`idct_pixels_raw`.)
    """
    L = idct_matrix_zigzag(retained_coefficients)  # [64p, 64z] f32
    pix = coeffs.astype(np.float32) @ L.T + np.float32(128.5)
    return np.clip(pix, 0.0, 255.0).astype(np.uint8)


def idct_pixels_raw(
    coeffs_raw: np.ndarray, img: ImageData, retained_coefficients: int = 64
) -> np.ndarray:
    """``[N, 64]`` raw (quantized) coefficients -> u8 pixels via the fused
    per-slot dequant+IDCT operators (the f32 Lq constants of
    ops/luts.idct_dequant_matrices, which the device kernels' operators are
    built from)."""
    from .ops.idct import qz_by_slot_array
    from .ops.luts import idct_dequant_matrices

    Lq = idct_dequant_matrices(qz_by_slot_array(img), retained_coefficients)
    dus = img.dus_per_mcu
    n = coeffs_raw.shape[0]
    x = coeffs_raw.reshape(n // dus, dus, 64).astype(np.float32)
    # pixels[m, d, p] = Lq[d] @ x[m, d]
    pix = np.einsum("dpz,mdz->mdp", Lq, x) + np.float32(128.5)
    return np.clip(pix, 0.0, 255.0).astype(np.uint8).reshape(n, 64)


_AAN_SCALE = np.array(
    [1.0, 1.387039845, 1.306562965, 1.175875602,
     1.0, 0.785694958, 0.541196100, 0.275899379],
    dtype=np.float32,
)


def _aan_butterfly(i, first_stage):
    """One 8-point AAN IDCT pass in element-by-element float32 (the exact
    operation order of the reference's jidctflt port,
    src/dct.wgsl:87-135 column pass / :143-172 row pass).

    ``i`` is a list of 8 f32 arrays. ``first_stage=True`` applies the
    column pass's ``* 0.125`` input scaling; ``False`` applies the row
    pass's ``+ 128.5`` level shift on the DC term. Returns 8 outputs in
    natural order (no clamp — the caller clamps for the row pass)."""
    F = np.float32
    if first_stage:
        i = [v * F(0.125) for v in i]
        t0 = i[0]
    else:
        t0 = i[0] + F(128.5)
    # even part
    tmp10 = t0 + i[4]
    tmp11 = t0 - i[4]
    tmp13 = i[2] + i[6]
    tmp12 = (i[2] - i[6]) * F(1.414213562) - tmp13
    e0 = tmp10 + tmp13
    e3 = tmp10 - tmp13
    e1 = tmp11 + tmp12
    e2 = tmp11 - tmp12
    # odd part
    z13 = i[5] + i[3]
    z10 = i[5] - i[3]
    z11 = i[1] + i[7]
    z12 = i[1] - i[7]
    o7 = z11 + z13
    t11 = (z11 - z13) * F(1.414213562)
    z5 = (z10 + z12) * F(1.847759065)
    t10 = z5 - z12 * F(1.082392200)
    t12 = z5 - z10 * F(2.613125930)
    o6 = t12 - o7
    o5 = t11 - o6
    o4 = t10 - o5
    return [e0 + o7, e1 + o6, e2 + o5, e3 + o4,
            e3 - o4, e2 - o5, e1 - o6, e0 - o7]


def idct_pixels_aan(
    coeffs_raw: np.ndarray, img: ImageData, retained_coefficients: int = 64
) -> np.ndarray:
    """``[N, 64]`` raw zigzag coefficients -> u8 pixels via the reference's
    float AAN IDCT chain, emulated operation-for-operation in float32: the
    jidctflt column/row butterflies with the reference's literal constants
    and AAN scale premultiply (src/dct.wgsl:68-182), f32 rounding at every
    step, +128.5 shift, clamp to [0, 255], and the WGSL ``u32()``
    truncation of the pixel pack (src/dct.wgsl:189-197).

    This is the executable model of the reference's *own* arithmetic —
    what "bit-exact vs Compeg" means for the float pipeline — and turns
    the engine's "within +-1 of the matrix-IDCT golden" claim into a
    measured distribution against Compeg's butterflies (PARITY.md)."""
    dus = img.dus_per_mcu
    n = coeffs_raw.shape[0]
    # Dequantize into the i32 coefficients-buffer values the reference's
    # entropy kernel stores (coeff * qtable, zigzag position, truncated).
    q = np.stack([np.asarray(img.qtable_for_comp(c)) for c in img.du_to_comp])
    if retained_coefficients < 64:
        q = q.copy()
        q[:, retained_coefficients:] = 0
    deq = (
        coeffs_raw.reshape(n // dus, dus, 64).astype(np.int64) * q[None]
    ).reshape(n, 64)
    from .tables import ZIGZAG

    zz = np.asarray(ZIGZAG)  # natural position -> zigzag index
    nat = deq[:, zz].reshape(n, 8, 8)  # [N, row, col] natural order
    # f32(coefficient) * (SCALE[row] * SCALE[col]), products taken in f32
    # like the kernel computes them (src/dct.wgsl:78-82).
    mul = _AAN_SCALE[:, None] * _AAN_SCALE[None, :]
    x = nat.astype(np.float32) * mul[None]
    # Column pass: 8 inputs along the row axis for every column.
    cols_out = _aan_butterfly([x[:, k, :] for k in range(8)], first_stage=True)
    ws = np.stack(cols_out, axis=1)  # [N, row, col]
    # Row pass: 8 inputs along the column axis for every row, then clamp.
    rows_out = _aan_butterfly(
        [ws[:, :, k] for k in range(8)], first_stage=False
    )
    pix = np.stack(rows_out, axis=2)  # [N, row, col]
    pix = np.clip(pix, np.float32(0.0), np.float32(255.0))
    # WGSL u32(f32) truncates toward zero.
    return pix.astype(np.uint8).reshape(n, 64)


def idct_pixels_int(
    coeffs_raw: np.ndarray, img: ImageData, retained_coefficients: int = 64
) -> np.ndarray:
    """``[N, 64]`` raw coefficients -> u8 pixels via the exact integer IDCT
    (ops/int_idct.py; its butterfly evaluated on numpy int32). Bit-identical
    to the device kernels' exact mode."""
    from .ops.int_idct import idct_2d_rows
    from .tables import ZIGZAG

    dus = img.dus_per_mcu
    n = coeffs_raw.shape[0]
    # Dequantize (zeroing truncated coefficients), clamp to int16 range.
    q = np.stack([np.asarray(img.qtable_for_comp(c)) for c in img.du_to_comp])
    if retained_coefficients < 64:
        q = q.copy()
        q[:, retained_coefficients:] = 0
    deq = coeffs_raw.reshape(n // dus, dus, 64).astype(np.int64) * q[None]
    deq = np.clip(deq, -32768, 32767).astype(np.int32).reshape(n, 64)
    zz = np.asarray(ZIGZAG).reshape(8, 8)
    cols = [[deq[:, zz[r, c]] for c in range(8)] for r in range(8)]
    out = idct_2d_rows(cols)
    pix = np.empty((n, 64), dtype=np.int32)
    for r in range(8):
        for c in range(8):
            pix[:, r * 8 + c] = out[r][c]
    return np.clip(pix, 0, 255).astype(np.uint8)


def assemble_planes(
    img: ImageData, pixels: np.ndarray, blk: int = 8
) -> List[np.ndarray]:
    """Scatter per-DU pixel blocks into per-component planes at component
    resolution (before upsampling). ``pixels`` is ``[N_du, blk*blk]`` u8
    (``blk`` < 8 for the scaled thumbnail decode)."""
    planes = []
    for ci, c in enumerate(img.components):
        pw = img.width_mcus * c.h_sample * blk
        ph = img.height_mcus * c.v_sample * blk
        planes.append(np.zeros((ph, pw), dtype=np.uint8))
    dus_per_mcu = img.dus_per_mcu
    for m in range(img.total_mcus):
        mx, my = m % img.width_mcus, m // img.width_mcus
        slot = 0
        for ci, c in enumerate(img.components):
            for v in range(c.v_sample):
                for h in range(c.h_sample):
                    b = pixels[m * dus_per_mcu + slot].reshape(blk, blk)
                    y0 = (my * c.v_sample + v) * blk
                    x0 = (mx * c.h_sample + h) * blk
                    planes[ci][y0 : y0 + blk, x0 : x0 + blk] = b
                    slot += 1
    return planes


def ycbcr_to_rgb_reference(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Integer BT.601 with the reference's exact fixed-point constants and
    arithmetic shifts (src/dct.wgsl:323-334)."""
    y = y.astype(np.int32)
    cb = cb.astype(np.int32) - 128
    cr = cr.astype(np.int32) - 128
    r = y + ((45 * cr) >> 5)
    g = y - ((11 * cb + 23 * cr) >> 5)
    b = y + ((113 * cb) >> 6)
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def idct_pixels_scaled(
    coeffs_raw: np.ndarray,
    img: ImageData,
    scale_blocks: int,
    retained_coefficients: int = 64,
) -> np.ndarray:
    """``[N, 64]`` raw coefficients -> ``[N, k*k]`` u8 pixels via the
    k-point scaled IDCT (DCT-domain downsample; luts.scaled_idct_matrix_zigzag)."""
    from .ops.luts import scaled_idct_matrix_zigzag

    Lk = scaled_idct_matrix_zigzag(scale_blocks, retained_coefficients)
    dus = img.dus_per_mcu
    n = coeffs_raw.shape[0]
    q = np.stack([np.asarray(img.qtable_for_comp(c)) for c in img.du_to_comp])
    x = coeffs_raw.reshape(n // dus, dus, 64).astype(np.float32)
    x = x * q[None].astype(np.float32)
    pix = np.einsum("pz,mdz->mdp", Lk, x) + np.float32(128.5)
    k2 = scale_blocks * scale_blocks
    return np.clip(pix, 0.0, 255.0).astype(np.uint8).reshape(n, k2)


def scaled_size(img: ImageData, scale_blocks: int) -> tuple:
    """(height, width) of the ``scale_blocks/8`` scaled decode (libjpeg
    rounding: ceil(dim * k / 8))."""
    k = scale_blocks
    return (-(-img.height * k // 8), -(-img.width * k // 8))


def decode_rgb(
    data_or_img,
    retained_coefficients: int = 64,
    idct: str = "float",
    zrl17: bool = False,
    scale_blocks: int = 8,
) -> np.ndarray:
    """Full golden decode: JPEG bytes (or ImageData) -> ``[H, W, 3]`` u8.

    Chroma upsampling is nearest-neighbor sample replication, like the
    reference (src/dct.wgsl:302-313). ``zrl17`` selects the reference's
    ZRL-advance-17 compat semantics (see decode_segment_coefficients).
    ``scale_blocks=k`` (1/2/4/8) decodes at k/8 scale via the k-point
    scaled IDCT — the libjpeg ``scale_denom`` thumbnail path; output is
    ``ceil(H*k/8) x ceil(W*k/8)``. Only ``idct="float"`` supports k<8.
    """
    from .metadata import analyze

    img = data_or_img if isinstance(data_or_img, ImageData) else analyze(data_or_img)
    k = scale_blocks
    if k != 8 and idct != "float":
        bail("scaled decode supports idct='float' only")
    coeffs = decode_coefficients(img, dequant=False, zrl17=zrl17)
    if idct == "int":
        pixels = idct_pixels_int(coeffs, img, retained_coefficients)
    elif idct == "aan":
        # The reference's own float AAN butterflies (jidctflt port).
        pixels = idct_pixels_aan(coeffs, img, retained_coefficients)
    elif k != 8:
        pixels = idct_pixels_scaled(coeffs, img, k, retained_coefficients)
    else:
        pixels = idct_pixels_raw(coeffs, img, retained_coefficients)
    planes = assemble_planes(img, pixels, blk=k)
    hs, ws = scaled_size(img, k)
    if len(planes) == 1:
        yp = planes[0][:hs, :ws]
        return np.stack([yp, yp, yp], axis=-1)
    up = []
    for ci, c in enumerate(img.components):
        p = planes[ci]
        fx = img.max_h // c.h_sample
        fy = img.max_v // c.v_sample
        if fx > 1:
            p = np.repeat(p, fx, axis=1)
        if fy > 1:
            p = np.repeat(p, fy, axis=0)
        up.append(p[:hs, :ws])
    if img.color_space == "rgb":
        # Component IDs R,G,B: samples are already RGB (libjpeg semantics).
        return np.stack(up, axis=-1)
    return ycbcr_to_rgb_reference(up[0], up[1], up[2])
