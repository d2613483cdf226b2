"""Restart-segment-parallel Huffman entropy decode (kernel K1) and its plain
PyTorch twin.

Counterpart of :mod:`compeg_tpu.ops.entropy`. The JAX package compiles its
Huffman tables into the Pallas kernel (``EntropyPlan`` is the jit key); here
they travel as device tensors (:class:`EntropyTables`), so one built kernel
serves every stream.

Input rows are the host packer's linear per-segment rows ``[>= nseg, W]``
(``native.pack_rows(tile=None)``): u32 words, MSB-first, held as int32.
Output is raw (still quantized) zigzag coefficients ``[nseg, ri, DUS, 64]``
int32; MCU ``m`` of segment ``s`` is frame MCU ``s * ri + m``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

LUT_BITS = 9  # window bits of the first-level lookup (csrc/entropy.cuh)


def table_layout(lut_bits: int = LUT_BITS) -> dict:
    """Offsets, in 16-bit halves, of one packed table (csrc/entropy.cuh,
    under the same names): the first-level lookup, limits[16], delta[17],
    max_len, num_values and the 256 byte-wide values, padded to 16 bytes."""
    limits = 1 << lut_bits
    delta = limits + 16
    max_len = delta + 17
    values = max_len + 3
    halves = (values + 128 + 7) // 8 * 8
    return {"LUT_BITS": lut_bits, "TAB_LUT": 0, "TAB_LIMITS": limits,
            "TAB_DELTA": delta, "TAB_MAX_LEN": max_len,
            "TAB_NUM_VALUES": max_len + 1, "TAB_VALUES": values,
            "TAB_HALVES": halves, "TAB_WORDS": halves // 2}


def compare_loop(c16, limits, delta, max_len: int, num_values: int):
    """Code length and clipped ordinal of the 16-bit windows ``c16`` by the
    compare loop of the reference kernel (and of :func:`_symbol`):
    ``ln = 1 + #{j in 1..max_len-1 : c16 >= limits[j]}``, ``k = clip((c16 >>
    (16 - ln)) + delta[ln], 0, num_values - 1)``. numpy int64 arrays."""
    c16 = np.asarray(c16, np.int64)
    lim = np.asarray(limits, np.int64)[1:max_len]
    ln = 1 + (c16[:, None] >= lim[None, :]).sum(1)
    k = (c16 >> (16 - ln)) + np.asarray(delta, np.int64)[ln]
    return ln, np.clip(k, 0, num_values - 1)


def lookup_entries(limits, delta, values, max_len: int, num_values: int,
                   lut_bits: int = LUT_BITS) -> np.ndarray:
    """The first-level lookup: for each ``lut_bits``-bit prefix ``p`` the
    entry ``ln << 8 | value`` that every window starting with ``p`` decodes
    to, or 0 where windows with that prefix need the compare loop.

    ``limits[L]`` has zero low ``16 - L`` bits, so the compare at level
    ``L`` is the same for all windows with the prefix while ``L <=
    lut_bits``, and the compare-sum is monotone in the window: when the
    prefix's lowest and highest windows give the same ``ln <= lut_bits``,
    every window between them gives that ``ln`` and the same ordinal."""
    p = np.arange(1 << lut_bits, dtype=np.int64)
    lo = p << (16 - lut_bits)
    ln_lo, k_lo = compare_loop(lo, limits, delta, max_len, num_values)
    ln_hi, _ = compare_loop(lo | ((1 << (16 - lut_bits)) - 1), limits, delta,
                            max_len, num_values)
    exact = (ln_lo == ln_hi) & (ln_lo <= lut_bits)
    entry = ln_lo << 8 | np.asarray(values, np.int64)[k_lo]
    return np.where(exact, entry, 0).astype(np.uint16)


@functools.lru_cache(maxsize=256)
def _pack_table(key: Tuple, lut_bits: int) -> np.ndarray:
    limits, delta, values, max_len, num_values = key
    lay = table_layout(lut_bits)
    h = np.zeros(lay["TAB_HALVES"], np.uint16)
    h[:1 << lut_bits] = lookup_entries(limits, delta, values, max_len,
                                       num_values, lut_bits)
    at = lay["TAB_LIMITS"]
    h[at:at + 16] = np.minimum(np.asarray(limits[:16], np.int64), 0xFFFF)
    at = lay["TAB_DELTA"]
    h[at:at + 17] = np.asarray(delta, np.int64) & 0xFFFF
    h[lay["TAB_MAX_LEN"]] = max_len
    h[lay["TAB_NUM_VALUES"]] = num_values
    at = 2 * lay["TAB_VALUES"]
    h.view(np.uint8)[at:at + 256] = values
    h.flags.writeable = False
    return h


def pack_tables(tables: "EntropyTables", lut_bits: int = LUT_BITS
                ) -> Tuple[Tuple[int, ...], torch.Tensor]:
    """The kernels' form of ``tables``: ``(table_of, packed)``. ``packed``
    is ``[T, TAB_WORDS]`` int32 on the tables' device, one row per distinct
    table in the 16-bit layout of :func:`table_layout` (a component's two
    tables are often another's); ``table_of[2 * c + cls]`` is the row of
    component ``c``'s DC (``cls`` 0) or AC table."""
    arrays = [t.cpu().numpy() for t in (tables.limits, tables.delta,
                                        tables.values, tables.max_len,
                                        tables.num_values)]
    keys, table_of = [], []
    for c in range(arrays[0].shape[0]):
        for cls in (0, 1):
            key = (tuple(arrays[0][c, cls].tolist()),
                   tuple(arrays[1][c, cls].tolist()),
                   tuple(arrays[2][c, cls].tolist()),
                   int(arrays[3][c, cls]), int(arrays[4][c, cls]))
            if key not in keys:
                keys.append(key)
            table_of.append(keys.index(key))
    halves = np.stack([_pack_table(k, lut_bits) for k in keys])
    packed = torch.from_numpy(halves.view(np.int32).copy())
    return tuple(table_of), packed.to(tables.limits.device)


@dataclass
class EntropyTables:
    """Per-component DC and AC Huffman tables as int32 tensors on one
    device; index ``[comp, 0]`` is the DC table, ``[comp, 1]`` the AC one
    (what the plain twin reads).

    ``packed`` and ``table_of`` are the kernels' form (:func:`pack_tables`).
    ``zrl17`` selects the reference's ZRL semantics (advance 17,
    ``Decoder(zrl_compat=True)``), which the JAX package likewise carries in
    its ``EntropyPlan``."""

    limits: torch.Tensor  # [C, 2, 17]
    delta: torch.Tensor  # [C, 2, 17]
    values: torch.Tensor  # [C, 2, 256], zero past num_values
    max_len: torch.Tensor  # [C, 2]
    num_values: torch.Tensor  # [C, 2]
    zrl17: bool = False
    packed: torch.Tensor = field(init=False, repr=False)
    table_of: Tuple[int, ...] = field(init=False)

    def __post_init__(self):
        self.table_of, self.packed = pack_tables(self)

    @property
    def device(self) -> torch.device:
        return self.packed.device


def _tables(rows: Sequence[Sequence[Tuple]], device,
            zrl17: bool) -> EntropyTables:
    """``rows[comp][cls] = (limits, delta, values, max_len, num_values)``."""
    def stack(i):
        return torch.tensor(
            [[list(t[i]) if isinstance(t[i], (tuple, list)) else t[i]
              for t in comp] for comp in rows],
            dtype=torch.int32, device=device,
        )

    return EntropyTables(*(stack(i) for i in range(5)), zrl17=zrl17)


def _padded(values) -> Tuple[int, ...]:
    return tuple(values) + (0,) * (256 - len(values))


def tables_from_image(img, device="cpu", zrl17: bool = False) -> EntropyTables:
    """Tables of an analyzed frame (:class:`compeg_tpu_torch.metadata.ImageData`),
    built from its :class:`~compeg_tpu_torch.huffman.CanonicalTable` objects."""
    rows = []
    for c in range(len(img.components)):
        rows.append([
            (t.limits, t.delta, _padded(t.values), t.max_len, t.num_values)
            for t in (img.dc_table_for_comp(c), img.ac_table_for_comp(c))
        ])
    return _tables(rows, device, zrl17)


def tables_from_plan(plan, device="cpu") -> EntropyTables:
    """Tables of a JAX ``EntropyPlan`` (compeg_tpu.ops.entropy), read by
    attribute so that nothing here imports jax: the constants the Pallas
    kernel was compiled with, for tests that feed both kernels alike."""
    rows = []
    for dc, ac in zip(plan.dc, plan.ac):
        comp = []
        for tc in (dc, ac):
            words = [w & 0xFFFFFFFF for w in tc.value_words]
            values = [(words[k >> 2] >> ((k & 3) * 8)) & 0xFF
                      for k in range(tc.num_values)]
            comp.append((tc.limits, tc.delta, _padded(values), tc.max_len,
                         tc.num_values))
        rows.append(comp)
    return _tables(rows, device, plan.zrl17)


def _check(rows: torch.Tensor, nseg: int, tables: EntropyTables) -> None:
    if rows.dtype != torch.int32 or rows.dim() != 2:
        raise ValueError(f"rows must be [N, W] int32, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if rows.shape[0] < nseg or rows.shape[1] < 1:
        raise ValueError(f"rows {tuple(rows.shape)} hold fewer than {nseg} "
                         "segments of at least one word")
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")
    if tables.device != rows.device:
        raise ValueError(f"tables on {tables.device}, rows on {rows.device}")


def entropy_decode(rows: torch.Tensor, nseg: int, tables: EntropyTables,
                   ri: int, total_mcus: int,
                   du_to_comp: Sequence[int]) -> torch.Tensor:
    """Decode ``nseg`` restart segments to ``[nseg, ri, DUS, 64]`` int32 raw
    zigzag coefficients. CUDA tensors launch kernel K1; CPU tensors take
    :func:`entropy_decode_reference`."""
    _check(rows, nseg, tables)
    if rows.device.type == "cpu":
        return entropy_decode_reference(rows, nseg, tables, ri, total_mcus,
                                        du_to_comp)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    out = torch.empty((nseg, ri, len(du_to_comp), 64), dtype=torch.int32,
                      device=rows.device)
    # K1 reads only the component count from the samplings.
    ncomp = tables.limits.shape[0]
    params = _build.make_params(nseg, rows.shape[1], ri, total_mcus,
                                du_to_comp, samplings=[(1, 1)] * ncomp,
                                zrl17=tables.zrl17, table_of=tables.table_of)
    _build.launch("compeg_entropy_decode", rows, tables.packed, out,
                  params=params)
    _build.LAUNCHES["entropy"] += 1
    return out


# ---------------------------------------------------------------------------
# Plain version: vectorised over segments like the TPU kernel, with gathers
# for the word fetch and the value lookup.
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _peek32(flat: torch.Tensor, width: int, idx: torch.Tensor,
            bitpos: torch.Tensor) -> torch.Tensor:
    """The 32 bits at ``bitpos`` of rows ``idx``, as int64, from the
    flattened ``[rows * width]`` words. A row's stream is its
    words in order with the word index clamped to the row's last word,
    exactly what the kernel's refilled window holds."""
    base = idx * width
    w0 = flat[base + torch.clamp(bitpos >> 5, max=width - 1)]
    w1 = flat[base + torch.clamp((bitpos >> 5) + 1, max=width - 1)]
    o = bitpos & 31
    # w0 < 2**32 and o <= 31, so the shift stays below 2**63.
    return ((w0 << o) & _M32) | (w1 >> (32 - o))


def _symbol(flat, width, idx, bitpos, tab, dc: bool):
    """Decode one symbol of rows ``idx`` at their ``bitpos`` with table
    ``tab`` = (limits, delta, values, max_len, num_values). Returns (value,
    s, magnitude bits, bits used)."""
    limits, delta, values, max_len, nv = tab
    v32 = _peek32(flat, width, idx, bitpos)
    c16 = v32 >> 16
    ln = 1 + (c16[:, None] >= limits[None, 1:max_len]).sum(1)
    k = (c16 >> (16 - ln)) + delta[ln]
    k = torch.clamp(k, 0, nv - 1)
    value = values[k]
    s = torch.clamp(value, max=15) if dc else value & 15
    n = ln + s
    one_s = torch.bitwise_left_shift(torch.ones_like(s), s)
    mag = (v32 >> (32 - n)) & (one_s - 1)
    return value, s, mag, n


def _extend(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """T.81 EXTEND; s == 0 gives 0."""
    one_s = torch.bitwise_left_shift(torch.ones_like(s), s)
    return torch.where(v < (one_s >> 1), v - one_s + 1, v)


def entropy_decode_reference(rows: torch.Tensor, nseg: int,
                             tables: EntropyTables, ri: int, total_mcus: int,
                             du_to_comp: Sequence[int],
                             lanes: Optional[torch.Tensor] = None,
                             seg_ri: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`entropy_decode`, on any device.

    With ``lanes`` (``[nseg, 4]`` int32, :func:`compeg_tpu_torch.ops.lanes.
    lane_index`) the ``nseg`` segments are lanes of ``ri`` MCUs cut from
    restart segments of ``seg_ri`` MCUs, whose rows ``rows`` holds: lane
    ``v`` reads row ``v * ri // seg_ri`` from bit ``lanes[v, 0]`` with the
    DC predictors ``lanes[v, 1:]``, as a LANES launch of the fused kernels
    does."""
    dev = rows.device
    seg = torch.arange(nseg, device=dev)
    if lanes is None:
        row_of, nrows = seg, nseg
    else:
        row_of, nrows = seg * ri // seg_ri, -(-total_mcus // seg_ri)
    _check(rows, nrows, tables)
    dus = len(du_to_comp)
    out = torch.zeros((nseg, ri, dus, 64), dtype=torch.int32, device=dev)
    width = rows.shape[1]
    flat = rows[:nrows].reshape(-1).to(torch.int64) & _M32
    nm = torch.clamp(total_mcus - seg * ri, 0, ri)
    ncomp = tables.limits.shape[0]
    if lanes is None:
        bitpos = torch.zeros(nseg, dtype=torch.int64, device=dev)
        # DC predictors in int32 like the kernels (wrapping on garbage input).
        dp = torch.zeros((ncomp, nseg), dtype=torch.int32, device=dev)
    else:
        bitpos = lanes[:, 0].to(torch.int64)
        dp = lanes[:, 1:1 + ncomp].T.clone(  # updated in place below
            memory_format=torch.contiguous_format)
    tabs = [
        [(tables.limits[c, k].long(), tables.delta[c, k].long(),
          tables.values[c, k].long(), int(tables.max_len[c, k]),
          int(tables.num_values[c, k])) for k in (0, 1)]
        for c in range(ncomp)
    ]
    for m in range(ri):
        act = torch.nonzero(nm > m)[:, 0]
        if act.numel() == 0:
            break
        for d, comp in enumerate(du_to_comp):
            dctab, actab = tabs[comp]
            _, s, mag, n = _symbol(flat, width, row_of[act], bitpos[act],
                                   dctab, dc=True)
            bitpos[act] += n
            dp[comp, act] += _extend(mag, s).to(torch.int32)
            out[act, m, d, 0] = dp[comp, act]
            # AC loop: step every segment whose block is still open.
            idx, pos = act, torch.zeros_like(act)
            while idx.numel():
                value, s, mag, n = _symbol(flat, width, row_of[idx],
                                           bitpos[idx], actab, dc=False)
                bitpos[idx] += n
                rrrr = value >> 4
                newpos = pos + rrrr + 1
                if tables.zrl17:  # a ZRL advances 17 (the reference's)
                    newpos = newpos + ((s == 0) & (rrrr == 15)).long()
                put = (s != 0) & (newpos <= 63)
                out[idx[put], m, d, newpos[put]] = _extend(
                    mag[put], s[put]).to(torch.int32)
                pos = torch.where((s == 0) & (rrrr == 0), 64, newpos)
                keep = pos < 63
                idx, pos = idx[keep], pos[keep]
    return out


def coefficients_natural_order(out: torch.Tensor, total_mcus: int) -> torch.Tensor:
    """``[nseg, ri, DUS, 64]`` -> ``[total_mcus * DUS, 64]`` with MCUs in
    raster order, the layout of ``golden.decode_coefficients``."""
    dus = out.shape[2]
    return out.reshape(-1, 64)[: total_mcus * dus]
