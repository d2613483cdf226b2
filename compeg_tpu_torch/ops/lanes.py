"""Lanes inside a restart segment: the lane index L and its plain twin.

The fused kernels decode one restart segment a lane, so a frame with no
restart markers (one segment, as ``cv2.imwrite`` and ``cjpeg`` write by
default) runs on one thread through all its MCUs. Where a segment holds more
than :func:`split_mcus` MCUs, ``pipeline.decode_fused`` cuts it into lanes of
``L`` MCUs (:func:`lane_length`): the lane index (:func:`lane_index`, kernel
L of csrc/decode.cu) finds, on the card and from the segment rows as they
lie, where each lane starts, and the fused kernels' LANES launch decodes the
lanes side by side (``ops/fused``, ``lanes=``). Lane ``v`` of a frame holds
its MCUs ``v * L .. v * L + L - 1``; with restart markers ``L`` divides the
interval, so no lane crosses a segment's end.

The lane table is ``[lanes, 4]`` int32 a frame (``[B, lanes, 4]`` for a
batch): for lane ``v`` the bit of its first MCU in its segment's row and the
DC predictors of components 0, 1, 2 before that MCU (int32, wrapping like
the kernels' on garbage input). It replaces no TPU kernel: the JAX package
decodes one segment a lane.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .entropy import EntropyTables, _check, compare_loop

# csrc/decode.cu's lane index: bits of a subsequence, the rounds of its
# repair (each with a flag in the scratch) and the MCU starts a subsequence
# keeps (its scratch is 2 + STARTS int4)
SUB_BITS = 1024
ROUNDS = 8
STARTS = 4
# A segment of more MCUs than T is cut into lanes, and a lane takes
# LANE_MCUS of them (L): both from the sweeps on the card in PERF.md. T
# follows the launch's frames, (frames, T) from the fewest frames up: the
# segments of a few frames, each on one lane, leave most of the card idle,
# so lanes pay from shorter segments there than in a batch of 16.
SPLIT_MCUS = ((1, 14), (16, 20))
LANE_MCUS = 1


class LaneTable(NamedTuple):
    """A lane table and the lane length it was made for."""

    table: torch.Tensor  # [lanes, 4] or [B, lanes, 4] int32
    mcus: int  # L, MCUs a lane

    def count(self, total_mcus: int) -> int:
        """Lanes a frame of ``total_mcus`` MCUs."""
        return -(-total_mcus // self.mcus)


def split_mcus(frames: int) -> int:
    """T for a launch of ``frames`` frames."""
    return [t for f, t in SPLIT_MCUS if f <= frames][-1]


def lane_length(seg_mcus: int, nseg: int, frames: int) -> Optional[int]:
    """``L`` for a launch of ``frames`` frames whose restart segments hold
    ``seg_mcus`` MCUs (the interval, or the frame's MCUs with no restart
    markers), ``nseg`` of them a frame, or None where a segment is short
    enough for one lane."""
    if seg_mcus <= split_mcus(frames):
        return None
    # L = 1 divides every interval; with restart markers a longer L must
    # divide it, so that no lane crosses a segment's end
    assert LANE_MCUS == 1 or nseg == 1 or seg_mcus % LANE_MCUS == 0
    return LANE_MCUS


def lane_index(rows: torch.Tensor, nseg: int, tables: EntropyTables, geom,
               mcus: int) -> LaneTable:
    """The lane table of the frame (``[R, W]`` rows) or batch (``[B, R,
    W]``) for lanes of ``mcus`` MCUs; ``geom`` is the frame's
    :class:`~compeg_tpu_torch.pipeline.FrameGeometry`. CUDA tensors launch
    kernel L; CPU tensors take :func:`lane_index_reference`."""
    seg_ri = min(geom.ri, geom.total_mcus)
    if nseg != -(-geom.total_mcus // seg_ri) or (
            nseg > 1 and seg_ri % mcus):
        raise ValueError(f"lanes of {mcus} MCUs do not cut {nseg} segments "
                         f"of {geom.ri} MCUs")
    frames = rows.shape[0] if rows.dim() == 3 else None
    _check(rows if frames is None else rows[0], nseg, tables)
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")
    if rows.device.type == "cpu":
        return LaneTable(lane_index_reference(rows, nseg, tables, geom,
                                              mcus), mcus)
    lanes = -(-geom.total_mcus // mcus)
    words = rows.shape[-1]
    subs = -(-words * 32 // SUB_BITS)
    table = torch.empty((*((frames,) if frames else ()), lanes, 4),
                        dtype=torch.int32, device=rows.device)
    segs = (frames or 1) * nseg
    scratch = torch.empty(segs * subs * (2 + STARTS) * 4 + ROUNDS + segs,
                          dtype=torch.int32, device=rows.device)
    params = _build.make_params(
        lanes, words, mcus, geom.total_mcus, geom.du_to_comp,
        samplings=geom.samplings, zrl17=tables.zrl17, frames=frames or 1,
        frame_rows=rows.shape[-2], table_of=tables.table_of, seg_ri=seg_ri)
    _build.launch("compeg_lane_index", rows, tables.packed, scratch, table,
                  params=params)
    _build.LAUNCHES["lanes"] += 1
    return LaneTable(table, mcus)


# ---------------------------------------------------------------------------
# Plain version: the serial decode of each segment, symbol by symbol.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _window_table(limits, delta, values, max_len: int, num_values: int):
    """Code length and value of every 16-bit window under one table, by the
    compare loop of the kernels and the plain twin: two lists of 65,536."""
    ln, k = compare_loop(np.arange(1 << 16), limits, delta, max_len,
                         num_values)
    return ln.tolist(), np.asarray(values, np.int64)[k].tolist()


def _wrap(v: int) -> int:
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def stepper(row: np.ndarray, windows, geom, zrl17: bool):
    """``step(bit, d, pos, dp) -> (bit, d, pos)``: one symbol of a
    segment's row ``row`` (u32 words), as csrc/entropy.cuh ``LaneWalk``
    decodes it from data unit ``d`` of the MCU with ``pos`` -1 before its DC
    symbol, else the zigzag position its block has reached: words clamped
    to the row's last, invalid codes clipped, ``zrl17``. A DC symbol adds
    its difference to ``dp[comp]`` (unwrapped Python ints). ``windows[c]``
    are component ``c``'s DC and AC tables as :func:`_window_table` gives
    them."""
    words = row.tolist()
    last = len(words) - 1
    comps = list(geom.du_to_comp)
    dus = len(comps)

    def step(bit, d, pos, dp):
        i, o = bit >> 5, bit & 31
        v = words[min(i, last)]
        if o:
            v = ((v << o) | (words[min(i + 1, last)] >> (32 - o))) \
                & 0xFFFFFFFF
        comp = comps[d]
        lens, vals = windows[comp][0 if pos < 0 else 1]
        ln, value = lens[v >> 16], vals[v >> 16]
        if pos < 0:
            sz = min(value, 15)
            mag = (v >> (32 - ln - sz)) & ((1 << sz) - 1)
            # T.81 EXTEND; sz == 0 gives 0
            dp[comp] += mag - (1 << sz) + 1 if mag < (1 << sz) >> 1 else mag
            return bit + ln + sz, d, 0
        sz, rrrr = value & 15, value >> 4
        if sz == 0 and rrrr == 0:
            pos = 64
        else:
            pos += rrrr + 1 + (zrl17 and sz == 0 and rrrr == 15)
        if pos >= 63:
            return bit + ln + sz, (d + 1) % dus, -1
        return bit + ln + sz, d, pos

    return step


def table_windows(tables: EntropyTables):
    """Every component's DC and AC table as :func:`_window_table` lists."""
    return [tuple(
        _window_table(tuple(tables.limits[c, k].tolist()),
                      tuple(tables.delta[c, k].tolist()),
                      tuple(tables.values[c, k].tolist()),
                      int(tables.max_len[c, k]),
                      int(tables.num_values[c, k])) for k in (0, 1))
        for c in range(tables.limits.shape[0])]


def _frame_lanes(rows: np.ndarray, nseg: int, windows, geom, zrl17: bool,
                 mcus: int) -> np.ndarray:
    seg_ri = min(geom.ri, geom.total_mcus)
    out = np.zeros((-(-geom.total_mcus // mcus), 4), np.int32)
    for s in range(nseg):
        step = stepper(rows[s], windows, geom, zrl17)
        first = s * seg_ri
        nm = min(seg_ri, geom.total_mcus - first)
        bit, d, pos, dp, m = 0, 0, -1, [0, 0, 0], 0
        while True:
            if d == 0 and pos < 0:  # an MCU starts
                if m == nm:
                    break
                if (first + m) % mcus == 0:
                    out[(first + m) // mcus] = [bit, *map(_wrap, dp)]
                m += 1
            bit, d, pos = step(bit, d, pos, dp)
    return out


def lane_index_reference(rows: torch.Tensor, nseg: int,
                         tables: EntropyTables, geom,
                         mcus: int) -> torch.Tensor:
    """Plain version of :func:`lane_index`: each segment decoded serially,
    symbol by symbol with the kernels' reads (words clamped to the row's
    last, invalid codes clipped, ``zrl17``), noting the bit and the DC
    predictors at every MCU whose index is a multiple of ``mcus``. The
    table tensor only."""
    windows = table_windows(tables)
    frames = rows if rows.dim() == 3 else rows[None]
    words = frames.cpu().numpy().view(np.uint32)
    out = np.stack([_frame_lanes(w, nseg, windows, geom, tables.zrl17, mcus)
                    for w in words])
    table = torch.from_numpy(out if rows.dim() == 3 else out[0])
    return table.to(rows.device)
