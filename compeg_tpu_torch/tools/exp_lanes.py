"""The lane index L and the LANES launch on 1080p 4:2:0 q95 frames: check,
sweep and time.

    python -m compeg_tpu_torch.tools.exp_lanes [--batch 16] [--reps 10]
        [--out FILE] [name=dir ...]

The frames are what ``cv2.imwrite`` writes at its defaults: 1920 x 1080,
4:2:0, quality 95, the standard tables, no restart markers (smooth fields
plus noise, made from a seed and encoded by the port's encoder, about 790 KB
each), and the same picture with a restart every 8, 10, 12, 14, 16, 18, 20,
24, 28, 32, 40, 64 and 120 MCUs.
A pool of 64 frames (the two restart-less pictures in turn, 50 MB, more than
the L2) gives every timed batch its own rows.

1. Lanes of L = 1, 2, 4, 8 and 16 MCUs (``ops/lanes.LANE_MCUS`` set for
   the run) on batches of ``--batch`` restart-less frames: the card's time
   a frame of L, of K3 (integer IDCT) on its lanes, of E (4:2:0 fancy), and
   of ``Decoder.decode_rows`` whole (exact, fancy: the
   ``cv1080_420_q95_nodri`` decode; ``decode_rows_1``: one frame a call,
   as the one-shot decode launches), beside the one-lane K3 and
   ``decode_rows`` on one lane a segment; the pixels of every L must equal
   the one-lane decode's.
2. The crossing T: for each restart interval, ``decode_rows`` a frame of a
   batch of ``--batch`` and of one frame a call, with one lane a segment
   and with lanes of ``lane_length``'s L (``ops/lanes.LANE_MCUS``).
3. Each ``name=dir``, a ``csrc`` tree with other constants of kernel L
   (``SUB_BITS``, ``LEAD_SUBS``, ``ROUNDS``): its lane table must equal the
   package's; its L a frame, and the rounds that changed an entry.
4. ``--profile``: a ``torch.profiler`` trace of three ``decode_rows`` calls
   on the restart-less batch and on each interval's, the card's time a frame
   of each kernel by name.

``--sections`` takes some of 1, 2, 3 (all by default).

Times are ``profiling.burst_ms``: CUDA events around bursts enqueued behind
a spinning kernel, the median of ``--reps``. One JSON object at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from .. import encoder
from ..ops import _build
from ..ops import color as C
from ..ops import fused as F
from ..ops import lanes as LN
from ..pipeline import Decoder
from ..profiling import burst_ms

HEIGHT, WIDTH = 1080, 1920
POOL = 64
INTERVALS = (8, 10, 12, 14, 16, 18, 20, 24, 28, 32, 40, 64, 120)
KNOBS = dict(exact_idct=True, fancy_upsampling=True, pack_threads=1)
# ops/lanes.SPLIT_MCUS that cut every segment, or none, at any frame count
EVERY_SEGMENT, NO_SEGMENT = ((1, 0),), ((1, 10**9),)


def picture(seed: int) -> np.ndarray:
    """Smooth fields plus Gaussian noise (sigma 6), ``[H, W, 3]`` u8."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH].astype(np.float64)
    p = r.uniform(0.7, 1.4, 6)
    f = np.stack([
        128 + 90 * np.sin(xx / (97.0 * p[0])) + 30 * np.cos(yy / (53.0 * p[1])),
        128 + 80 * np.cos(xx / (71.0 * p[2]) + yy / (131.0 * p[3])),
        128 + 70 * np.sin((xx + yy) / (157.0 * p[4] * p[5])),
    ], axis=-1)
    return np.clip(f + r.normal(0, 6, f.shape), 0, 255).astype(np.uint8)


def encode(job) -> bytes:
    seed, ri = job
    return encoder.encode(picture(seed), sampling="420", quality=95,
                          restart_interval_mcus=ri)


def pool_rows(datas, n: int):
    """The frames' rows, ``[n, nseg, W]`` int32 on the card, frame ``i``
    the ``i % len(datas)``-th, at the width their longest segment needs (a
    Decoder of their own: a decoder keeps the widest rows it has packed);
    and the first frame's PreparedFrame."""
    dec = Decoder(device="cuda", **KNOBS)
    pfs = [dec.prepare(d) for d in datas]
    w = max(p.rows.shape[1] for p in pfs)
    nseg = pfs[0].nseg
    rows = torch.zeros((n, nseg, w), dtype=torch.int32)
    for i in range(n):
        p = pfs[i % len(pfs)]
        rows[i, :, :p.rows.shape[1]] = torch.from_numpy(
            p.rows[:nseg].view(np.int32))
    return rows.cuda(), pfs[0]


def timed(fn, reps: int, per: int, burst: int = 4) -> float:
    """Median ms a frame of ``fn(i)`` over ``reps`` bursts."""
    fn(0)
    torch.cuda.synchronize()
    return statistics.median(burst_ms(fn, burst) for _ in range(reps)) / per


def tree_constants(csrc: str) -> dict:
    with open(os.path.join(csrc, "decode.cu")) as f:
        text = f.read()
    return {k: int(re.search(r"constexpr int %s = (\d+);" % k, text)[1])
            for k in ("SUB_BITS", "LEAD_SUBS", "ROUNDS", "STARTS")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", metavar="name=dir")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", help="also write the result JSON to this file")
    ap.add_argument("--sections", default="123")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_lanes: needs a CUDA card")
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"# card: {card}", flush=True)
    jobs = [(5, None), (6, None)] + [(5, ri) for ri in INTERVALS]
    with ProcessPoolExecutor(
            len(jobs), mp_context=multiprocessing.get_context("spawn")) as ex:
        datas = list(ex.map(encode, jobs))
    print(f"# frames: {[len(d) for d in datas]} bytes", flush=True)
    B = args.batch
    dec = Decoder(device="cuda", **KNOBS)
    pool, pf = pool_rows(datas[:2], POOL)
    g = pf.geom
    nb = POOL // B

    def batch(i):
        return pool[(i % nb) * B:(i % nb + 1) * B]

    res = {"card": card, "batch": B, "bytes": len(datas[0]), "L": {},
           "T": {}, "trees": {}, "profile": {}}
    bad = []
    if args.profile:  # every interval cut into lanes
        split, LN.SPLIT_MCUS = LN.SPLIT_MCUS, EVERY_SEGMENT
        for ri, data in zip((None,) + INTERVALS, [None] + datas[2:]):
            rows, pfr = (pool[:B], pf) if ri is None else pool_rows(
                [data], B)
            res["profile"][ri or 0] = kernels(lambda: dec.decode_rows(
                pfr, rows), B)
            print(f"profile ri={ri}: " + "  ".join(
                f"{k} {v:.5f}" for k, v in res["profile"][ri or 0].items()),
                flush=True)
        LN.SPLIT_MCUS = split
    split, lane_mcus = LN.SPLIT_MCUS, LN.LANE_MCUS
    LN.SPLIT_MCUS = NO_SEGMENT  # one lane a segment
    one = dec.decode_rows(pf, batch(0))
    if "1" in args.sections:
        res["one_lane"] = {
            "K3": timed(lambda i: F.fused_decode_planes(
                batch(i), pf.nseg, pf.tables, pf.op, g, exact=True), 3, B,
                1),
            "decode_rows": timed(lambda i: dec.decode_rows(pf, batch(i)), 3,
                                 B, 1)}
        print(f"one lane: {res['one_lane']}", flush=True)
    LN.SPLIT_MCUS = split
    for L in (1, 2, 4, 8, 16) if "1" in args.sections else ():
        LN.LANE_MCUS = L
        lanes = LN.lane_index(batch(0), pf.nseg, pf.tables, g, L)
        planes = F.fused_decode_planes(batch(0), pf.nseg, pf.tables, pf.op, g,
                                       exact=True, lanes=lanes)
        got = dec.decode_rows(pf, batch(0))
        torch.cuda.synchronize()
        if not torch.equal(got, one):
            bad.append(f"L={L}: pixels differ from the one-lane decode")
        row = {
            "lane_index": timed(lambda i: LN.lane_index(
                batch(i), pf.nseg, pf.tables, g, L), args.reps, B),
            "K3_lanes": timed(lambda i: F.fused_decode_planes(
                batch(i), pf.nseg, pf.tables, pf.op, g, exact=True,
                lanes=LN.LaneTable(lanes.table, L)), args.reps, B),
            "E": timed(lambda i: C.finalize_planes(
                planes, g.samplings, g.width, g.height, fancy=True),
                args.reps, B),
            "decode_rows": timed(lambda i: dec.decode_rows(pf, batch(i)),
                                 args.reps, B),
            "decode_rows_1": timed(lambda i: dec.decode_rows(
                pf, pool[i % POOL]), args.reps, 1)}
        res["L"][L] = row
        print(f"L={L}: " + "  ".join(f"{k} {v:.5f}" for k, v in row.items()),
              flush=True)
    LN.LANE_MCUS = lane_mcus  # the general L of the sweep stays in it
    for ri, data in zip(INTERVALS, datas[2:]) if "2" in args.sections else ():
        rows, pfr = pool_rows([data], B)
        LN.SPLIT_MCUS = NO_SEGMENT
        whole = dec.decode_rows(pfr, rows)
        t_one = timed(lambda i: dec.decode_rows(pfr, rows), args.reps, B)
        t_one_1 = timed(lambda i: dec.decode_rows(pfr, rows[i % B]),
                        args.reps, 1)
        LN.SPLIT_MCUS = EVERY_SEGMENT
        cut = dec.decode_rows(pfr, rows)
        torch.cuda.synchronize()
        if not torch.equal(cut, whole):
            bad.append(f"ri={ri}: lanes differ from one lane a segment")
        t_cut = timed(lambda i: dec.decode_rows(pfr, rows), args.reps, B)
        t_cut_1 = timed(lambda i: dec.decode_rows(pfr, rows[i % B]),
                        args.reps, 1)
        res["T"][ri] = {"one_lane": t_one, "lanes": t_cut,
                        "one_lane_1": t_one_1, "lanes_1": t_cut_1,
                        "L": LN.lane_length(ri, pfr.nseg, B)}
        print(f"ri={ri}: one lane a segment {t_one:.5f}, lanes of "
              f"{res['T'][ri]['L']} {t_cut:.5f} ms a frame of {B}; one "
              f"frame a call {t_one_1:.5f}, {t_cut_1:.5f}", flush=True)
    LN.SPLIT_MCUS = split
    want = LN.lane_index(batch(0), pf.nseg, pf.tables, g, 4).table
    for name, csrc in (t.split("=", 1) for t in args.trees
                       if "3" in args.sections):
        lib = _build.load(os.path.abspath(csrc))
        k = tree_constants(csrc)
        words = batch(0).shape[-1]
        subs = -(-words * 32 // k["SUB_BITS"])
        params = _build.make_params(
            -(-g.total_mcus // 4), words, 4, g.total_mcus, g.du_to_comp,
            samplings=g.samplings, frames=B, frame_rows=pf.nseg,
            table_of=pf.tables.table_of, seg_ri=g.total_mcus)
        table = torch.empty_like(want)
        scratch = torch.empty(
            B * pf.nseg * (subs * (2 + k["STARTS"]) * 4 + 1) + k["ROUNDS"],
            dtype=torch.int32, device="cuda")

        def run(i):
            _build.launch("compeg_lane_index", batch(i), pf.tables.packed,
                          scratch, table, params=params, lib=lib)
        run(0)
        torch.cuda.synchronize()
        if not torch.equal(table, want):
            bad.append(f"tree {name}: lane table differs")
        at = B * pf.nseg * subs * (2 + k["STARTS"]) * 4
        rounds = int(scratch[at:at + k["ROUNDS"]].sum())
        ms = timed(run, args.reps, B)
        res["trees"][name] = dict(k, lane_index=ms, rounds_changed=rounds)
        print(f"tree {name} {k}: L {ms:.5f} ms a frame, {rounds} rounds "
              "changed an entry", flush=True)
    res["differences"] = bad
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    if bad:
        print("; ".join(bad))
        return 1
    return 0


def kernels(fn, per: int) -> dict:
    """The card's ms a frame of each kernel that three calls of ``fn``
    launch, by name, from a ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        ms = getattr(e, "device_time_total", 0) / 1e3 / 3 / per
        if ms > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = re.sub(r"^void |[(].*$", "", name)[:48]
            out[name] = out.get(name, 0.0) + ms
    return out


if __name__ == "__main__":
    sys.exit(main())
