"""The decode kernels with the Huffman tables shared or not: check and time.

    python -m compeg_tpu_torch.tools.exp_table_packing [--reps 20] [--out FILE]

``ops/entropy.pack_tables`` packs each distinct table of a frame once and
maps every component's DC and AC table onto those rows (``table_of``); in
4:2:2 and 4:2:0 the two chroma components usually share theirs, so
``bench_assets/bench4k.jpg`` needs four tables, not six. Each packed table
takes ``TAB_WORDS`` words of every block's shared memory, so sharing can
keep a block on a multiprocessor. On the 4K frame every kernel that reads
the tables (K1, K2, K2x, K3 integer and float, K2s at k = 1) runs with the
package's packing and with one table per component and class; the outputs
must be equal (else the exit code is 1), and the two are timed in turns
(``compare_csrc.time_in_turns``: medians of bursts of 8 launches, the card's
time, ``profiling.burst_ms``).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys

import torch

from ..ops import entropy as E
from ..ops import fused as F
from ..ops import idct as D
from ..pipeline import Decoder
from .compare_csrc import BENCH, BURST, time_in_turns


def per_component(tables: E.EntropyTables) -> E.EntropyTables:
    """``tables`` with one packed row for each component's DC and AC table,
    shared or not."""
    out = copy.copy(tables)
    out.packed = tables.packed[list(tables.table_of)].contiguous()
    out.table_of = tuple(range(len(tables.table_of)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", help="also write the result JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_table_packing: needs a CUDA card")
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    with open(BENCH, "rb") as f:
        data = f.read()
    dec = Decoder(device="cuda")
    pf = dec.prepare(data)
    rows = dec.upload(pf)
    qz = Decoder(device="cuda", exact_idct=True).prepare(data).op
    lq1 = D.scaled_operators(D.qz_by_slot_array(pf.image), 1, device="cuda")
    g, nseg = pf.geom, pf.nseg
    kernels = {
        "K1": lambda t: (E.entropy_decode(rows, nseg, t, g.ri, g.total_mcus,
                                          g.du_to_comp),),
        "K2": lambda t: (F.fused_decode_rgba(rows, nseg, t, pf.op, g),),
        "K2x": lambda t: (F.fused_decode_rgba_exact(rows, nseg, t, qz, g),),
        "K3 int": lambda t: F.fused_decode_planes(rows, nseg, t, qz, g,
                                                  exact=True),
        "K3 float": lambda t: F.fused_decode_planes(rows, nseg, t, pf.op, g),
        "K2s k=1": lambda t: (F.fused_decode_scaled(rows, nseg, t, lq1, g,
                                                    1),),
    }
    shared, each = pf.tables, per_component(pf.tables)
    print(f"card: {card}; table_of {shared.table_of}: {shared.packed.shape[0]} "
          f"tables shared against {each.packed.shape[0]}", flush=True)
    result = {"card": card, "reps": args.reps, "burst": BURST,
              "tables": [shared.packed.shape[0], each.packed.shape[0]],
              "ms": {}, "equal": {}}
    for name, run in kernels.items():
        result["equal"][name] = all(
            torch.equal(a, b) for a, b in zip(run(shared), run(each)))
        ms = time_in_turns([lambda i, t=shared: run(t),
                            lambda i, t=each: run(t)], args.reps, BURST)
        result["ms"][name] = {"shared": ms[0], "per component": ms[1]}
        print(f"{name}: shared {ms[0]:.4f}  per component {ms[1]:.4f}  "
              f"outputs equal {result['equal'][name]}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0 if all(result["equal"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
