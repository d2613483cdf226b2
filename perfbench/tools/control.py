"""The control of a cell's comparison: the plain reference at the next
lower precision than the configuration states, put in the program's place
on as many of the cell's frames as a run compares, for each seed.

    python3 perfbench/tools/control.py --workload <cell> --seeds 1 2 3

Prints one JSON line a seed with each compared number, the limit, and
whether the control failed it. Its readings are each limit's upper end
(PERF.md). CPU work only; the benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from perfbench.harness import bench, check  # noqa: E402
from perfbench.inputs import frames as F  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    root = os.path.dirname(bench.PERFBENCH)
    spec = bench.load_json(os.path.join(root, "BENCHMARK.json"))
    cell = bench.find(spec, "workloads", args.workload)
    cfg = bench.load_json(os.path.join(
        root, bench.find(spec, "configs", cell["config"])["file"]))
    traffic = bench.load_json(os.path.join(bench.PERFBENCH, "traffic",
                                           f"{cell['traffic']}.json"))
    src = F.source(cfg)
    k = traffic["check_expected"]
    for seed in args.seeds:
        idx = F.rng(seed, 5).choice(traffic["pool_frames"], k, replace=False)
        got = check.compare(cfg, lambda j: src.frame(seed, j),
                            [(int(j), None) for j in idx], k,
                            control=cfg["reference"]["control"],
                            lanes=lambda j: src.lanes(seed, j))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": cfg["reference"]["control"],
                          "numbers": {n: {"value": v, "limit": lim,
                                          "failed": v > lim}
                                      for n, (v, lim) in got.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
