"""A small stand-in for every cell, for runs of the harness on the CPU."""

import time

from perfbench.harness import bench

SMALL = {
    "config": {"width": 128, "height": 128,
               "base": {"width": 128, "height": 128, "images": 2,
                        "content_seed": 7}},
    "traffic": {"pool_frames": 8, "warm_frames": 2, "check_frames": 3,
                "check_expected": 3, "prepare_threads": 2, "batch": 4,
                "check_batches": 2, "warm_batches": 1,
                "trace": {"at_s": 0.05, "warm_s": 0.05, "stretch_s": 0.1}},
}
CELLS = ("cam1080_420_exact_fancy.oneshot", "uvc4k_422.resident",
         "cam1080_420_exact_fancy.resident")


def run_small(cell, capsys, seed=2**31 + 77, trace=0, seconds=1.0,
              root=bench.os.path.dirname(bench.PERFBENCH)):
    """One run of ``cell`` at the small size on the CPU; the result line
    (a dict) and the return code."""
    import json

    overrides = {k: dict(v) for k, v in SMALL.items()}
    rc = bench.run(["--workload", cell, "--seed", str(seed), "--seconds",
                    str(seconds), "--trace", str(trace)],
                   time.perf_counter(), root, device="cpu",
                   overrides=overrides)
    out = capsys.readouterr().out.strip().splitlines()
    return (json.loads(out[-1]) if out else None), rc
