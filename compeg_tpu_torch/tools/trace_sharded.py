"""The banded decode against the unbanded one on a world of one rank, the
counterpart of tools/trace_sharded.py.

    python -m compeg_tpu_torch.tools.trace_sharded [N_BANDS]
    python -m compeg_tpu_torch.tools.trace_sharded 1 --device cpu

The 4K frame decoded unbanded (``Decoder.decode_prepared``) and in
``N_BANDS`` bands (default 1) by ``parallel/sharding.decode_frames_sharded``
with the rank's ``BatchDecoder``, in a process group of one rank (NCCL on
the card, gloo on the CPU, ``tcp://127.0.0.1:<free port>``) on its 1 x 1
mesh, as ``chip_smoke.py`` phase l runs it. Exits non-zero unless the two
are equal byte for byte. Prints both device totals
(``profiling.trace_device_ms``: the card's busy time, host transfers not
counted) and their ratio beside the JAX tool's stated target of 1.10; the
ratio is printed, not gated, as there. Ends with one JSON line;
``--device cpu`` decodes a 64 x 128 frame and times nothing.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from . import _common as K

TARGET = 1.10  # the JAX tool's stated bound on banded / unbanded
REPS = 5


def run(argv: Optional[List[str]] = None) -> dict:
    import torch
    import torch.distributed as dist

    from .. import profiling
    from ..batch import BatchDecoder
    from ..parallel import multihost as MH
    from ..parallel import sharding as SH
    from ..pipeline import Decoder

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_bands", nargs="?", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = K.device(args.device)
    cuda = dev.type == "cuda"
    info = K.card(dev)
    data = K.workload(dev)

    dec = Decoder(device=dev)
    pf = dec.prepare(data)
    out0 = dec.decode_prepared(pf)

    dist.init_process_group("nccl" if cuda else "gloo", world_size=1, rank=0,
                            init_method=f"tcp://127.0.0.1:{MH.free_port()}")
    try:
        mesh = SH.make_mesh(1, 1, dev.type)
        sd = BatchDecoder(device=dev)

        def banded():
            return SH.decode_frames_sharded([data], mesh, args.n_bands,
                                            decoder=sd)

        out = banded()
        equal = bool(out.shape[0] == 1 and torch.equal(out[0], out0))
        print(f"banded ({args.n_bands} bands) == unbanded: {equal}",
              flush=True)
        res = {"n_bands": args.n_bands, "equal": equal, "unbanded_ms": None,
               "banded_ms": None, "ratio": None, "target": TARGET,
               "device": info}
        if cuda:
            un, un_rows = profiling.trace_device_ms(
                lambda: dec.decode_prepared(pf), REPS)
            sh, sh_rows = profiling.trace_device_ms(banded, REPS)
            for tag, ms, rows in (("unbanded", un, un_rows),
                                  (f"banded_1x1_b{args.n_bands}", sh,
                                   sh_rows)):
                print(f"--- {tag} ---")
                for t, c, name in rows[:12]:
                    print(f"{t:8.4f} ms/frame x{c} {name[:72]}")
                print(f"DEVICE {tag}: {ms:.4f} ms/frame", flush=True)
            print(f"RATIO banded/unbanded (device busy): {sh / un:.3f} "
                  f"(target <= {TARGET:.2f}) on {info['name']}, "
                  f"{info['power_limit_w']} W", flush=True)
            res.update(unbanded_ms=un, banded_ms=sh, ratio=sh / un)
    finally:
        dist.destroy_process_group()
    return K.emit(res)


def main(argv: Optional[List[str]] = None) -> int:
    res = run(argv)
    if not res["equal"]:
        print("trace_sharded: FAIL, the banded decode differs from the "
              "unbanded one", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
