"""The relayout probes on the port's kernels: check and time.

    python -m compeg_tpu_torch.tools.exp_relayout            # on the card
    python -m compeg_tpu_torch.tools.exp_relayout --device cpu --groups 2

Counterpart of the JAX package's tools/exp_interleave.py (P1),
tools/exp_swap_pallas.py (P2), tools/exp_assembly2.py (P3) and
tools/exp_mosaic_bisect.py (P4). At the probes' own shapes, on inputs from
``np.random.default_rng(0)``, every kernel of ``ops/relayout.py`` is held to
numpy's answer, the expression the JAX tool calls ``want``, and must equal
it bit for bit. On a CUDA device each line then gives the kernel's
CUDA-event time (median), the time of the one PyTorch call that computes the
same function (``permute(...).contiguous()``, ``clone()``: the plain
version), and the bound: bytes read once plus bytes written once over the
card's 3.35 TB/s. A timing is a burst of ``BURST`` launches between two
events, enqueued while the card still spins in a kernel before them
(``profiling.burst_ms``), divided by their number: one launch of these
kernels takes the card less time than the host takes to launch it, so
launches timed one by one would time the host. Successive launches alternate between two copies of
the input, so that a launch does not find its input in the 50 MB L2.

P2 runs on both of its routes: to the 4K raster's width (the 16-byte
kernel) and two words narrower (the word tile). It also runs on the real
thing, as tools/exp_swap_pallas.py does: the port's
decode writes the raster itself and has no slab, so the slab is built from
``Decoder().decode_prepared`` of ``bench_assets/bench4k.jpg`` by the inverse
permutation (plain PyTorch), and the kernel must give the decode back bit
for bit. Any mismatch exits non-zero.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops import relayout as R
from ..profiling import burst_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
S, L, X, RR = 8, 128, 16, 8  # sublanes, lanes, mw, mh of the probes
BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "bench_assets", "bench4k.jpg")


def _random(shape) -> np.ndarray:
    return np.random.default_rng(0).integers(0, 1 << 24, shape,
                                             dtype=np.uint32)


def _dev(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int32)).to(device)


BURST = 8  # launches between two events


def cuda_ms(fn: Callable[[int], torch.Tensor], reps: int) -> float:
    """Median CUDA-event time per launch of ``fn(i)`` over ``reps`` bursts
    of ``BURST`` launches."""
    for i in range(2):
        fn(i)
    return statistics.median(burst_ms(fn, BURST) for _ in range(reps))


def probe(name: str, probe_id: str, kernel: Callable, plain: Callable,
          inputs_np: List[np.ndarray], want: np.ndarray, device,
          reps: int, view: Optional[Callable] = None,
          read_words: Optional[int] = None) -> Dict:
    """Run ``kernel(*inputs)`` on ``device``, require ``want``, and time it
    and ``plain`` where the device is a CUDA card. ``view`` picks the kernel's
    operands out of the uploaded tensors (a strided slice, say);
    ``read_words`` is what the function must read of them where that is less
    than all of them (a crop), for the bound."""
    view = view or (lambda *t: t)
    sets = [[_dev(a, device) for a in inputs_np] for _ in range(2)]
    got = kernel(*view(*sets[0]))
    ok = (tuple(got.shape) == want.shape and np.array_equal(
        got.cpu().numpy().view(np.uint32), want))
    if read_words is None:
        read_words = sum(t.numel() for t in view(*sets[0]))
    nbytes = (read_words + got.numel()) * 4
    res = {"name": name, "probe": probe_id, "ok": bool(ok), "bytes": nbytes,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ms": None,
           "library_ms": None,
           "max_abs_err": int(np.abs(got.cpu().numpy().astype(np.int64)
                                     - want.view(np.int32)).max())
           if tuple(got.shape) == want.shape else None}
    if torch.device(device).type == "cuda":
        res["ms"] = cuda_ms(lambda i: kernel(*view(*sets[i % 2])), reps)
        res["library_ms"] = cuda_ms(lambda i: plain(*view(*sets[i % 2])), reps)
    return res


def probes(device, reps: int = 20, groups: Optional[int] = None) -> List[Dict]:
    """Every kernel at the probes' shapes (``groups`` cuts G for a CPU run)."""
    out = []
    # P1, tools/exp_interleave.py: G = 64 blocks of [S, R, X, L].
    g1 = groups or 64
    x1 = _random((g1, S, RR, X, L))
    want = x1.transpose(0, 1, 2, 4, 3).reshape(g1, S, RR, L * X)
    out.append(probe("relayout_interleave", "P1 interleave",
                     R.relayout_interleave, R.relayout_interleave_reference,
                     [x1], want, device, reps))
    out.append(probe("relayout_interleave", "P1 interleave + row stack",
                     lambda v: R.relayout_interleave(v, stack_rows=True),
                     lambda v: R.relayout_interleave_reference(v, True),
                     [x1], want.reshape(g1, S * RR, L * X), device, reps))
    out.append(probe("relayout_spread_merge", "P1 copy floor",
                     R.relayout_copy, torch.clone, [x1], x1, device, reps))
    # P2, tools/exp_swap_pallas.py: the 4K slab [34, 64, 2 * 16 * 128].
    n_tr = groups or 34
    h, w = n_tr * 64 - 16, 3840
    slab = _random((n_tr, 64, 2 * X * L))
    want = (slab.reshape(n_tr * 64, 2, X, L).transpose(0, 1, 3, 2)
            .reshape(n_tr * 64, 2 * L * X)[:h, :w])
    out.append(probe("relayout_swap_crop", "P2 swap + crop",
                     lambda v: R.relayout_swap_crop(v, X, h, w),
                     lambda v: R.relayout_swap_crop_reference(v, X, h, w),
                     [slab], np.ascontiguousarray(want), device, reps,
                     read_words=h * w))
    # ... to rows of no whole vectors: the word route.
    out.append(probe("relayout_swap_crop", "P2 swap + crop, word route",
                     lambda v: R.relayout_swap_crop(v, X, h, w - 2),
                     lambda v: R.relayout_swap_crop_reference(v, X, h, w - 2),
                     [slab], np.ascontiguousarray(want[:, :w - 2]), device,
                     reps, read_words=h * (w - 2)))
    # P3, tools/exp_assembly2.py: G = 34 * 2 blocks.
    g3 = groups or 68
    x3 = _random((g3, S, RR, X, L))
    want = x3.transpose(0, 3, 1, 2, 4).reshape(g3, X, S * RR, L)
    out.append(probe("relayout_stack", "P3 sublane stack", R.relayout_stack,
                     R.relayout_stack_reference, [x3], want, device, reps))
    out.append(probe("relayout_spread_merge", "P3 copy floor",
                     R.relayout_copy, torch.clone, [x3], x3, device, reps))
    # P4, tools/exp_mosaic_bisect.py: one block [S, R, X, L], eight
    # constructs on four kernels.
    x4 = _random((S, RR, X, L))
    spread = np.repeat(x4[:, 0, 0, :], X, axis=1)
    merged = np.where((np.arange(L * X)[None, :] & (X - 1)) == 0, spread,
                      np.repeat(x4[:, 0, 1, :], X, axis=1))
    inter = np.zeros((S, L * X), np.uint32)
    for x in range(X):
        inter[:, x::X] = x4[:, 0, x, :]
    out.append(probe("relayout_spread_merge", "P4 copy", R.relayout_copy,
                     torch.clone, [x4], np.ascontiguousarray(x4[:, 0, 0, :]),
                     device, reps, view=lambda t: (t[:, 0, 0, :],)))
    out.append(probe(
        "relayout_spread_merge",
        "P4 lane spread (bcast_reshape, jnp_repeat, pltpu_repeat)",
        lambda a: R.relayout_spread(a, X),
        lambda a: a.repeat_interleave(X, dim=1), [x4], spread, device, reps,
        view=lambda t: (t[:, 0, 0, :],)))
    out.append(probe(
        "relayout_spread_merge", "P4 where_merge",
        lambda a, b: R.relayout_spread_merge(a, b, X),
        lambda a, b: R.relayout_spread_merge_reference(a, b, X), [x4],
        merged, device, reps,
        view=lambda t: (t[:, 0, 0, :], t[:, 0, 1, :])))
    out.append(probe(
        "relayout_stack", "P4 stack_sublanes",
        lambda v: R.relayout_stack(v)[0, 0],
        lambda v: R.relayout_stack_reference(v)[0, 0], [x4[None]],
        np.ascontiguousarray(x4[:, :, 0, :].reshape(S * RR, L)), device,
        reps))
    out.append(probe(
        "relayout_interleave",
        "P4 strided_lane_store, full_where_interleave",
        R.relayout_interleave, R.relayout_interleave_reference, [x4], inter,
        device, reps, view=lambda t: (t[:, 0],)))
    return out


def swap_on_decode(device, reps: int = 20, path: str = BENCH) -> Dict:
    """P2 on the real thing: decode ``path`` (the 4K frame), build its slab
    by the inverse permutation, and require the kernel to return the decode
    bit for bit."""
    from ..pipeline import Decoder

    with open(path, "rb") as f:
        data = f.read()
    dec = Decoder(device=device)
    pf = dec.prepare(data)
    img = dec.decode_prepared(pf)
    g = pf.geom
    mh = 8 * max(v for _, v in g.samplings)
    mw = 8 * max(h for h, _ in g.samplings)
    x, rt = g.ri * mw, S * mh
    slab = R.swap_crop_inverse(img, x, rt)
    got = R.relayout_swap_crop(slab, x, g.height, g.width)
    nbytes = 2 * got.numel() * 4  # the kept words, read once, written once
    res = {"name": "relayout_swap_crop",
           "probe": f"P2 on the decode of {os.path.basename(path)} "
                    f"(slab {list(slab.shape)} -> {list(got.shape)})",
           "ok": bool(torch.equal(got, img)), "bytes": nbytes,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ms": None,
           "library_ms": None,
           "max_abs_err": int((got.long() - img.long()).abs().max())}
    if torch.device(device).type == "cuda":
        slabs = [slab, slab.clone()]
        res["ms"] = cuda_ms(lambda i: R.relayout_swap_crop(
            slabs[i % 2], x, g.height, g.width), reps)
        res["library_ms"] = cuda_ms(lambda i: R.relayout_swap_crop_reference(
            slabs[i % 2], x, g.height, g.width), reps)
    return res


def report(res: Dict) -> str:
    def ms(v):
        return "not measured" if v is None else f"{v:.4f} ms"

    return (f"{res['probe']}: {res['name']} correct={res['ok']}  kernel "
            f"{ms(res['ms'])}  library {ms(res['library_ms'])}  bound "
            f"{res['bound_ms']:.4f} ms ({res['bytes']} B)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--groups", type=int, default=None,
                    help="cut the probes' G (and P2's tile rows) to this")
    ap.add_argument("--no-decode", action="store_true",
                    help="skip P2 on the 4K decode")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("exp_relayout: no CUDA device; --device cpu checks the "
                  "plain versions only")
            return 1
        print(f"device: {torch.cuda.get_device_name(device)}")
    results = probes(device, args.reps, args.groups)
    if not args.no_decode:
        results.append(swap_on_decode(device, args.reps))
    for res in results:
        print(report(res), flush=True)
    bad = [r["probe"] for r in results if not r["ok"]]
    if bad:
        print(f"MISMATCH: {bad}")
        return 1
    print("all relayouts equal numpy's answer")
    return 0


if __name__ == "__main__":
    sys.exit(main())
