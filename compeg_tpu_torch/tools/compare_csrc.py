"""Two or more trees of the kernel sources, timed beside each other on one
card in one process.

    python -m compeg_tpu_torch.tools.compare_csrc parent=checkout_tmp/parent_csrc
    python -m compeg_tpu_torch.tools.compare_csrc a=dir_a b=dir_b --no-change

Each ``name=dir`` is a directory that holds a whole ``csrc`` (every ``.cu``
and ``.cuh``, with the package's C entry points), such as the parent
commit's, unpacked with ``git archive`` into a directory that git ignores.
The package's own ``compeg_tpu_torch/csrc`` is added last under the name
``change``. Every tree is built with the package's nvcc flags into
``build/compeg_tpu_torch/`` and bound with ctypes; the package's wrappers
are not used, so a tree is driven through its C entry points with the
package's launch parameters (a tree that knows fewer parameter fields reads
the ones it knows: new fields are only ever added at the end) and the
Huffman tables in the layout it reads: ``ops/entropy.pack_tables`` at the
tree's own ``LUT_BITS`` (csrc/entropy.cuh), or, for a tree that has none,
the int32 ``[C, 2, 292]`` block of the kernels before the first-level
lookup (:func:`legacy_packed`).

On ``bench_assets/bench4k.jpg``, the same frame with garbage entropy bits
(``testdata.garbage_scan``, seed 5) and the small streams of
``testdata/smoke.npz`` every fused kernel (K2, K2x, K3 integer and float,
K2s at k = 1, 2, 4), K1, every relayout call of :func:`relayout_calls`
(the copy, spread and merge, the interleave on both routes, the swap and
crop on both) and the planes epilogue E on the inputs of
:func:`epilogue_calls` (the 4K frame's integer planes, seeded 4K planes
of every sampling that E has an instantiation for, a batch of 64 frames,
band frames with halo rows and with a content edge; nearest and fancy)
of every tree must give the first tree's output bit for bit; a
difference is reported with its size and makes the exit code 1. Then the times: CUDA events around a burst
of ``BURST`` launches enqueued while the card still spins in a kernel
before them (``profiling.burst_ms``: the card, not the host's launch path,
sets the time), divided by their number, the trees taking turns (forward in even
rounds, backward in odd ones), the median of ``--reps`` rounds per tree; K2,
K2x and K3 also on a batch of ``FRAMES`` copies of the frame, per frame;
each relayout call alternating between two inputs so that no launch finds
its input in the L2 cache, beside the one PyTorch call of the same
function (``library``: ``clone()``, ``transpose(-1, -2).contiguous()``,
the swap's reshape, transpose and crop) in the same rounds; E likewise on
two plane sets (the batch per frame), each beside its bound (the planes and
halos read once and the raster written once at 3.35 TB/s, ``bound_ms``).
``--kernels decode``, ``relayout`` or ``epilogue`` takes one part.
``--ptxas`` prints what ``nvcc -Xptxas -v`` says of each tree's decode.cu,
relayout.cu and epilogue.cu (those of the part taken; registers, spills)
first. One JSON object with every median is printed and, with ``--out``,
written to that file.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
from typing import Callable, Dict, List, Optional

import torch

from .. import testdata
from ..metadata import analyze
from ..ops import _build
from ..ops import color as C
from ..ops import entropy as E
from ..ops import fused as F
from ..ops import idct as D
from ..ops import relayout as R
from ..pipeline import Decoder
from ..profiling import burst_ms
from .exp_relayout import BENCH

SCALES = (1, 2, 4)
BURST = 8  # launches between two events
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM's device memory (data sheet)
FRAMES = 64  # copies of the 4K frame in the batch


def ptxas_report(csrc: str, names=("decode.cu", "relayout.cu",
                                     "epilogue.cu")) -> str:
    """The resource lines of ``nvcc -Xptxas -v`` for the sources ``names``
    of ``csrc`` that it holds."""
    lines = []
    for name in names:
        if not os.path.exists(os.path.join(csrc, name)):
            continue
        res = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             os.devnull, os.path.join(csrc, name)],
            capture_output=True, text=True)
        if res.returncode != 0:
            return res.stderr
        lines += [ln.strip() for ln in res.stderr.splitlines()
                  if "Compiling entry" in ln or "registers" in ln
                  or "spill" in ln]
    return "\n".join(lines)


def tree_lut_bits(csrc: str) -> Optional[int]:
    """The first-level lookup's window bits of the tree ``csrc`` (its
    entropy.cuh's ``LUT_BITS``), None for a tree without the lookup."""
    path = os.path.join(csrc, "entropy.cuh")
    text = open(path).read() if os.path.exists(path) else ""
    found = re.search(r"constexpr int LUT_BITS = (\d+);", text)
    return int(found[1]) if found else None


def legacy_packed(tables: E.EntropyTables) -> torch.Tensor:
    """The tables as the kernels before the first-level lookup read them:
    ``[C, 2, 292]`` int32, limits[17], delta[17], max_len, num_values,
    values[256] of each component's DC and AC table."""
    return torch.cat([tables.limits, tables.delta, tables.max_len[..., None],
                      tables.num_values[..., None], tables.values],
                     dim=-1).contiguous()


LAYOUT: Dict[object, Optional[int]] = {}  # library -> its tree's LUT_BITS


def frame_calls(data: bytes, device) -> Dict[str, Callable]:
    """For one JPEG, ``name -> fn(lib)`` that launches that kernel of
    library ``lib`` and returns its outputs (a tuple of tensors)."""
    dec = Decoder(device=device)
    pf = dec.prepare(data)
    rows = dec.upload(pf)
    g, nseg, tables = pf.geom, pf.nseg, pf.tables
    packs = {}

    def packed(lib):
        bits = LAYOUT.get(lib, E.LUT_BITS)
        if bits not in packs:
            packs[bits] = (legacy_packed(tables) if bits is None
                           else E.pack_tables(tables, bits)[1])
        return packs[bits]
    qsl = D.qz_by_slot_array(pf.image)
    xdec = Decoder(device=device, exact_idct=True)
    qz = xdec.prepare(data).op
    lq = {k: D.scaled_operators(qsl, k, device=device) for k in SCALES}

    def rgba(entry, op, geom=g, blk=8, src=rows):
        def call(lib, i=0):
            out = torch.empty(F._batched((geom.height, geom.width), src),
                              dtype=torch.int32, device=device)
            _build.launch(entry, src, packed(lib), op, out, lib=lib,
                          params=F._params(src, nseg, tables, geom, blk))
            return (out,)
        return call

    def planes(entry, op, src=rows):
        def call(lib, i=0):
            outs = [torch.empty(F._batched(s, src), dtype=torch.uint8,
                                device=device) for s in F.plane_shapes(g)]
            _build.launch(entry, src, packed(lib), op,
                          *(outs + [None] * (3 - len(outs))), lib=lib,
                          params=F._params(src, nseg, tables, g))
            return tuple(outs)
        return call

    def k1(lib, i=0):
        out = torch.empty((nseg, g.ri, len(g.du_to_comp), 64),
                          dtype=torch.int32, device=device)
        _build.launch("compeg_entropy_decode", rows, packed(lib), out,
                      lib=lib, params=F._params(rows, nseg, tables, g))
        return (out,)

    calls = {
        "K2": rgba("compeg_fused_decode", pf.op),
        "K2x": rgba("compeg_fused_decode_exact", qz),
        "K3 int": planes("compeg_fused_decode_planes_exact", qz),
        "K3 float": planes("compeg_fused_decode_planes", pf.op),
        "K1": k1,
    }
    for k in SCALES:
        calls[f"K2s k={k}"] = rgba("compeg_fused_decode_scaled", lq[k],
                                   F.scaled_geometry(g, k), k)
    calls["_batch"] = lambda b: {
        "K2": rgba("compeg_fused_decode", pf.op, src=_stack(rows, b)),
        "K2x": rgba("compeg_fused_decode_exact", qz, src=_stack(rows, b)),
        "K3 int": planes("compeg_fused_decode_planes_exact", qz,
                         src=_stack(rows, b)),
        "K3 float": planes("compeg_fused_decode_planes", pf.op,
                           src=_stack(rows, b)),
    }
    return calls


def _stack(rows: torch.Tensor, b: int) -> torch.Tensor:
    return rows.unsqueeze(0).expand(b, *rows.shape).contiguous()


def relayout_calls(device) -> Dict[str, tuple]:
    """``name -> (fn(lib, i), library)``: the copy of a 4K raster (aligned,
    and one word off), of its rows strided (whole vectors, and ragged from
    word 1 to 3837), of 4,095 words, the aligned views also forced onto the
    shift kernel (a tree before it runs its word kernel there), and the
    16-fold spread and merge, through each tree's P4 entry point; the
    interleave at the probe's shape (``[4096, 16, 128]``, 33.5 MB) on the
    route ``interleave_route`` picks and on the word route, and at the word
    route's shapes of chip_smoke's
    phase (i) (one word off, X = 3, X = 64, L = 130), through each tree's
    P1 entry point; the swap and crop of the 4K slab (``[34, 64, 4096] ->
    [2160, 3840]``, the vector route) and of the same slab to a width of
    3838 (the word route), through each tree's P2 entry point. ``library``
    is ``fn(i)``, the one PyTorch call of the same function that is timed
    beside the trees (``clone()``, ``transpose(-1, -2).contiguous()``, the
    swap's reshape, transpose and crop), or None. A tree reads the launch
    parameters it knows: an older one ignores ``vec`` of the swap."""
    bigs = [torch.randint(0, 1 << 24, (2160 * 3840 + 4,), dtype=torch.int32,
                          device=device) for _ in range(2)]
    grid = [b[:2160 * 3840].reshape(2160, 3840) for b in bigs]
    small = torch.randint(0, 1 << 24, (2, 2160, 240), dtype=torch.int32,
                          device=device)

    def p4(a2, b2, x, vec=None):
        def call(lib, i=0):
            a, b = a2[i % 2], b2[i % 2]
            n, l = a.shape
            out = torch.empty((n, l * x), dtype=torch.int32, device=device)
            route = R.spread_merge_route(a.data_ptr(), out.data_ptr(), n, l,
                                         x, a.stride(0))
            _build.launch("compeg_relayout_spread_merge", a, b, out, lib=lib,
                          params=_build.RelayoutParams(
                              n=n, l=l, x=x, in_stride=a.stride(0),
                              vec=int(route == "vec") if vec is None else vec))
            return (out,)
        return call

    def p1(mats, vec=None):
        def call(lib, i=0):
            a = mats[i % 2]
            n, x, l = a.shape
            out = torch.empty((n, l * x), dtype=torch.int32, device=device)
            route = R.interleave_route(a.data_ptr(), out.data_ptr(), n, x, l,
                                       a.stride(0))
            _build.launch("compeg_relayout_interleave", a, out, lib=lib,
                          params=_build.RelayoutParams(
                              n=n, x=x, l=l, in_stride=a.stride(0),
                              vec=int(route == "vec") if vec is None else vec))
            return (out,)
        return call

    def transpose(mats):
        return lambda i: mats[i % 2].transpose(-1, -2).contiguous()

    slabs = [torch.randint(0, 1 << 24, (34, 64, 4096), dtype=torch.int32,
                           device=device) for _ in range(2)]

    def p2(width):
        def call(lib, i=0):
            slab = slabs[i % 2]
            out = torch.empty((2160, width), dtype=torch.int32, device=device)
            route = R.swap_crop_route(slab.data_ptr(), out.data_ptr(), 16,
                                      width)
            _build.launch("compeg_relayout_swap_crop", slab, out, lib=lib,
                          params=_build.RelayoutParams(
                              n=34 * 64 * 2, x=16, l=R.LANES, tiles=2,
                              h=2160, w=width, vec=int(route == "vec")))
            return (out,)
        return call

    def swap(width):
        return lambda i: R.relayout_swap_crop_reference(slabs[i % 2], 16, 2160,
                                                        width)

    n1 = 64 * 8 * 8
    bases = [torch.randint(0, 1 << 24, (n1 * 16 * 130 + 8,),
                           dtype=torch.int32, device=device)
             for _ in range(2)]
    views = {
        "one word off": lambda b: b[1:1 + n1 * 2048].reshape(n1, 16, 128),
        "X = 3": lambda b: b[:n1 * 384].reshape(n1, 3, 128),
        "X = 64": lambda b: b[:n1 * 2048].reshape(n1, 64, 32),
        "L = 130": lambda b: b[:n1 * 2080].reshape(n1, 16, 130),
    }
    mats = [b[:2160 * 3840 // 2048 * 2048].reshape(-1, 16, 128) for b in bigs]
    off = [b[1:1 + 2160 * 3840].reshape(2160, 3840) for b in bigs]
    cols = [g[:, :3836] for g in grid]
    ragged = [g[:, 1:3838] for g in grid]
    short = [b[:4095].reshape(1, 4095) for b in bigs]
    clone = lambda i: grid[i % 2].clone()  # noqa: E731
    calls = {
        "copy 33.5 MB": (p4(grid, grid, 1), clone),
        "copy 33.5 MB, shift kernel": (p4(grid, grid, 1, 0), clone),
        "copy 33.5 MB, one word off": (p4(off, off, 1),
                                       lambda i: off[i % 2].clone()),
        "copy of strided rows": (p4(cols, cols, 1),
                                 lambda i: cols[i % 2].clone()),
        "copy of strided rows, shift kernel": (p4(cols, cols, 1, 0),
                                               lambda i: cols[i % 2].clone()),
        "copy of strided rows, ragged": (p4(ragged, ragged, 1),
                                         lambda i: ragged[i % 2].clone()),
        "copy of 4,095 words": (p4(short, short, 1),
                                lambda i: short[i % 2].clone()),
        "spread x16 to 33.5 MB": (p4([small[0]] * 2, [small[0]] * 2, 16),
                                  None),
        "merge x16 to 33.5 MB": (p4([small[0]] * 2, [small[1]] * 2, 16),
                                 None),
        "interleave 33.2 MB": (p1(mats), transpose(mats)),
        "interleave 33.2 MB, word kernel": (p1(mats, 0), transpose(mats)),
    }
    for name, view in views.items():
        vs = [view(b) for b in bases]
        calls[f"interleave, word route, {name}"] = (p1(vs), transpose(vs))
    calls["swap_crop 4K slab to [2160, 3840]"] = (p2(3840), swap(3840))
    calls["swap_crop 4K slab to [2160, 3838], word route"] = (p2(3838),
                                                              swap(3838))
    return calls


def epilogue_calls(planes422, geom, device) -> Dict[str, tuple]:
    """``name -> (fn(lib, i), bytes)`` of the planes epilogue E, nearest and
    fancy, through each tree's C entry point: over ``planes422`` (the 4K
    frame's integer planes from K3) and a copy of them at other addresses;
    over two seeded random 4K frames of each of 4:2:0, 4:4:0, and (nearest
    only: nothing filters) 4:4:4, 4:1:1 and gray; over a batch of ``FRAMES``
    copies of the 4K planes in one launch (one input: 2.1 GB of output
    leave nothing of it in L2); and, fancy only, over the 4:2:0 frames cut
    into four band frames of one launch with their ``above`` and ``below``
    halo rows, and with a content edge (``valid``) instead of ``below``.
    Call ``i`` reads input ``i % 2``, so no launch finds its planes in the
    L2 cache. ``bytes`` are the planes and halos read once and the raster
    written once."""
    s420 = ((2, 2), (1, 1), (1, 1))

    def seeded(samplings, seed):
        """Random 4K planes of ``samplings`` (luma's factors the largest)."""
        h0, v0 = samplings[0]
        return tuple(
            torch.randint(0, 256, (2160 * v // v0, 3840 * h // h0),
                          generator=torch.Generator(device).manual_seed(
                              seed + c), dtype=torch.uint8, device=device)
            for c, (h, v) in enumerate(samplings))

    sets = {
        "4:2:2": (geom.samplings, [planes422,
                                   tuple(p.clone() for p in planes422)]),
        "4:2:0": (s420, [seeded(s420, seed) for seed in (1, 11)]),
    }
    for label, samplings, seed in (
            ("4:4:4", ((1, 1), (1, 1), (1, 1)), 21),
            ("4:4:0", ((1, 2), (1, 1), (1, 1)), 31),
            ("4:1:1", ((4, 1), (1, 1), (1, 1)), 41),
            ("gray", ((1, 1),), 51)):
        sets[label] = (samplings, [seeded(samplings, s)
                                   for s in (seed, seed + 10)])
    batch = tuple(p.unsqueeze(0).expand(FRAMES, *p.shape).contiguous()
                  for p in planes422)
    sets[f"batch of {FRAMES}, 4:2:2"] = (geom.samplings, [batch, batch])

    def bands(planes, valid):
        """The frame as four band frames and each chroma plane's halos."""
        parts = tuple(p.reshape(4, p.shape[0] // 4, p.shape[1])
                      for p in planes)
        halos = [None]
        for p in planes[1:]:
            n = p.shape[0] // 4
            above = p[(torch.arange(4, device=device) * n - 1) % p.shape[0]]
            below = p[(torch.arange(1, 5, device=device) * n) % p.shape[0]]
            halos.append((above.contiguous(),
                          None if valid else below.contiguous(), valid))
        return parts, halos

    def e(samplings, inputs, width, height, fancy, halos=None):
        frames = inputs[0][0].shape[0] if inputs[0][0].dim() == 3 else 1

        def call(lib, i=0):
            out = torch.empty((frames, height, width), dtype=torch.int32,
                              device=device)
            params, tensors = C.epilogue_args(
                inputs[i % 2], samplings, width, height, fancy,
                halos=None if halos is None else halos[i % 2])
            _build.launch("compeg_planes_epilogue", *tensors, out, lib=lib,
                          params=params)
            return (out,)
        halo_bytes = sum(h.numel() for halo in (halos or [()])[0] if halo
                         for h in halo[:2] if h is not None)
        return call, (sum(p.numel() for p in inputs[0]) + halo_bytes
                      + frames * width * height * 4)

    calls = {}
    for label, (samplings, inputs) in sets.items():
        (h0, v0), rest = samplings[0], samplings[1:]
        # the triangle filter runs only where a factor is 2
        filtered = any(h0 == 2 * h or v0 == 2 * v for h, v in rest)
        for mode, fancy in (("nearest", False), ("fancy", True))[
                :2 if filtered else 1]:
            calls[f"E {mode}, {label}"] = e(samplings, inputs, 3840, 2160,
                                            fancy)
    for label, valid in (("halo rows", None), ("a content edge", 200)):
        cut = [bands(planes, valid) for planes in sets["4:2:0"][1]]
        calls[f"E fancy, 4:2:0 in four bands with {label}"] = e(
            s420, [c[0] for c in cut], 3840, 540, True, [c[1] for c in cut])
    return calls


def time_in_turns(fns: List[Callable], reps: int,
                  burst: int = 1) -> List[float]:
    """Median CUDA-event ms per call of each ``fn(i)``, timed in bursts of
    ``burst`` calls, the functions taking turns: forward in even rounds,
    backward in odd ones."""
    for fn in fns:
        fn(0)
        fn(1)
    times = [[] for _ in fns]
    for rep in range(reps):
        order = range(len(fns)) if rep % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            times[i].append(burst_ms(fns[i], burst))
    return [statistics.median(t) for t in times]


def differences(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) for g, w in
               zip(got, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", metavar="name=dir")
    ap.add_argument("--no-change", action="store_true",
                    help="leave the package's own csrc out")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels",
                    choices=("all", "decode", "relayout", "epilogue"),
                    default="all", help="which kernels to check and time")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--out", help="also write the result JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_csrc: needs a CUDA card")
        return 1
    trees = [t.split("=", 1) for t in args.trees]
    if not args.no_change:
        trees.append(["change", _build.CSRC])
    if len(trees) < 1:
        ap.error("no tree to time")
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    libs = []
    for name, csrc in trees:
        if args.ptxas:
            names = {"decode": ("decode.cu",), "relayout": ("relayout.cu",),
                     "epilogue": ("epilogue.cu",)}.get(
                         args.kernels, ("decode.cu", "relayout.cu",
                                        "epilogue.cu"))
            print(f"--- {name}: ptxas\n{ptxas_report(csrc, names)}",
                  flush=True)
        libs.append(_build.load(os.path.abspath(csrc)))
        LAYOUT[libs[-1]] = tree_lut_bits(csrc)
        print(f"built {name} from {csrc} (tables: LUT_BITS "
              f"{LAYOUT[libs[-1]]})", flush=True)
    names = [n for n, _ in trees]
    bad = []

    def check(label, calls):
        want = None
        for name, lib in zip(names, libs):
            got = calls(lib)
            torch.cuda.synchronize()
            if want is None:
                want = got
            elif not all(torch.equal(a, b) for a, b in zip(got, want)):
                bad.append(f"{label}: {name} differs from {names[0]} by up "
                           f"to {differences(got, want)}")

    calls4k, batch, rl, library, ep = {}, {}, {}, {}, {}
    if args.kernels in ("all", "decode"):
        vec = testdata.load()
        for i, label in enumerate(vec["labels"]):
            calls = frame_calls(vec[f"jpeg_{i}"].tobytes(), device)
            for kname, call in calls.items():
                if not kname.startswith("_"):
                    check(f"{label} {kname}", call)
        print(f"small streams: {len(vec['labels'])} compared", flush=True)
        with open(BENCH, "rb") as f:
            data4k = f.read()
        img = analyze(data4k)
        garbage = testdata.garbage_scan(data4k, img.scan_offset,
                                        len(img.scan_data), 5)
        for kname, call in frame_calls(garbage, device).items():
            if not kname.startswith("_"):
                check(f"4K garbage bits {kname}", call)
        print("4K garbage bits: compared", flush=True)
        calls4k = frame_calls(data4k, device)
        batch = calls4k.pop("_batch")(FRAMES)
    if args.kernels in ("all", "epilogue"):
        dec = Decoder(device=device, exact_idct=True)
        with open(BENCH, "rb") as f:
            pf = dec.prepare(f.read())
        k3 = F.fused_decode_planes(dec.upload(pf), pf.nseg, pf.tables, pf.op,
                                   pf.geom, exact=True)
        ep = epilogue_calls(k3, pf.geom, device)
    if args.kernels in ("all", "relayout"):
        for kname, (call, lib_call) in relayout_calls(device).items():
            rl[kname] = call
            if lib_call is not None:
                library[kname] = lib_call
    for kname, call in {**calls4k, **rl}.items():
        check(f"4K {kname}", call)
    for kname, call in batch.items():
        check(f"4K batch of {FRAMES} {kname}", call)
    for kname, (call, _) in ep.items():
        check(kname, call)

    result = {"card": card, "trees": names, "reps": args.reps,
              "burst": BURST, "ms": {}, "bound_ms": {}}

    def timed(label, call, reps, per=1, burst=BURST, extra=()):
        fns = [lambda i, lib=lib: call(lib, i) for lib in libs] + [
            e for _, e in extra]
        ms = [t / per for t in time_in_turns(fns, reps, burst)]
        result["ms"][label] = dict(zip(names + [n for n, _ in extra], ms))
        print(f"{label}: " + "  ".join(
            f"{n} {t:.4f}" for n, t in result["ms"][label].items()),
            flush=True)

    for kname, call in calls4k.items():
        timed(kname, call, args.reps)
    for kname, call in batch.items():
        timed(f"{kname} batched, per frame of {FRAMES}", call,
              max(3, args.reps // 4), per=FRAMES, burst=1)
    for kname, call in rl.items():
        extra = [("library", library[kname])] if kname in library else ()
        timed(kname, call, args.reps, extra=extra)
    for kname, (call, nbytes) in ep.items():
        per = FRAMES if "batch" in kname else 1
        result["bound_ms"][kname] = nbytes / per / HBM_BYTES_PER_S * 1e3
        if per > 1:
            timed(f"{kname}, per frame", call, max(3, args.reps // 4),
                  per=per, burst=1)
        else:
            timed(kname, call, args.reps)
        print(f"  bound {result['bound_ms'][kname]:.5f} ms "
              f"({nbytes / per:,.0f} B a frame at 3.35 TB/s)", flush=True)
    result["differences"] = bad
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result["ms"]))
    if bad:
        print(f"{len(bad)} differences, the first: " + "; ".join(bad[:5]))
        return 1
    print(f"every tree gives {names[0]}'s output bit for bit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
