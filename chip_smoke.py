"""Smoke run of compeg_tpu_torch on one CUDA card: build, check, time.

    python3 chip_smoke.py

Builds the port's CUDA kernels from compeg_tpu_torch/csrc with nvcc and its
native host library from compeg_tpu_torch/native with the host C++ compiler
(whose scan-end search must agree with the parser's numpy search on the 4K
frame), checks the kernels against their plain PyTorch versions and against
the golden decoder's answers on small streams of every supported sampling and on
the 4K benchmark frame, drives each Decoder path with the launch counters
zeroed (the default decode, the exact decode, decode_ycbcr, the fancy decode,
the planes epilogue, decode_scaled and the staged decode of fused=False,
which runs the entropy kernel K1 and torch ops) and checks that each went
through its own kernel, checks that every kernel terminates on garbage
entropy bits (the 4K frame's scan at eight seeds) and on a small stream
with random scan bytes changed, and agrees with its plain version there,
and times the kernels against their plain versions and the staged
path's stages. The planes epilogue E (compeg_tpu_torch/csrc/epilogue.cu, the
upsampling and colour pass after the planes kernel) is held to its plain
twin byte for byte, nearest and fancy, over the planes kernel's integer and
float planes of every small stream and of the 4K frame, over planes that
start off a word, over a batch of frames that differ and over band frames
with halo rows and a content edge, and each path that ends in it must
launch it (one launch a batch). Then the batch and the
stream: small batches of frames that differ, and 64 frames of 3840x2160
4:2:2 (the benchmark frame with its restart segments rotated, so every frame
is another picture) through BatchDecoder on K2, K2x and K3, one launch per
batch, and through StreamDecoder in order, against golden's stored answers
and the single-frame decode. Then the four relayout kernels: the probe tool
compeg_tpu_torch/tools/exp_relayout.py at the probes' shapes and on the 4K
decode, each kernel against its plain version, and the copy, the
interleave and the swap and crop at aligned and misaligned pointers and
ragged sizes, each on the kernel its route function names, timed beside
torch's clone(), transpose(-1, -2).contiguous() and the swap's reshape,
transpose and crop. Then the validation tool in its quick form
(compeg_tpu_torch/tools/validate.py): streams of every sampling, restart
interval and a grid of odd sizes, made by the port's encoder, in every
decode mode of the port against the port's golden decoder, and a short
soak of garbage entropy bits, scan bytes and header bytes. Then the
capture path: the 64 4K frames as one MJPEG stream, read from a file, from a
pipe that a thread fills in odd-sized chunks, by following a file that a
thread grows, and from v4l2.Camera over a fake driver
(compeg_tpu_torch/testdata/fake_v4l2.py, with an error-flagged and a
non-JPEG frame among them), each into StreamDecoder, and through the viewer
(compeg_tpu_torch/tools/viewer.py) in process at full scale and at k/8,
every frame equal to the single-frame decode of the same frame. Then the
banded decode of compeg_tpu_torch/parallel/sharding.py in a world of one
NCCL rank: 8 4K frames in 4 bands in each mode and a 1080p stream at
Ri = 7, equal to BatchDecoder and Decoder byte for byte, each launch gated
to every band's MCUs inside the image (BandedFrame.band_mcus) and the
banded kernels equal to their plain twins on every live MCU row with random
words in the gated segments. Then the
measurement tools of compeg_tpu_torch/tools in their quick forms, in
process (bench, trace_ops default and exact, bench_stream on 16 frames,
trace_sharded with one band, bench_scaling at one rank): each JSON line
must parse, bench's fields be filled, the resident decode's device busy
time lie within [0.8, 1.5] x K2's kernel time and under its event span,
the stream's idle share in [0, 1] and the banded pixels equal the
unbanded ones. Then lanes inside a restart segment: 16 restart-less
1080p 4:2:0 q95 frames from the port's encoder, one alone and all as a
zero-padded batch, where the lane index L (ops/lanes.py) must equal its
plain serial twin bit for bit, K2, K2x and K3 on its lanes must equal their
one-lane launch and their plain twins on the same lanes, and
Decoder.decode_rows must launch L, K3 and E once each and equal its decode
with one lane a segment. Any failure exits non-zero. The default
decode of the 4K frame must equal golden's byte for byte (its sha256), the
small rasters must take both the
16-byte and the word-wise store of the RGBA kernels and the 16-byte, 8-byte
and byte-wise store of the planes kernels, and a kernel's time is
a burst of launches between two CUDA events, enqueued behind a spinning
kernel so that they run back to back, divided by their number. The
last three lines are the kernels JSON, the card's nvidia-smi
name and power limit, and the result JSON. Needs one CUDA device.

It imports compeg_tpu_torch, which stands on its own host layer, golden
decoder and encoder included, and neither jax nor anything of the JAX
package compeg_tpu (checked in sys.modules at the end). The fixed streams'
answers and the 4K frame's come from compeg_tpu_torch/testdata/smoke.npz,
which tests/test_torch_smoke_vectors.py writes and checks on the CPU; the
validation tool computes its own with the port's golden decoder.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.join(ROOT, "bench_assets", "bench4k.jpg")
REPS = 20
BURST = 8  # launches between two CUDA events: the card's time, not the host's
PLAIN_REPS = 5  # the plain twins take 50-90 ms a call at 4K
SCALES = (1, 2, 4)
SOURCE = "compeg_tpu_torch/csrc/decode.cu"
RELAYOUT_SOURCE = "compeg_tpu_torch/csrc/relayout.cu"
EPILOGUE_SOURCE = "compeg_tpu_torch/csrc/epilogue.cu"
BATCH = 64  # frames of the 4K batch and stream
S420 = ((2, 2), (1, 1), (1, 1))  # 4:2:0, E's seeded 4K planes
GARBAGE_SEEDS = range(5, 13)  # frames of random entropy bits (phase e)
FUZZ = 40  # scan-byte mutations of a small stream (phase e)
# Peaks of one H100 SXM (NVIDIA's data sheet): device memory and float32
# outside the tensor cores. Integer operations are held to the same rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
LANE_BATCH = 16  # restart-less 1080p frames of the lanes' batch (phase n)


def log(*args):
    print(*args, flush=True)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def pixel_stats(got: np.ndarray, want: np.ndarray):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return int(d.max()), float((d > 1).mean())


def cuda_ms(fn, reps=REPS, warmup=2, burst=BURST):
    """Median over ``reps`` of the card's time per call of ``burst`` calls
    of ``fn`` (compeg_tpu_torch.profiling.burst_ms)."""
    from compeg_tpu_torch.profiling import burst_ms

    for _ in range(warmup):
        fn()
    return statistics.median(burst_ms(lambda i: fn(), burst)
                             for _ in range(reps))


def wall_ms(fn, reps=REPS):
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def lane_case(seed: int):
    """A restart-less 1080p 4:2:0 q95 frame of tools/exp_lanes.py's picture
    ``seed`` and its plain lane table for lanes of one MCU (``[8160, 4]``
    int32 numpy), both made on the host."""
    import torch

    from compeg_tpu_torch.ops import lanes as LN
    from compeg_tpu_torch.pipeline import Decoder
    from compeg_tpu_torch.tools import exp_lanes

    data = exp_lanes.encode((seed, None))
    pf = Decoder(device="cpu", **exp_lanes.KNOBS).prepare(data)
    rows = torch.from_numpy(pf.rows[:pf.nseg].view(np.int32))
    return data, LN.lane_index_reference(rows, pf.nseg, pf.tables, pf.geom,
                                         1).numpy()


def main() -> int:
    import torch

    # ---- (a) the card -------------------------------------------------------
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; needs a CUDA card")
        return 1
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from compeg_tpu_torch import (CompegError, analyze, encoder, mjpeg,
                                  native, parser, profiling, testdata, v4l2)
    from compeg_tpu_torch.batch import BatchDecoder, StreamDecoder
    from compeg_tpu_torch.ops import _build
    from compeg_tpu_torch.ops import color as C
    from compeg_tpu_torch.ops import entropy as E
    from compeg_tpu_torch.ops import fused as F
    from compeg_tpu_torch.ops import idct as D
    from compeg_tpu_torch.ops import int_idct as I
    from compeg_tpu_torch.ops import relayout as R
    from compeg_tpu_torch.pipeline import Decoder
    from compeg_tpu_torch.parallel import multihost as MH
    from compeg_tpu_torch.parallel import sharding as SH
    from compeg_tpu_torch.testdata.fake_v4l2 import FakeCamera
    from compeg_tpu_torch.tools import (bench as bench_tool, bench_scaling,
                                        bench_stream, exp_relayout,
                                        trace_ops, trace_sharded, validate,
                                        viewer)

    torch.backends.cuda.matmul.allow_tf32 = False  # plain IDCT in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    props = torch.cuda.get_device_properties(0)
    log(f"(a) torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"(a) nvcc: {nvcc}")
    try:
        import triton  # noqa: F401 - only reported

        log(f"(a) triton {triton.__version__} imports")
    except ImportError:
        log("(a) triton does not import")
    log(f"(a) {torch.cuda.get_device_name(0)}: {props.multi_processor_count} "
        f"SMs, {props.total_memory >> 20} MiB; nvidia-smi: {card}")

    # ---- (b) build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"(b) built {_build.library_path()} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    require(native.available(), "the native host library did not build: a "
            "run on the card must not time the Python packer")
    require(os.path.dirname(native.library_path()) == _build.BUILD_DIR,
            f"the native library is not the port's: {native.library_path()}")
    log(f"(b) packer=native: built {native.library_path()} in "
        f"{time.perf_counter() - t0:.1f} s")
    # The Python parser's scan-end search: the native one where the library
    # is built, equal to the numpy search on the 4K frame's scan.
    with open(BENCH, "rb") as f:
        scan4k = analyze(f.read())
    at = scan4k.scan_offset
    end = native.find_scan_end(scan4k.source, at)
    require(end == parser.scan_end(scan4k.source, at)
            == at + len(scan4k.scan_data),
            f"native.find_scan_end gave {end}, the numpy search "
            f"{parser.scan_end(scan4k.source, at)}")
    log(f"(b) native.find_scan_end on the 4K frame == the numpy search: "
        f"the scan ends at byte {end}")

    def rgb(img):
        return F.rgba_to_rgb(img).cpu().numpy()

    def drive(fn):
        """fn() with every launch count zeroed first; (result, counts)."""
        for k in _build.LAUNCHES:
            _build.LAUNCHES[k] = 0
        out = fn()
        torch.cuda.synchronize()
        return out, dict(_build.LAUNCHES)

    def only(counts, key, name, also=()):
        """The path launched kernel ``key``, one launch of each kernel of
        ``also`` (the planes epilogue after K3 or K1), and no other."""
        others = {k: v for k, v in counts.items()
                  if k != key and k not in also and v}
        log(f"(d) {name} launches: {counts}")
        require(counts[key] >= 1 and all(counts[k] == 1 for k in also)
                and not others,
                f"{name} did not run on its own kernels ({key}, {also}): "
                f"{counts}")
        return counts[key]

    e_checked = []  # the cases where E equalled its plain twin
    e_err = [0]

    def e_vs_plain(planes, samplings, width, height, rgb, tag, halos=None,
                   fancies=(False, True)):
        """E nearest and fancy over ``planes`` (u8 on the card) against its
        plain twin on the same planes: byte for byte. E's outputs."""
        outs = []
        for fancy in fancies:
            args = (planes, samplings, width, height, fancy, rgb, halos)
            got = C.finalize_planes(*args)
            want = C.finalize_planes_reference(*args)
            err = int((got.view(torch.uint8).int()
                       - want.view(torch.uint8).int()).abs().max())
            e_err[0] = max(e_err[0], err)
            require(err == 0 and got.shape == want.shape,
                    f"{tag}: E ({'fancy' if fancy else 'nearest'}) is {err} "
                    "from its plain twin")
            e_checked.append(f"{tag} {'fancy' if fancy else 'nearest'}")
            outs.append(got)
        return outs

    def e_spy(fn):
        """fn() with every call of E kept: (result, [(args, kwargs, out)])."""
        calls = []
        real = C.finalize_planes

        def spy(*args, **kwargs):
            out = real(*args, **kwargs)
            calls.append((args, kwargs, out))
            return out

        C.finalize_planes = spy
        try:
            return fn(), calls
        finally:
            C.finalize_planes = real

    def e_calls_vs_plain(calls, tag):
        """Each kept call of E against its plain twin on the same planes and
        halos: byte for byte."""
        for args, kwargs, out in calls:
            want = C.finalize_planes_reference(*args, **kwargs)
            require(torch.equal(out, want),
                    f"{tag}: E differs from its plain twin")
            e_checked.append(tag)
        return len(calls)

    def kernels_and_plain(data, retained=64):
        """K1 (natural order, host), K1's max |diff| from the plain K1, K2
        RGB, the plain K2 RGB, and whether K2's alpha is 0xFF."""
        dec = Decoder(retained_coefficients=retained)
        pf = dec.prepare(data)
        g = pf.geom
        rows = dec.upload(pf)
        args = (rows, pf.nseg, pf.tables, g.ri, g.total_mcus, g.du_to_comp)
        k1 = E.entropy_decode(*args)
        k1_err = int((k1.long() - E.entropy_decode_reference(*args)).abs().max())
        k1 = E.coefficients_natural_order(k1, g.total_mcus).cpu().numpy()
        k2 = F.fused_decode_rgba(rows, pf.nseg, pf.tables, pf.op, g)
        plain = F.fused_decode_rgba_reference(rows, pf.nseg, pf.tables,
                                              pf.op, g)
        alpha_ok = bool(((k2.cpu().numpy() >> 24) & 0xFF == 0xFF).all())
        return (pf, rows, k1, k1_err, rgb(k2), rgb(plain), alpha_ok)

    def exact_frame(data, retained=64):
        """(prepared frame, rows on the card) of an exact_idct decoder."""
        dec = Decoder(retained_coefficients=retained, exact_idct=True)
        pf = dec.prepare(data)
        return pf, dec.upload(pf)

    def crops(g):
        max_h = max(h for h, _ in g.samplings)
        max_v = max(v for _, v in g.samplings)
        return [(-(-g.height * v // max_v), -(-g.width * h // max_h))
                for h, v in g.samplings]

    # rasters by the store their planes took (ops/fused.plane_store_route)
    plane_rasters = {"16-byte": set(), "8-byte": set(), "byte": set()}

    def offset_planes(like, off):
        """Planes shaped like ``like`` that start ``off`` bytes past a
        16-byte boundary."""
        out = []
        for p in like:
            buf = torch.zeros(p.numel() + 32, dtype=torch.uint8,
                              device=p.device)
            at = (-buf.data_ptr()) % 16 + off
            out.append(buf[at:at + p.numel()].reshape(p.shape))
        return out

    def modes(pf, rows):
        """K2x, K3 (integer) and E fancy of one exact frame, each with its
        plain twin: (k2x, plain k2x, k3 planes, plain planes, E fancy over
        K3, E fancy over the plain planes). K3 also writes into planes off a
        16-byte boundary, with the integer and the float IDCT, and must give
        the same planes; K3 float within 1 of its plain twin. E nearest and
        fancy equal their plain twin over K3's integer and float planes and
        over the integer planes 3 bytes off a boundary."""
        g = pf.geom
        lq_float = D.idct_operators(D.qz_by_slot_array(pf.image),
                                    device=rows.device)
        args = (rows, pf.nseg, pf.tables, pf.op, g)
        k2x = F.fused_decode_rgba_exact(*args)
        k2x_plain = F.fused_decode_rgba_exact_reference(*args)
        k3 = F.fused_decode_planes(*args, exact=True)
        k3_plain = F.fused_decode_planes_reference(*args, exact=True)
        # The same planes from bases 0, 8 and 3 bytes off a 16-byte
        # boundary (the 16-byte, the 8-byte and the byte-wise store), with
        # the integer and the float IDCT.
        fargs = (rows, pf.nseg, pf.tables, lq_float, g)
        k3f = F.fused_decode_planes(*fargs)
        k3f_err = max(int((p.int() - q.int()).abs().max()) for p, q in zip(
            k3f, F.fused_decode_planes_reference(*fargs)))
        require(k3f_err <= 1, f"K3 float is {k3f_err} from its plain twin")
        for off in (0, 8, 3):
            out = offset_planes(k3, off)
            got = F.fused_decode_planes(*args, exact=True, out=out)
            if off == 3:  # E's byte-wise loads
                e_vs_plain(got, g.samplings, g.width, g.height, g.rgb,
                           f"{g.height}x{g.width} ri={g.ri}, K3 integer "
                           "planes 3 bytes off a 16-byte boundary")
            gotf = F.fused_decode_planes(*fargs, out=offset_planes(k3, off))
            require(all(torch.equal(p, q) for p, q in zip(got, k3))
                    and all(torch.equal(p, q) for p, q in zip(gotf, k3f)),
                    f"K3 into planes {off} bytes off a 16-byte boundary "
                    "differs from K3 into planes of its own")
            for p, (h, _) in zip(out, g.samplings):
                plane_rasters[F.plane_store_route(p.data_ptr(), h)].add(
                    f"{g.height}x{g.width} ri={g.ri}")
        tag = f"{g.height}x{g.width} ri={g.ri}"
        e_vs_plain(k3f, g.samplings, g.width, g.height, g.rgb,
                   f"{tag}, K3 float planes")
        fancy = [e_vs_plain(p, g.samplings, g.width, g.height, g.rgb,
                            f"{tag}, {name} planes")[1]
                 for p, name in ((k3, "K3 integer"), (k3_plain, "plain K3"))]
        return (k2x, k2x_plain, k3, k3_plain, *fancy)

    # ---- (c) small streams ---------------------------------------------------
    vec = testdata.load()
    stores = {"16-byte": [], "word-wise": []}  # rasters by the RGBA store
    staged_err = 0
    for i, label in enumerate(vec["labels"]):
        data = vec[f"jpeg_{i}"].tobytes()
        retained = int(vec["retained"][i])
        pf_i, _, k1, k1_err, k2_rgb, plain_rgb, alpha_ok = kernels_and_plain(
            data, retained)
        for k in (8,) + SCALES:
            # whole quads: MCUs and rows of a multiple of four pixels
            gk = F.scaled_geometry(pf_i.geom, k)
            mcu_w = F.composite_offsets(tuple(pf_i.geom.samplings), k)[0]
            whole = mcu_w % 4 == 0 and gk.width % 4 == 0
            stores["16-byte" if whole else "word-wise"].append(
                f"{gk.height}x{gk.width}" + ("" if k == 8 else f" (k={k})"))
        want = vec[f"coeffs_{i}"]
        require(k1.shape == want.shape and np.array_equal(k1, want)
                and not k1_err,
                f"{label}: K1 coefficients differ from golden (max |diff| "
                f"from plain K1: {k1_err})")
        vs_plain = pixel_stats(k2_rgb, plain_rgb)
        vs_golden = pixel_stats(k2_rgb, vec[f"rgb_{i}"])
        log(f"(c) {label}: K1 == golden == plain K1; K2 vs plain max "
            f"{vs_plain[0]}, vs golden max {vs_golden[0]} (tolerance: max 1)")
        require(vs_plain[0] <= 1 and vs_golden[0] <= 1 and alpha_ok,
                f"{label}: K2 outside +-1 (plain {vs_plain}, golden "
                f"{vs_golden}, alpha {alpha_ok})")
        # The integer modes: K2x and K3 exact, the fancy epilogue over K3
        # equal to the same over the plain K3 and to the JAX package's
        # staged colour functions over golden's planes.
        pf, rows = exact_frame(data, retained)
        k2x, k2x_plain, k3, k3_plain, fancy, fancy_plain = modes(pf, rows)
        require(torch.equal(k2x, k2x_plain)
                and np.array_equal(rgb(k2x), vec[f"rgbi_{i}"]),
                f"{label}: K2x differs from golden's integer RGB or the plain "
                "K2x")
        for c, ((h, w), p, q) in enumerate(zip(crops(pf.geom), k3, k3_plain)):
            require(torch.equal(p, q) and np.array_equal(
                p[:h, :w].cpu().numpy(), vec[f"plane{c}_{i}"]),
                f"{label}: K3 plane {c} differs from golden's or the plain K3")
        require(torch.equal(fancy, fancy_plain)
                and np.array_equal(rgb(fancy), vec[f"fancy_{i}"]),
                f"{label}: the fancy decode differs from its plain twin or the "
                "JAX colour functions")
        worst = 0
        for k in SCALES:
            lq_k = D.scaled_operators(D.qz_by_slot_array(pf.image), k,
                                      retained, rows.device)
            args = (rows, pf.nseg, pf.tables, lq_k, pf.geom, k)
            got = rgb(F.fused_decode_scaled(*args))
            want = vec[f"rgbs{k}_{i}"]
            require(got.shape == want.shape, f"{label}: K2s k={k} shape "
                    f"{got.shape}, golden {want.shape}")
            worst = max(worst, pixel_stats(got, want)[0], pixel_stats(
                got, rgb(F.fused_decode_scaled_reference(*args)))[0])
        require(worst <= 1, f"{label}: K2s outside +-1 ({worst})")
        # The staged tier, Decoder(fused=False): K1 and torch ops. Exact and
        # fancy + exact against golden's stored answers, the float decodes
        # against golden and the fused decodes.
        knobs = {"retained_coefficients": retained, "fused": False}
        st_float = Decoder(**knobs).decode(data)
        st_exact = Decoder(exact_idct=True, **knobs).decode(data)
        st_fancy = Decoder(fancy_upsampling=True, **knobs).decode(data)
        st_fancy_x = Decoder(fancy_upsampling=True, exact_idct=True,
                             **knobs).decode(data)
        fused_fancy = Decoder(retained_coefficients=retained,
                              fancy_upsampling=True).decode(data)
        st_err = (pixel_stats(st_float, vec[f"rgb_{i}"])[0],
                  pixel_stats(st_float, k2_rgb)[0],
                  pixel_stats(st_fancy, fused_fancy)[0])
        require(np.array_equal(st_exact, vec[f"rgbi_{i}"])
                and np.array_equal(st_fancy_x, vec[f"fancy_{i}"])
                and np.array_equal(st_fancy_x, rgb(fancy)),
                f"{label}: the staged exact or fancy + exact decode differs "
                "from golden's stored answer")
        require(st_err[0] <= 1 and st_err[1] <= 1 and st_err[2] <= 2,
                f"{label}: the staged float decode is {st_err} from golden, "
                "the fused decode and the fused fancy decode")
        staged_err = max(staged_err, st_err[0])
        log(f"(c) {label}: staged (fused=False) exact == golden integer RGB, "
            f"fancy + exact == the JAX colour functions == fancy over K3; "
            f"float max {st_err[0]} from golden, {st_err[1]} from K2, fancy "
            f"max {st_err[2]} from the fused fancy decode (tolerance: exact; "
            f"max 1; fancy max 2, one sample step through the colour matrix)")
        log(f"(c) {label}: K2x == golden integer RGB == plain K2x; K3 == "
            f"golden integer planes == plain K3; fancy == plain == JAX "
            f"colour functions; K2s k=1,2,4 max {worst} from golden and plain "
            f"(tolerance: exact; K2s max 1)")

    for kind, seen in stores.items():
        log(f"(c) rasters written with the {kind} RGBA store: "
            f"{sorted(set(seen))}")
    require("17x37" in stores["word-wise"] and any(
        "(k=" in r for r in stores["word-wise"]) and "24x40" in
        stores["16-byte"], f"the small streams miss a store: {stores}")

    for kind, seen in plane_rasters.items():
        log(f"(c) rasters whose planes took the {kind} store: {sorted(seen)}")
    for raster in ("17x37 ri=1", "18x38 ri=1", "40x72 ri=3", "16x48 ri=5"):
        require(all(raster in plane_rasters[k] for k in ("8-byte", "byte"))
                and (raster in plane_rasters["16-byte"]),
                f"{raster} did not take every plane store: {plane_rasters}")

    # The ZRL stream under the compat semantics, and random int16-range
    # blocks whose integer IDCT wraps int32.
    zrl = vec["zrl_jpeg"].tobytes()
    for r in (64, 32):
        got = Decoder(zrl_compat=True, exact_idct=True,
                      retained_coefficients=r).decode(zrl)
        require(np.array_equal(got, vec[f"zrl_rgbi_{r}"]),
                f"ZRL stream, retained {r}: compat K2x differs from golden")
    pf, rows = exact_frame(vec["wrap_jpeg"].tobytes())
    k2x, k2x_plain, k3, k3_plain, _, _ = modes(pf, rows)
    require(torch.equal(k2x, k2x_plain)
            and np.array_equal(rgb(k2x), vec["wrap_rgbi"])
            and all(torch.equal(p, q) for p, q in zip(k3, k3_plain)),
            "wrap blocks: K2x or K3 differs from golden or its plain twin")
    log("(c) ZRL stream: zrl_compat + K2x == golden compat (retained 64, 32); "
        "wrap blocks: K2x == golden == plain K2x, K3 == plain K3 (exact)")

    # ---- (d) the 4K frame ----------------------------------------------------
    # Golden's answers for it: digests of its coefficients, float and integer
    # RGB, integer planes and fancy RGB, and its float and scaled RGB on
    # three MCU rows. The full frame is held to the plain twins.
    with open(BENCH, "rb") as f:
        data4k = f.read()
    require(hashlib.sha256(data4k).hexdigest()
            == str(vec["bench4k_jpeg_sha256"]),
            f"{BENCH} is not the frame of {testdata.PATH}")
    pf, rows4k, k1, k1_err, k2_rgb, plain4k, alpha_ok = kernels_and_plain(
        data4k)
    require(testdata.digest(k1) == str(vec["bench4k_coeffs_sha256"])
            and not k1_err, f"4K: K1 coefficients differ from golden's (max "
            f"|diff| from plain K1: {k1_err})")
    rows = vec["bench4k_rows"]
    golden_rows = vec["bench4k_rgb_rows"]
    vs_plain = pixel_stats(k2_rgb, plain4k)
    log(f"(d) 4K: {pf.nseg} segments of {pf.rows.shape[1]} words; K1 == "
        f"golden coefficients (sha256) == plain K1; K2 vs plain max "
        f"{vs_plain[0]}, frac>1 {vs_plain[1]:.3g} (tolerance: K1 exact; "
        f"max 2, frac>1 <= 1e-5)")
    dec = Decoder()
    main_rgb, counts = drive(lambda: dec.decode(data4k))  # the main path
    launches = {"fused": only(counts, "fused", "Decoder().decode")}
    require(main_rgb.shape == plain4k.shape,
            f"4K: decode() gave {main_rgb.shape}, not {plain4k.shape}")
    checks = {
        "K2 vs plain K2": vs_plain,
        "decode() vs plain K2": pixel_stats(main_rgb, plain4k),
        "decode() vs golden rows": pixel_stats(main_rgb[rows], golden_rows),
        "plain K2 vs golden rows": pixel_stats(plain4k[rows], golden_rows),
    }
    for name, (mx, frac) in checks.items():
        log(f"(d) {name}: max {mx}, frac>1 {frac:.3g}")
    require(alpha_ok and all(mx <= 2 and frac <= 1e-5
                             for mx, frac in checks.values()),
            "4K decode outside the PARITY.md envelope")
    # K2's sum keeps the plain sum's terms and their order, which on this
    # frame gives golden's bytes: held to the digest, not only the envelope.
    require(testdata.digest(main_rgb) == str(vec["bench4k_rgb_sha256"]),
            "4K: decode() is not golden.decode_rgb byte for byte (sha256)")
    log("(d) decode() bit-identical to golden.decode_rgb (sha256)")

    # The integer kernels against their plain twins on every pixel.
    pfx, rowsx = exact_frame(data4k)
    k2x, k2x_plain, k3, k3_plain, fancy, fancy_plain = modes(pfx, rowsx)
    k2x_err = int((k2x - k2x_plain).abs().max())
    k3_err = max(int((p.int() - q.int()).abs().max())
                 for p, q in zip(k3, k3_plain))
    require(k2x_err == 0 and k3_err == 0 and torch.equal(fancy, fancy_plain),
            f"4K: K2x ({k2x_err}) or K3 ({k3_err}) or the fancy epilogue "
            "differs from its plain twin")
    log("(d) 4K: K2x == plain K2x, K3 (integer) == plain K3, E nearest and "
        "fancy over K3's integer and float planes == its plain twin, on every "
        "pixel")
    # E over seeded 4K 4:2:0 planes (the 4K frame is 4:2:2, so its planes
    # never take the vertical filter), and over small planes of samplings
    # beyond the common ones (E reads each component's factors from its
    # parameters), against its plain twin.
    gen = torch.Generator(device="cuda").manual_seed(420)
    planes420 = [torch.randint(0, 256, shape, generator=gen,
                               dtype=torch.uint8, device="cuda")
                 for shape in ((2160, 3840), (1080, 1920), (1080, 1920))]
    e_vs_plain(planes420, S420, 3840, 2160, False, "4K 4:2:0 seeded planes")
    for samplings in (((1, 1), (2, 1), (1, 2)), ((1, 2), (2, 2), (1, 1)),
                      ((2, 2), (1, 1), (2, 1)), ((4, 2), (1, 1), (1, 1))):
        max_h = max(h for h, _ in samplings)
        max_v = max(v for _, v in samplings)
        odd = [torch.randint(0, 256, (-(-37 // (8 * max_v)) * 8 * v,
                                      -(-45 // (8 * max_h)) * 8 * h),
                             generator=gen, dtype=torch.uint8, device="cuda")
               for h, v in samplings]
        e_vs_plain(odd, samplings, 45, 37, False,
                   f"37x45 sampled {samplings}")
    log("(d) E nearest and fancy == its plain twin over seeded 4K 4:2:0 "
        "planes and over 37x45 planes of four samplings whose factors it "
        "reads from its parameters")

    exact_dec = Decoder(exact_idct=True)
    got, counts = drive(lambda: exact_dec.decode(data4k))
    launches["fused_exact"] = only(counts, "fused_exact",
                                   "Decoder(exact_idct=True).decode")
    require(testdata.digest(got) == str(vec["bench4k_rgbi_sha256"]),
            "4K: the exact decode is not golden's integer RGB (sha256)")
    log("(d) Decoder(exact_idct=True).decode(bench4k) bit-identical to "
        "golden.decode_rgb(idct='int') (sha256)")

    planes, counts = drive(lambda: exact_dec.decode_ycbcr(data4k))
    only(counts, "planes", "Decoder(exact_idct=True).decode_ycbcr")
    for c, p in enumerate(planes):
        require(testdata.digest(p) == str(vec[f"bench4k_plane{c}_sha256"]),
                f"4K: decode_ycbcr plane {c} is not golden's (sha256)")
    log(f"(d) decode_ycbcr(bench4k): planes {[p.shape for p in planes]} "
        "equal golden's integer planes (sha256)")

    fancy_dec = Decoder(fancy_upsampling=True, exact_idct=True)
    got, counts = drive(lambda: fancy_dec.decode(data4k))
    launches["planes"] = only(counts, "planes",
                              "Decoder(fancy_upsampling, exact_idct).decode",
                              also=("epilogue",))
    launches["epilogue"] = counts["epilogue"]
    require(testdata.digest(got) == str(vec["bench4k_fancy_sha256"]),
            "4K: the fancy + exact decode is not the stored digest")
    log("(d) fancy + exact decode(bench4k) equals the JAX colour functions "
        "over golden's integer planes (sha256)")

    pe_dec = Decoder(planes_epilogue=True)
    got, counts = drive(lambda: pe_dec.decode(data4k))
    only(counts, "planes", "Decoder(planes_epilogue=True).decode",
         also=("epilogue",))
    launches["epilogue"] += counts["epilogue"]
    require(np.array_equal(got, main_rgb),
            "4K: planes_epilogue=True differs from the composite")
    log("(d) Decoder(planes_epilogue=True).decode(bench4k) == Decoder().decode")

    thumbs, counts = drive(lambda: [dec.decode_scaled(data4k, k)
                                    for k in SCALES])
    launches["scaled"] = only(counts, "scaled", "decode_scaled(k=1,2,4)")
    scaled_err = 0
    for k, got in zip(SCALES, thumbs):
        g_rows = vec[f"bench4k_rgbs{k}_rows"]
        lq_k = D.scaled_operators(D.qz_by_slot_array(pf.image), k,
                                  device=rows4k.device)
        args = (rows4k, pf.nseg, pf.tables, lq_k, pf.geom, k)
        k2s = rgb(F.fused_decode_scaled(*args))
        vs_rows = pixel_stats(got[vec[f"bench4k_rows{k}"]], g_rows)
        vs_plain_k = pixel_stats(k2s, rgb(F.fused_decode_scaled_reference(
            *args)))
        require(np.array_equal(k2s, got), f"4K: K2s k={k} differs from "
                "decode_scaled")
        log(f"(d) decode_scaled(bench4k, {k}) {got.shape}: vs golden rows "
            f"max {vs_rows[0]}, K2s vs plain K2s max {vs_plain_k[0]} "
            f"(tolerance: max 1)")
        require(got.shape == (2160 * k // 8, 3840 * k // 8, 3)
                and vs_rows[0] <= 1 and vs_plain_k[0] <= 1,
                f"4K: scaled k={k} outside +-1")
        scaled_err = max(scaled_err, vs_plain_k[0])

    # The staged tier at 4K: K1 once and no fused kernel; the exact decode
    # golden's integer RGB, the float decode inside the envelope.
    staged_x = Decoder(fused=False, exact_idct=True)
    got, counts = drive(lambda: staged_x.decode(data4k))
    launches["entropy"] = only(counts, "entropy",
                               "Decoder(fused=False, exact_idct=True).decode",
                               also=("epilogue",))
    launches["epilogue"] += counts["epilogue"]
    require(launches["entropy"] == 1, f"the staged decode launched K1 "
            f"{launches['entropy']} times")
    require(testdata.digest(got) == str(vec["bench4k_rgbi_sha256"]),
            "4K: the staged exact decode is not golden's integer RGB (sha256)")
    staged_dec = Decoder(fused=False)
    got, counts = drive(lambda: staged_dec.decode(data4k))
    only(counts, "entropy", "Decoder(fused=False).decode", also=("epilogue",))
    launches["epilogue"] += counts["epilogue"]
    st4k = {"staged decode() vs golden rows": pixel_stats(got[rows],
                                                          golden_rows),
            "staged decode() vs decode()": pixel_stats(got, main_rgb)}
    for name, (mx, frac) in st4k.items():
        log(f"(d) {name}: max {mx}, frac>1 {frac:.3g}")
    require(all(mx <= 2 and frac <= 1e-5 for mx, frac in st4k.values()),
            "4K: the staged float decode is outside the PARITY.md envelope")
    staged_err = max(staged_err, st4k["staged decode() vs golden rows"][0])
    log("(d) Decoder(fused=False, exact_idct=True).decode(bench4k) "
        "bit-identical to golden.decode_rgb(idct='int') (sha256): one launch "
        "of K1 and one of E, no fused kernel; the float staged decode inside "
        "the envelope")

    # ---- (e) garbage bits and mutated scans ------------------------------
    # Every kernel must return on any bits (a thread that never ends hangs the
    # launch) and agree with its plain twin: K1, K2x and K3 bit for bit, K2
    # and K2s in their shapes, K2 and K2s within 1 on the small stream (their
    # float sums run in another order than the plain einsum's).
    def against_plain(data):
        """(prepared exact frame, its rows, {kernel: (output, plain)})."""
        gpf, grows = exact_frame(data)
        g = gpf.geom
        qsl = D.qz_by_slot_array(gpf.image)
        lq8 = D.idct_operators(qsl, device=grows.device)
        base = (grows, gpf.nseg, gpf.tables)
        coef = (g.ri, g.total_mcus, g.du_to_comp)
        out = {
            "K1": (E.entropy_decode(*base, *coef),
                   E.entropy_decode_reference(*base, *coef)),
            "K2x": (F.fused_decode_rgba_exact(*base, gpf.op, g),
                    F.fused_decode_rgba_exact_reference(*base, gpf.op, g)),
            "K3": (F.fused_decode_planes(*base, gpf.op, g, exact=True),
                   F.fused_decode_planes_reference(*base, gpf.op, g,
                                                   exact=True)),
            "K2": (F.fused_decode_rgba(*base, lq8, g),
                   F.fused_decode_rgba_reference(*base, lq8, g)),
        }
        for k in SCALES:
            lq_k = D.scaled_operators(qsl, k, device=grows.device)
            out[f"K2s k={k}"] = (F.fused_decode_scaled(*base, lq_k, g, k),
                                 F.fused_decode_scaled_reference(*base, lq_k,
                                                                 g, k))
        torch.cuda.synchronize()
        return gpf, grows, out

    def float_errors(out, g):
        """max |diff| of K2 and K2s from their plain twins, their shapes
        checked."""
        errs = {}
        for name, (got, want) in out.items():
            if name.startswith("K2") and name != "K2x":
                k = int(name[-1]) if "=" in name else 8
                gk = F.scaled_geometry(g, k)
                require(tuple(got.shape) == (gk.height, gk.width),
                        f"{name} gave {tuple(got.shape)}")
                errs[name] = pixel_stats(rgb(got), rgb(want))[0]
        return errs

    def exact_ok(out):
        return (torch.equal(*out["K1"]) and torch.equal(*out["K2x"])
                and all(torch.equal(p, q) for p, q in zip(*out["K3"])))

    img = pf.image
    t0 = time.perf_counter()
    garbage_err = {}
    for seed in GARBAGE_SEEDS:
        garbage = testdata.garbage_scan(data4k, img.scan_offset,
                                        len(img.scan_data), seed)
        gpf_s, grows_s, out = against_plain(garbage)
        require(exact_ok(out), f"garbage bits (seed {seed}): K1, K2x or K3 "
                "differs from its plain version")
        errs = float_errors(out, gpf_s.geom)
        garbage_err = {k: max(v, garbage_err.get(k, 0))
                       for k, v in errs.items()}
        if seed == GARBAGE_SEEDS[0]:  # phase (h) runs it batched
            gpf, grows, gk2x = gpf_s, grows_s, out["K2x"][0]
        del out
    g = gpf.geom
    log(f"(e) garbage bits, {len(GARBAGE_SEEDS)} seeds: K1, K2, K2x, K3, "
        f"K2s returned ({time.perf_counter() - t0:.3f} s with the plain "
        f"twins); K1 == plain K1, K2x == plain K2x, K3 == plain K3 on "
        f"every seed; K2 and K2s in their shapes, max |diff| from plain "
        f"{garbage_err} (reported)")

    # Scan-byte mutations of a small stream with short final intervals
    # (tests/test_robustness.py's fuzz, on the card): a mutation the host
    # refuses (a marker hit, the segment count changed) is counted.
    fuzz_label = "422 ri=5 16x48"
    fuzz_data = vec[f"jpeg_{list(vec['labels']).index(fuzz_label)}"].tobytes()
    fimg = exact_frame(fuzz_data)[0].image
    foff, flen = fimg.scan_offset, len(fimg.scan_data)
    rng = np.random.default_rng(9)
    decoded, refused, fuzz_err = 0, 0, 0
    for _ in range(FUZZ):
        scan = bytearray(fuzz_data[foff:foff + flen])
        for _ in range(int(rng.integers(1, 6))):
            scan[int(rng.integers(0, flen))] = int(rng.integers(0, 256))
        bad = fuzz_data[:foff] + bytes(scan) + fuzz_data[foff + flen:]
        try:
            fpf, _, out = against_plain(bad)
        except CompegError:
            refused += 1
            continue
        decoded += 1
        require(exact_ok(out), "scan fuzz: K1, K2x or K3 differs from its "
                "plain version")
        errs = float_errors(out, fpf.geom)
        fuzz_err = max(fuzz_err, *errs.values())
        require(fuzz_err <= 1, f"scan fuzz: K2 or K2s outside +-1 of plain "
                f"({errs})")
    require(decoded >= FUZZ // 2, f"scan fuzz: only {decoded} of {FUZZ} "
            "mutations decoded")
    log(f"(e) scan fuzz on {fuzz_label}: {decoded} of {FUZZ} mutated "
        f"streams decoded ({refused} refused by the host); K1, K2x, K3 == "
        f"their plain twins, K2 and K2s max |diff| {fuzz_err} from plain "
        f"(tolerance: exact; max 1)")

    # ---- (f) times -----------------------------------------------------------
    g = pf.geom
    qz = pfx.op
    lq = {k: D.scaled_operators(D.qz_by_slot_array(pf.image), k,
                                device=rows4k.device) for k in SCALES}
    base = (rows4k, pf.nseg, pf.tables)
    ms = {
        "K2": cuda_ms(lambda: F.fused_decode_rgba(*base, pf.op, g)),
        "K1": cuda_ms(lambda: E.entropy_decode(*base, g.ri, g.total_mcus,
                                               g.du_to_comp)),
        "K2x": cuda_ms(lambda: F.fused_decode_rgba_exact(*base, qz, g)),
        "K3 int": cuda_ms(lambda: F.fused_decode_planes(*base, qz, g,
                                                        exact=True)),
        "K3 float": cuda_ms(lambda: F.fused_decode_planes(*base, pf.op, g)),
    }
    for k in SCALES:
        ms[f"K2s k={k}"] = cuda_ms(
            lambda k=k: F.fused_decode_scaled(*base, lq[k], g, k))
    # E over K3's integer 4K planes and over the seeded 4K 4:2:0 planes,
    # nearest and fancy.
    for name, fancy in (("E nearest", False), ("E fancy", True)):
        ms[name] = cuda_ms(lambda fancy=fancy: C.finalize_planes(
            k3, g.samplings, g.width, g.height, fancy=fancy, rgb=g.rgb))
        ms[f"{name} 4:2:0"] = cuda_ms(lambda fancy=fancy: C.finalize_planes(
            planes420, S420, 3840, 2160, fancy=fancy))
    plain = {
        "K2": cuda_ms(lambda: F.fused_decode_rgba_reference(*base, pf.op, g),
                      reps=PLAIN_REPS, warmup=1, burst=1),
        "K1": cuda_ms(lambda: E.entropy_decode_reference(
            *base, g.ri, g.total_mcus, g.du_to_comp), reps=PLAIN_REPS,
            warmup=1, burst=1),
        "K2x": cuda_ms(lambda: F.fused_decode_rgba_exact_reference(
            *base, qz, g), reps=PLAIN_REPS, warmup=1, burst=1),
        "K3 int": cuda_ms(lambda: F.fused_decode_planes_reference(
            *base, qz, g, exact=True), reps=PLAIN_REPS, warmup=1, burst=1),
        "K3 float": cuda_ms(lambda: F.fused_decode_planes_reference(
            *base, pf.op, g), reps=PLAIN_REPS, warmup=1, burst=1),
    }
    for k in SCALES:
        plain[f"K2s k={k}"] = cuda_ms(
            lambda k=k: F.fused_decode_scaled_reference(*base, lq[k], g, k),
            reps=PLAIN_REPS, warmup=1, burst=1)
    for name, fancy in (("E nearest", False), ("E fancy", True)):
        plain[name] = cuda_ms(lambda fancy=fancy: C.finalize_planes_reference(
            k3, g.samplings, g.width, g.height, fancy=fancy, rgb=g.rgb),
            reps=PLAIN_REPS, warmup=1, burst=1)
        plain[f"{name} 4:2:0"] = cuda_ms(
            lambda fancy=fancy: C.finalize_planes_reference(
                planes420, S420, 3840, 2160, fancy=fancy),
            reps=PLAIN_REPS, warmup=1, burst=1)
    for name in ms:
        log(f"(f) {name} at 4K: {ms[name]:.4f} ms, plain twin "
            f"{plain[name]:.4f} ms (medians of {REPS} CUDA-event timings "
            f"of {BURST} launches each, and of {PLAIN_REPS} single calls) on "
            f"{card}")
    # The staged path's stages after K1 and before E: CUDA events around
    # one call of each, which is several torch kernels and the host's gaps
    # between them.
    coeffs4k = E.entropy_decode(*base, g.ri, g.total_mcus, g.du_to_comp)
    pix4k = D.idct_pixels(coeffs4k, pf.op)
    stage_ms = {
        "idct_pixels (float, torch)": cuda_ms(
            lambda: D.idct_pixels(coeffs4k, pf.op), burst=1),
        "idct_pixels_int (torch)": cuda_ms(
            lambda: I.idct_pixels_int(coeffs4k, qz), reps=PLAIN_REPS,
            burst=1),
        "component_planes": cuda_ms(
            lambda: C.component_planes(pix4k, g), burst=1),
    }
    rgba4k = C.finalize_planes(k3, g.samplings, g.width, g.height, rgb=g.rgb)
    stage_ms["rgba_to_rgb"] = cuda_ms(lambda: F.rgba_to_rgb(rgba4k), burst=1)
    del coeffs4k, pix4k, rgba4k
    log(f"(f) the staged path after K1 ({ms['K1']:.4f} ms) at 4K: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in stage_ms.items())
        + f", E nearest {ms['E nearest']:.4f} ms (medians of {REPS} single "
        f"calls, CUDA events; the integer IDCT {PLAIN_REPS}) on {card}")
    prep_ms = wall_ms(lambda: dec.prepare(data4k))
    h2d_ms = wall_ms(lambda: dec.upload(pf))
    out4k = F.fused_decode_rgba(*base, pf.op, g)
    d2h_ms = wall_ms(lambda: F.rgba_to_rgb(out4k).cpu())
    walls = {
        "decode()": wall_ms(lambda: dec.decode(data4k)),
        "exact decode()": wall_ms(lambda: exact_dec.decode(data4k)),
        "exact decode_ycbcr()": wall_ms(lambda: exact_dec.decode_ycbcr(data4k)),
        "fancy exact decode()": wall_ms(lambda: fancy_dec.decode(data4k)),
        "planes_epilogue decode()": wall_ms(lambda: pe_dec.decode(data4k)),
        "staged decode() (fused=False)": wall_ms(
            lambda: staged_dec.decode(data4k)),
        "staged exact decode() (fused=False)": wall_ms(
            lambda: staged_x.decode(data4k)),
    }
    for k in SCALES:
        walls[f"decode_scaled(k={k})"] = wall_ms(
            lambda k=k: dec.decode_scaled(data4k, k))
    log(f"(f) prepare {prep_ms:.3f} ms, H2D {h2d_ms:.3f} ms "
        f"({pf.rows[:pf.nseg].nbytes} B), RGB readback {d2h_ms:.3f} ms "
        f"(median of {REPS}) on {card}; packer {pf.packer}")
    for name, v in walls.items():
        log(f"(f) {name} {v:.3f} ms wall (median of {REPS}) on {card}")

    # ---- (g) small batches of frames that differ ----------------------------
    # Segment counts that are no multiple of the kernels' 32 segments per
    # block, short last intervals, 4:2:0 under the fancy filter: every frame
    # of a batch against golden's answer for that frame, one launch a batch.
    # (mode, its kernels: one launch of each a batch, the golden answer)
    modes_b = {
        "K2": ({}, ("fused",), "rgb"),
        "K2x": ({"exact_idct": True}, ("fused_exact",), "rgbi"),
        "K3": ({"exact_idct": True, "fancy_upsampling": True},
               ("planes", "epilogue"), "fancy"),
    }

    def one_launch_each(counts, keys):
        return (all(counts[k] == 1 for k in keys)
                and sum(counts.values()) == len(keys))

    nframes = sum(1 for k in vec if k.startswith("batch0_jpeg_"))
    batch_err = {name: 0 for name in modes_b}
    for c, label in enumerate(vec["batch_labels"]):
        frames = [vec[f"batch{c}_jpeg_{f}"].tobytes() for f in range(nframes)]
        for name, (knobs, keys, answer) in modes_b.items():
            bdec = BatchDecoder(**knobs)
            got, counts = drive(lambda: bdec.decode(frames))
            require(one_launch_each(counts, keys),
                    f"batch {label}: {name} took {counts}, not one launch "
                    f"of each of {keys}")
            for f in range(nframes):
                err = pixel_stats(got[f], vec[f"batch{c}_{answer}_{f}"])[0]
                batch_err[name] = max(batch_err[name], err)
                require(err <= (1 if name == "K2" else 0),
                        f"batch {label}: {name} frame {f} is {err} from "
                        "golden's answer")
        # E on the batch's K3 planes, the frames in one launch.
        bdec = BatchDecoder(**modes_b["K3"][0])
        bpfs = bdec.prepare_batch(frames)
        bg = bpfs[0].geom
        e_vs_plain(F.fused_decode_planes(bdec.upload(), bpfs[0].nseg,
                                         bpfs[0].tables, bpfs[0].op, bg,
                                         exact=True),
                   bg.samplings, bg.width, bg.height, bg.rgb,
                   f"batch of {nframes}, {label}")
        log(f"(g) batch of {nframes}, {label}: K2 within 1 of golden, K2x == "
            f"golden integer RGB, fancy over K3 == the JAX colour functions, "
            f"frame by frame, one launch of each kernel; E nearest and fancy "
            f"over the batch's planes == its plain twin")

    # The staged batch: every frame its own single-frame staged decode and
    # golden's integer RGB, a K1 launch per frame and no fused kernel.
    staged_batch_launches = {"entropy": 0, "epilogue": 0}
    for c, label in enumerate(vec["batch_labels"]):
        frames = [vec[f"batch{c}_jpeg_{f}"].tobytes() for f in range(nframes)]
        sbdec = BatchDecoder(fused=False, exact_idct=True)
        got, counts = drive(lambda: sbdec.decode(frames))
        require(counts["entropy"] == counts["epilogue"] == nframes
                and sum(counts.values()) == 2 * nframes,
                f"staged batch {label}: took {counts}, not a K1 and an E "
                "launch a frame")
        for k in staged_batch_launches:
            staged_batch_launches[k] += counts[k]
        single = Decoder(fused=False, exact_idct=True)
        for f in range(nframes):
            require(np.array_equal(got[f], single.decode(frames[f]))
                    and np.array_equal(got[f], vec[f"batch{c}_rgbi_{f}"]),
                    f"staged batch {label}: frame {f} is not its "
                    "single-frame decode or golden's integer RGB")
    log(f"(g) BatchDecoder(fused=False, exact_idct=True) on "
        f"{len(vec['batch_labels'])} batches of {nframes}: every frame == "
        f"its single-frame staged decode == golden integer RGB, "
        f"{nframes} launches of K1 and of E a batch")

    # ---- (h) 64 frames of 4K: BatchDecoder and StreamDecoder ------------------
    # Frame i is the benchmark frame with its restart segments rotated by i
    # MCU rows (240 segments): golden's picture rolled up by 8 * i pixel rows.
    t0 = time.perf_counter()
    frames4k = [testdata.rotate_restart_segments(
        data4k, img.scan_offset, len(img.scan_data), img.width_mcus * i)
        for i in range(BATCH)]
    require(len(set(frames4k)) == BATCH, "the 4K frames do not all differ")
    log(f"(h) {BATCH} rotated 4K frames in {time.perf_counter() - t0:.2f} s")
    samples = [int(i) for i in vec["bench4k_roll_samples"] if i < BATCH]
    singles = {"K2": main_rgb, "K2x": exact_dec.decode(data4k),
               "K3": fancy_dec.decode(data4k)}
    batch_launches = {}
    batch_wall = {}
    for name, (knobs, keys, answer) in modes_b.items():
        bdec = BatchDecoder(**knobs)
        t0 = time.perf_counter()
        got, counts = drive(lambda: bdec.decode(frames4k))
        batch_wall[name] = (time.perf_counter() - t0) * 1e3 / BATCH
        require(one_launch_each(counts, keys),
                f"4K batch: {name} took {counts}, not one launch of each of "
                f"{keys}")
        for k in keys:
            batch_launches[k] = counts[k]
        require(got.shape == (BATCH, 2160, 3840, 3), f"4K batch: {got.shape}")
        for i in range(BATCH):
            require(np.array_equal(got[i], np.roll(singles[name], -8 * i, 0)),
                    f"4K batch: {name} frame {i} is not the single-frame "
                    f"decode rolled by {8 * i} rows")
        if name == "K2x":
            for i in range(BATCH):
                require(testdata.digest(got[i])
                        == str(vec["bench4k_rgbi_roll_sha256"][i]),
                        f"4K batch: K2x frame {i} is not golden's (sha256)")
        else:
            same = [testdata.digest(got[i])
                    == str(vec[f"bench4k_{answer}_roll_sha256"][n])
                    for n, i in enumerate(samples)]
            # The float default is held to golden by tolerance (phase d);
            # its bit-identity is reported, the fancy one required.
            require(name == "K2" or all(same),
                    f"4K batch: fancy frames {samples} are not the stored "
                    f"digests: {same}")
            log(f"(h) {name} batch frames {samples} bit-identical to golden "
                f"rolled (sha256): {same}")
        log(f"(h) BatchDecoder({knobs}).decode of {BATCH} 4K frames: one "
            f"launch of {keys}; every frame == the single-frame decode rolled "
            f"by its 8 * i rows" + ("; every frame == golden's integer RGB "
                                    "rolled (sha256)" if name == "K2x" else ""))
        del got

    sdec = StreamDecoder(depth=2)
    list(sdec.decode_iter_rgb(frames4k[:8]))  # pinned buffers, worker threads
    t0 = time.perf_counter()
    streamed, counts = drive(lambda: list(sdec.decode_iter_rgb(frames4k)))
    stream_ms = (time.perf_counter() - t0) * 1e3 / BATCH
    stream_launches = only(counts, "fused", "StreamDecoder.decode_iter_rgb")
    require(stream_launches == BATCH and len(streamed) == BATCH,
            f"stream: {stream_launches} launches, {len(streamed)} frames")
    for i, got in enumerate(streamed):
        require(np.array_equal(got, np.roll(main_rgb, -8 * i, 0)),
                f"stream: frame {i} is not its own decode, in order")
    log(f"(h) StreamDecoder(depth=2, prepare_threads="
        f"{sdec.prepare_threads}).decode_iter_rgb: {BATCH} frames in order, "
        f"each == the single-frame decode rolled by its 8 * i rows")
    del streamed

    # Garbage bits through a batched launch: every frame of the batch equals
    # the single-frame K2x on the same bits (itself equal to its plain twin).
    require(grows.shape == rowsx.shape, "the garbage frame's rows have "
            f"another shape: {grows.shape}, {rowsx.shape}")
    gb = torch.stack([grows, grows, grows, rowsx])
    gout = F.fused_decode_rgba_exact(gb, gpf.nseg, gpf.tables, gpf.op, g)
    torch.cuda.synchronize()
    require(all(torch.equal(gout[i], gk2x) for i in range(3))
            and torch.equal(gout[3], k2x),
            "garbage bits: the batched K2x differs from the single-frame one")
    log("(h) garbage bits through a batched K2x launch: frames == the "
        "single-frame K2x, the clean frame beside them == its own")

    # Times: the batched kernels per frame beside the single-frame ones, and
    # the wall per frame of batch, stream and one-shot decodes.
    bd_t = BatchDecoder()
    pfs = bd_t.prepare_batch(frames4k)
    rows_b = bd_t._staging.tensor.to("cuda")
    batch_ms = {
        "K2": cuda_ms(lambda: F.fused_decode_rgba(
            rows_b, pf.nseg, pf.tables, pf.op, g), reps=5, burst=1) / BATCH,
        "K2x": cuda_ms(lambda: F.fused_decode_rgba_exact(
            rows_b, pf.nseg, pf.tables, qz, g), reps=5, burst=1) / BATCH,
        "K3 int": cuda_ms(lambda: F.fused_decode_planes(
            rows_b, pf.nseg, pf.tables, qz, g, exact=True), reps=5,
            burst=1) / BATCH,
    }
    planes_b = F.fused_decode_planes(rows_b, pf.nseg, pf.tables, qz, g,
                                     exact=True)
    for name, fancy in (("E nearest", False), ("E fancy", True)):
        batch_ms[name] = cuda_ms(lambda fancy=fancy: C.finalize_planes(
            planes_b, g.samplings, g.width, g.height, fancy=fancy,
            rgb=g.rgb), reps=5, burst=1) / BATCH
    del planes_b
    up_ms = wall_ms(lambda: bd_t._staging.tensor.to("cuda",
                                                    non_blocking=True),
                    reps=5) / BATCH
    del rows_b
    for name, v in batch_ms.items():
        log(f"(h) batched {name}, B = {BATCH}: {v:.4f} ms per frame "
            f"(median of 5 CUDA-event timings / {BATCH}); single-frame "
            f"{ms[name]:.4f} ms, on {card}")
    t0 = time.perf_counter()
    for f in frames4k:
        dec.decode(f)
    oneshot_ms = (time.perf_counter() - t0) * 1e3 / BATCH
    t0 = time.perf_counter()
    n_stream = sum(1 for _ in sdec.decode_iter_rgb(frames4k))
    stream2_ms = (time.perf_counter() - t0) * 1e3 / n_stream
    t0 = time.perf_counter()
    n_dev = 0
    for out in sdec.decode_iter(frames4k):
        n_dev += 1
    torch.cuda.synchronize()
    stream_dev_ms = (time.perf_counter() - t0) * 1e3 / n_dev
    profiling.reset_stats()
    t0 = time.perf_counter()
    kept = bd_t.decode(frames4k)
    batch2_ms = (time.perf_counter() - t0) * 1e3 / BATCH
    stages = {k: v.total_s * 1e3 / BATCH
              for k, v in profiling.get_stats().items()}
    del kept  # returning 1.6 GB to the system is outside the timing
    t0 = time.perf_counter()
    out_b = bd_t.decode_prepared(bd_t.prepare_batch(frames4k))
    torch.cuda.synchronize()
    bdev_ms = (time.perf_counter() - t0) * 1e3 / BATCH
    del out_b
    log(f"(h) wall per 4K frame on {card}: BatchDecoder.decode (B = {BATCH}) "
        f"{batch_wall['K2']:.3f} ms first, {batch2_ms:.3f} ms second "
        f"(its stages: prepare_batch {stages['batch_prepare']:.3f}, upload "
        f"and launch {stages['batch_launch']:.3f}, kernel wait and to_rgb "
        f"into a new host array {stages['batch_readback']:.3f}; the pinned "
        f"upload alone {up_ms:.3f}); prepare_batch + decode_prepared to "
        f"the card, synchronized, {bdev_ms:.3f}; "
        f"StreamDecoder.decode_iter_rgb {stream_ms:.3f} then {stream2_ms:.3f} "
        f"ms ({1e3 / stream2_ms:.1f} frames/s), decode_iter without readback "
        f"{stream_dev_ms:.3f} ms; {BATCH} one-shot Decoder().decode calls "
        f"{oneshot_ms:.3f} ms; exact batch {batch_wall['K2x']:.3f}, fancy + "
        f"exact batch {batch_wall['K3']:.3f}")

    # ---- (i) the relayout kernels --------------------------------------------
    # The path: the probe tool, at the probes' shapes and on the 4K decode.
    tool, rl_counts = drive(lambda: exp_relayout.probes("cuda", reps=REPS)
                         + [exp_relayout.swap_on_decode("cuda", reps=REPS)])
    for res in tool:
        log("(i) " + exp_relayout.report(res))
        require(res["ok"], f"relayout: {res['probe']} differs from numpy")
    rl_keys = ("interleave", "swap_crop", "stack", "spread_merge")
    require(all(rl_counts[k] >= 1 for k in rl_keys)
            and not any(v for k, v in rl_counts.items()
                        if k not in rl_keys + ("fused",)),
            f"the relayout tool did not run on its own kernels: {rl_counts}")
    # Each kernel against its plain version, on the card, at those shapes.
    x5 = torch.randint(0, 1 << 24, (68, 8, 8, 16, 128), dtype=torch.int32,
                       device="cuda")
    slab = x5.reshape(34, 64, 4096)
    rl_err = {
        "interleave": int((R.relayout_interleave(x5[:64], stack_rows=True)
                           - R.relayout_interleave_reference(x5[:64], True)
                           ).abs().max()),
        "swap_crop": int((R.relayout_swap_crop(slab, 16, 2160, 3840)
                          - R.relayout_swap_crop_reference(slab, 16, 2160, 3840)
                          ).abs().max()),
        "stack": int((R.relayout_stack(x5)
                      - R.relayout_stack_reference(x5)).abs().max()),
        "spread_merge": max(
            int((R.relayout_spread_merge(x5[0, 0, 0], x5[1, 0, 0], 16)
                 - R.relayout_spread_merge_reference(x5[0, 0, 0], x5[1, 0, 0],
                                                     16)).abs().max()),
            int((R.relayout_copy(x5) - x5).abs().max())),
    }
    require(not any(rl_err.values()),
            f"a relayout kernel differs from its plain version: {rl_err}")
    log("(i) relayout_interleave, relayout_swap_crop, relayout_stack, "
        "relayout_spread_merge (and the copy) == their plain versions at "
        "the probes' shapes (exact)")
    del x5, slab
    # The copy where its 16-byte kernel runs and where the shift kernel
    # does, against its plain version (torch's clone), and its time beside
    # clone's and its bound, alternating two inputs so that none waits in
    # the L2 cache.
    words = 2160 * 3840
    bases = [torch.randint(0, 1 << 24, (words + 8,), dtype=torch.int32,
                           device="cuda") for _ in range(2)]
    views = {
        "aligned": (lambda b: b[:words].reshape(2160, 3840), "vec"),
        "one word off": (lambda b: b[1:1 + words].reshape(2160, 3840),
                         "shift"),
        "4,095 words": (lambda b: b[:4095].reshape(1, 4095), "shift"),
        "strided rows": (lambda b: b[:words].reshape(2160, 3840)[:, :3836],
                         "vec"),
        "strided rows, ragged": (
            lambda b: b[:words].reshape(2160, 3840)[:, 1:3838], "shift"),
    }
    copy_ms, shift_launches, shift_err = {}, 0, 0
    for name, (view, want_route) in views.items():
        a = view(bases[0])
        got, copy_counts = drive(lambda: R.relayout_copy(a))
        route = R.spread_merge_route(a.data_ptr(), got.data_ptr(), *a.shape,
                                     1, a.stride(0))
        err = int((got - a.clone()).abs().max())
        key = "copy_shift" if want_route == "shift" else "spread_merge"
        if key == "copy_shift":
            shift_launches += copy_counts[key]
            shift_err = max(shift_err, err)
        else:
            rl_err["spread_merge"] = max(rl_err["spread_merge"], err)
        require(route == want_route and copy_counts[key] == 1
                and sum(copy_counts.values()) == 1 and err == 0
                and got.is_contiguous(),
                f"the copy, {name}: route {route} (expected {want_route}), "
                f"launches {copy_counts} (expected one of {key}), max |diff| "
                f"{err}")
        copy_ms[name] = (
            exp_relayout.cuda_ms(lambda i: R.relayout_copy(view(bases[i % 2])),
                                 REPS),
            exp_relayout.cuda_ms(lambda i: view(bases[i % 2]).clone(), REPS),
            2 * a.numel() * 4 / HBM_BYTES_PER_S * 1e3, route)
        log(f"(i) the copy, {name} ({route} kernel, {a.numel() * 4} B): == "
            f"clone(); {copy_ms[name][0]:.4f} ms, clone() "
            f"{copy_ms[name][1]:.4f} ms, bound {copy_ms[name][2]:.4f} ms "
            f"(medians of {REPS} bursts of {exp_relayout.BURST}) on {card}")
    del bases
    # The interleave on the kernel its route names: the 16-byte kernel at
    # the probe's shape, the word kernel where vectors do not fit; each
    # against its plain version, timed beside transpose(-1, -2).contiguous()
    # on two alternating inputs.
    n1 = 64 * 8 * 8
    bases = [torch.randint(0, 1 << 24, (n1 * 16 * 130 + 8,),
                           dtype=torch.int32, device="cuda") for _ in range(2)]
    views = {
        "aligned [4096, 16, 128]": (
            lambda b: b[:n1 * 2048].reshape(n1, 16, 128), "vec"),
        "one word off": (
            lambda b: b[1:1 + n1 * 2048].reshape(n1, 16, 128), "word"),
        "X = 3": (lambda b: b[:n1 * 384].reshape(n1, 3, 128), "word"),
        "X = 64": (lambda b: b[:n1 * 2048].reshape(n1, 64, 32), "word"),
        "L = 130": (lambda b: b[:n1 * 2080].reshape(n1, 16, 130), "word"),
        "strided batch t[:, 0]": (
            lambda b: b[:n1 * 2048].reshape(n1 // 8, 8, 16, 128)[:, 0],
            "vec"),
    }
    interleave_ms = {}
    for name, (view, want_route) in views.items():
        a = view(bases[0])
        got, il_counts = drive(lambda: R.relayout_interleave(a))
        n_, x_, l_ = a.shape
        route = R.interleave_route(a.data_ptr(), got.data_ptr(), n_, x_, l_,
                                   a.stride(0))
        err = int((got - R.relayout_interleave_reference(a)).abs().max())
        rl_err["interleave"] = max(rl_err["interleave"], err)
        require(route == want_route and il_counts["interleave"] == 1
                and err == 0,
                f"the interleave, {name}: route {route} (expected "
                f"{want_route}), launches {il_counts['interleave']}, max "
                f"|diff| {err}")
        interleave_ms[name] = (
            exp_relayout.cuda_ms(
                lambda i: R.relayout_interleave(view(bases[i % 2])), REPS),
            exp_relayout.cuda_ms(
                lambda i: view(bases[i % 2]).transpose(-1, -2).contiguous(),
                REPS),
            2 * a.numel() * 4 / HBM_BYTES_PER_S * 1e3, route)
        log(f"(i) the interleave, {name} ({route} kernel, {a.numel() * 4} "
            f"B): == its plain version; {interleave_ms[name][0]:.4f} ms, "
            f"transpose(-1, -2).contiguous() {interleave_ms[name][1]:.4f} ms, "
            f"bound {interleave_ms[name][2]:.4f} ms (medians of {REPS} "
            f"bursts of {exp_relayout.BURST}) on {card}")
    del bases
    # The swap and crop of the 4K slab on each route: the 16-byte kernel
    # to the 4K raster, the word tile to rows of 3838 words (no whole
    # vectors); each against its plain version and timed beside it, on two
    # alternating slabs. Its bound counts the kept words only, read once and
    # written once: neither route touches the rows and columns it crops.
    slabs = [torch.randint(0, 1 << 24, (34, 64, 4096), dtype=torch.int32,
                           device="cuda") for _ in range(2)]
    swap_ms = {}
    for name, width, want_route in (("4K [2160, 3840]", 3840, "vec"),
                                    ("[2160, 3838]", 3838, "word")):
        got, sw_counts = drive(
            lambda: R.relayout_swap_crop(slabs[0], 16, 2160, width))
        route = R.swap_crop_route(slabs[0].data_ptr(), got.data_ptr(), 16,
                                  width)
        err = int((got - R.relayout_swap_crop_reference(
            slabs[0], 16, 2160, width)).abs().max())
        rl_err["swap_crop"] = max(rl_err["swap_crop"], err)
        require(route == want_route and sw_counts["swap_crop"] == 1
                and err == 0,
                f"the swap, {name}: route {route} (expected {want_route}), "
                f"launches {sw_counts['swap_crop']}, max |diff| {err}")
        swap_ms[name] = (
            exp_relayout.cuda_ms(lambda i: R.relayout_swap_crop(
                slabs[i % 2], 16, 2160, width), REPS),
            exp_relayout.cuda_ms(lambda i: R.relayout_swap_crop_reference(
                slabs[i % 2], 16, 2160, width), REPS),
            2 * got.numel() * 4 / HBM_BYTES_PER_S * 1e3, route)
        log(f"(i) the swap and crop, {name} ({route} kernel): == its plain "
            f"version; {swap_ms[name][0]:.4f} ms, reshape + transpose + "
            f"crop + contiguous() {swap_ms[name][1]:.4f} ms, bound "
            f"{swap_ms[name][2]:.4f} ms (medians of {REPS} bursts of "
            f"{exp_relayout.BURST}) on {card}")
    del slabs

    # ---- (j) the validation tool ------------------------------------------------
    # Streams from the port's own encoder in every mode of the port, held to
    # the port's own golden decoder, and a short corruption soak: every check
    # must print OK (a FAIL makes its exit status 1).
    t0 = time.perf_counter()
    rc = validate.main(["--quick"])
    log(f"(j) python -m compeg_tpu_torch.tools.validate --quick: exit {rc} "
        f"in {time.perf_counter() - t0:.1f} s on {card}")
    require(rc == 0, "the validation tool found a failure (its FAIL lines)")

    # ---- (k) the capture path ---------------------------------------------------
    # The 64 4K frames of phase (h) as one MJPEG stream, through each capture
    # route into StreamDecoder (K2) and through the viewer (K2, and K2s for
    # --scale), each frame held to Decoder().decode of the same frame by its
    # sha256 and each thumbnail to Decoder().decode_scaled.
    t_k = time.perf_counter()
    want_sha = [testdata.digest(dec.decode(f)) for f in frames4k]
    require(want_sha[0] == str(vec["bench4k_rgb_sha256"]),
            "capture: frame 0 is not golden's bench4k (sha256)")
    want_thumb = {k: [testdata.digest(dec.decode_scaled(f, k))
                      for f in frames4k] for k in SCALES}
    tmp = tempfile.mkdtemp(prefix="compeg_smoke_")
    mjpeg_path = os.path.join(tmp, "capture.mjpeg")
    stream_bytes = mjpeg.concat_frames(frames4k)
    with open(mjpeg_path, "wb") as f:
        f.write(stream_bytes)
    capture_launches = {"fused": 0, "scaled": 0}
    capture_ms = {}
    kdec = StreamDecoder(depth=2)

    def capture_route(name, source, frames_expected=BATCH):
        """Every frame of ``source()`` through kdec.decode_iter and to_rgb,
        against want_sha in order; the wall per frame up to the last frame,
        the digests' time taken out."""
        digests = []
        spent = [0.0, 0.0]  # digest seconds, time of the last frame

        def run():
            for out in kdec.decode_iter(source()):
                got = kdec.to_rgb(out)
                t1 = time.perf_counter()
                digests.append(testdata.digest(got))
                spent[1] = time.perf_counter()
                spent[0] += spent[1] - t1

        t0 = time.perf_counter()
        _, counts = drive(run)
        wall = (spent[1] - t0 - spent[0]) * 1e3 / max(1, len(digests))
        require(len(digests) == frames_expected and all(
            d == want_sha[i % BATCH] for i, d in enumerate(digests)),
            f"capture, {name}: {len(digests)} frames, not every one "
            "Decoder().decode of the same frame (sha256)")
        require(counts["fused"] == frames_expected
                and sum(counts.values()) == frames_expected,
                f"capture, {name}: launches {counts}, not one K2 a frame")
        capture_launches["fused"] += counts["fused"]
        capture_ms[name] = wall
        log(f"(k) {name}: {len(digests)} 4K frames, each == Decoder().decode "
            f"of the same frame (sha256), one K2 launch each; {wall:.3f} ms "
            f"wall per frame ({1e3 / wall:.1f} frames/s) on {card}")

    warm = list(kdec.decode_iter(frames4k[:4]))  # pinned buffers, workers
    del warm
    capture_route("frames_from_file -> StreamDecoder.decode_iter",
                  lambda: mjpeg.frames_from_file(mjpeg_path))

    def piped():
        """frames_from_stream on an os.pipe that a thread fills in chunks
        of 65,537 bytes, so SOI markers fall across chunks."""
        r, w = os.pipe()

        def writer():
            try:
                view = memoryview(stream_bytes)
                for i in range(0, len(view), 65537):
                    chunk = view[i:i + 65537]
                    while chunk:
                        chunk = chunk[os.write(w, chunk):]
            finally:
                os.close(w)

        th = threading.Thread(target=writer, daemon=True)
        th.start()
        with os.fdopen(r, "rb") as f:
            yield from mjpeg.frames_from_stream(f)
        th.join()

    capture_route("frames_from_stream on a pipe, 65,537-byte chunks", piped)

    def from_process():
        """The same pipe written by another process, as ffmpeg or a camera
        daemon would write it."""
        writer = subprocess.Popen(
            [sys.executable, "-c", "import sys\n"
             "d = open(sys.argv[1], 'rb').read()\n"
             "for i in range(0, len(d), 65537):\n"
             "    sys.stdout.buffer.write(d[i:i + 65537])\n", mjpeg_path],
            stdout=subprocess.PIPE)
        try:
            yield from mjpeg.frames_from_stream(writer.stdout)
        finally:
            writer.stdout.close()
            writer.wait(timeout=60)

    capture_route("frames_from_stream on a pipe from another process",
                  from_process)

    def followed():
        """follow_frames on a file that a thread grows in 1 MiB appends."""
        live = os.path.join(tmp, "live.mjpeg")
        open(live, "wb").close()

        def writer():
            with open(live, "ab") as f:
                for i in range(0, len(stream_bytes), 1 << 20):
                    f.write(stream_bytes[i:i + (1 << 20)])
                    f.flush()

        th = threading.Thread(target=writer, daemon=True)
        th.start()
        yield from mjpeg.follow_frames(live, poll_s=0.002,
                                       idle_timeout_s=0.2)
        th.join()

    # Its wall includes the 0.2 s without growth that ends the stream: the
    # decoder asks for the next frame before it hands out the last ones.
    capture_route("follow_frames on a growing file (0.2 s idle timeout)",
                  followed)

    # The camera: the 64 frames through v4l2.Camera over a fake driver, an
    # error-flagged copy of one frame and a frame without SOI among them.
    served = [(f, 0) for f in frames4k]
    served.insert(BATCH // 3, (b"\x00" + frames4k[BATCH // 3][1:], 0))
    served.insert(BATCH // 6, (frames4k[BATCH // 6], v4l2.BUF_FLAG_ERROR))
    cam = FakeCamera(served, size=(3840, 2160))

    def camera():
        with cam.installed(), v4l2.Camera("/dev/video0",
                                          size=(3840, 2160)) as c:
            require(c.size == (3840, 2160), f"camera size {c.size}")
            yield from c.frames(max_frames=BATCH)

    capture_route("v4l2.Camera.frames (fake driver, one error-flagged and "
                  "one non-SOI frame skipped)", camera)
    require(cam.served == BATCH + 2 and not cam.streaming,
            f"camera: served {cam.served}, streaming {cam.streaming}")

    # The viewer in process: --loop 2 at full scale, then --scale 1, 2, 4.
    def viewer_run(argv, want, key, frames_expected):
        """viewer.main(argv) with each frame held to ``want``; the wall per
        frame of the whole call (reading the file included) and between
        its first and last frame (steady), the digests' time taken out."""
        digests = []
        arrived, spent = [], [0.0]

        def on_frame(n, got):
            arrived.append(time.perf_counter() - spent[0])
            t1 = time.perf_counter()
            digests.append(testdata.digest(got) == want[n % BATCH])
            spent[0] += time.perf_counter() - t1

        quiet = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(quiet):
            n, counts = drive(lambda: viewer.main(argv, on_frame=on_frame))
        wall = ((time.perf_counter() - t0 - spent[0]) * 1e3
                / max(1, frames_expected))
        steady = (arrived[-1] - arrived[0]) * 1e3 / max(1, n - 1)
        name = "viewer " + " ".join(argv[1:])
        require(n == len(digests) == frames_expected and all(digests),
                f"capture, {name}: {n} frames, not each the single decode")
        require(counts[key] == frames_expected
                and sum(counts.values()) == frames_expected,
                f"capture, {name}: launches {counts}")
        capture_launches[key] += counts[key]
        capture_ms[name] = (wall, steady)
        log(f"(k) {name}: {n} frames, each == Decoder()."
            + ("decode (sha256)" if key == "fused" else "decode_scaled")
            + f", one {'K2' if key == 'fused' else 'K2s'} launch each; "
            f"{wall:.3f} ms wall per frame with the file's reading, "
            f"{steady:.3f} ms from the first frame to the last "
            f"({1e3 / steady:.1f} frames/s) on {card}; its last line: "
            f"{quiet.getvalue().splitlines()[-1]}")

    viewer_run([mjpeg_path, "--loop", "2", "--stats-every", "64"], want_sha,
               "fused", 2 * BATCH)
    for k in SCALES:
        viewer_run([mjpeg_path, "--scale", str(k), "--stats-every", "64"],
                   want_thumb[k], "scaled", BATCH)
    one = os.path.join(tmp, "frame0.jpg")
    with open(one, "wb") as f:
        f.write(frames4k[0])
    shown = io.StringIO()
    with contextlib.redirect_stdout(shown):
        viewer.main([one, "--preview", "--scale", "1"])
    require(viewer.render_ansi(dec.decode_scaled(frames4k[0], 1), 96)
            in shown.getvalue(), "capture: the viewer's --preview is not "
            "render_ansi of the 1/8 decode")
    log(f"(k) viewer --preview --scale 1 on one frame: {len(shown.getvalue())}"
        " characters into a buffer, == render_ansi of decode_scaled(k=1)")
    shutil.rmtree(tmp)
    del stream_bytes, served, cam
    log(f"(k) the capture path in {time.perf_counter() - t_k:.1f} s; "
        f"launches {capture_launches}")

    # ---- (l) the banded decode on the card ---------------------------------------
    # A world of one NCCL rank on a 1 x 1 DeviceMesh (one card holds one
    # rank; the halo between ranks is tested with gloo on the CPU): a batch
    # of 8 4K frames in 4 bands in each mode, and a 1920 x 1080 4:2:2 stream
    # at Ri = 7 (wm = 120 is no multiple of 7, so bands are cut at restart
    # boundaries and its last interval is short), each equal to
    # BatchDecoder or Decoder on the card byte for byte. Every band frame of
    # a launch is gated to its band's MCUs inside the image: the launch's
    # per-frame counts (read from the parameters it was given) must be each
    # BandedFrame's band_mcus, and the kernels must equal their plain twins,
    # given the same counts, on every live MCU row of every band frame, with
    # random words in the rows of the gated segments.
    t_l = time.perf_counter()

    def launch_gates(fn):
        """fn() with the parameters of each kernel launch it makes kept:
        (result, [(entry, per-frame MCU counts)])."""
        seen = []
        real = _build.launch

        def spy(name, *tensors, params, lib=None):
            if not isinstance(params, _build.DecodeParams):  # E's launch
                return real(name, *tensors, params=params, lib=lib)
            gate = F.BandGate(params.image_mcus, params.bands, params.band0)
            seen.append((name, [gate.mcus(params.total_mcus, f)
                                if params.bands else params.total_mcus
                                for f in range(params.frames)]))
            return real(name, *tensors, params=params, lib=lib)

        _build.launch = spy
        try:
            return fn(), seen
        finally:
            _build.launch = real

    def gated_vs_twins(tag, bands, pf0, geom, exact, planes):
        """The banded kernel of one mode on ``bands`` (BandedFrames of one
        geometry, their gated segments' rows filled with random words)
        against its plain twin on every live MCU row of each band frame:
        the integer modes equal, K3 float within 1, K2 within 2 and at most
        1e-5 of the samples off by more than 1 (phases c and d)."""
        rows_np, mcus = SH.stack_banded(bands)
        gated = bands[0].seg_mcus == 0
        rows_np[:, gated] = np.random.default_rng(11).integers(
            -2 ** 31, 2 ** 31, rows_np[:, gated].shape, dtype=np.int64)
        nb = rows_np.shape[1]
        flat = torch.from_numpy(rows_np.reshape(-1, *rows_np.shape[2:])).cuda()
        bg = SH.band_geometry(geom, bands[0].band_rows)
        gate = SH.band_gate(geom, nb, 0)
        counts = [gate.mcus(bg.total_mcus, f) for f in range(len(flat))]
        require(counts == mcus.reshape(-1).tolist(),
                f"{tag}: gate counts {counts} are not band_mcus")
        args = (flat, bands[0].nseg, pf0.tables, pf0.op, bg)
        if planes:
            got = F.fused_decode_planes(*args, exact=exact, gate=gate)
        elif exact:
            got = F.fused_decode_rgba_exact(*args, gate)
        else:
            got = F.fused_decode_rgba(*args, gate)
        err, live_rows = 0, 0
        for f, m in enumerate(counts):
            live = m // bg.width_mcus
            one = (flat[f], bands[0].nseg, pf0.tables, pf0.op, bg)
            if planes:
                twin = F.fused_decode_planes_reference(*one, exact, m)
                for c, (_, v) in enumerate(bg.samplings):
                    n = live * 8 * v
                    err = max(err, int((got[c][f][:n].int() - twin[c][:n]
                                        .int()).abs().max()) if n else 0)
            else:
                twin = (F.fused_decode_rgba_exact_reference if exact else
                        F.fused_decode_rgba_reference)(*one, m)
                n = live * 8 * max(v for _, v in bg.samplings)
                if n:
                    mx, frac = pixel_stats(rgb(got[f][:n]), rgb(twin[:n]))
                    require(frac <= 1e-5, f"{tag}: frame {f} frac>1 {frac}")
                    err = max(err, mx)
            live_rows += live
        require(err <= (0 if exact else 1 if planes else 2),
                f"{tag}: the banded kernel is {err} from its plain twin")
        log(f"(l) {tag}: {len(counts)} band frames gated to {counts[:nb]} "
            f"MCUs a frame (== band_mcus), {live_rows} live MCU rows == the "
            f"plain twins' (max |diff| {err}) with random words in the "
            f"{int(gated.sum())} gated segments of each frame")

    dist.init_process_group("nccl", world_size=1, rank=0,
                            init_method=f"tcp://127.0.0.1:{MH.free_port()}")
    banded_launches = {}
    banded_ms = {}
    try:
        mesh = SH.make_mesh(1, 1)
        require(not isinstance(mesh, SH.LocalMesh)
                and mesh.device_type == "cuda",
                f"the mesh is not a CUDA DeviceMesh: {mesh}")
        frames8 = frames4k[:8]
        band_modes = {
            "nearest (K2)": ({}, ("fused",)),
            "exact_idct (K2x)": ({"exact_idct": True}, ("fused_exact",)),
            "fancy + exact (K3 integer, E)": (
                {"fancy_upsampling": True, "exact_idct": True},
                ("planes", "epilogue")),
            "fancy float (K3 float, E)": (
                {"fancy_upsampling": True}, ("planes", "epilogue")),
        }
        bands = [SH.prepare_banded(analyze(f), 4) for f in frames8]
        brows_np, bmcus = SH.stack_banded(bands)
        brows = torch.from_numpy(brows_np).cuda()
        bgeom = pf.geom
        require(bmcus.tolist() == [[16320, 16320, 16320, 15840]] * 8,
                f"4K in 4 bands: band_mcus {bmcus.tolist()}")
        for name, (knobs, keys) in band_modes.items():
            bd = BatchDecoder(**knobs)
            sd = BatchDecoder(**knobs)  # the banded decode's own staging
            want = bd.decode(frames8)
            ((out, gates), e_calls), lcounts = drive(lambda: e_spy(
                lambda: launch_gates(lambda: SH.decode_frames_sharded(
                    frames8, mesh, 4, decoder=sd))))
            require(one_launch_each(lcounts, keys),
                    f"banded {name}: launches {lcounts}, not one of each of "
                    f"{keys}")
            require(len(gates) == 1
                    and gates[0][1] == bmcus.reshape(-1).tolist(),
                    f"banded {name}: the launch's per-frame MCU counts "
                    f"{gates} are not the BandedFrames' band_mcus")
            for k in keys:
                banded_launches[k] = banded_launches.get(k, 0) + lcounts[k]
            e_calls_vs_plain(e_calls, f"banded {name}, 8 4K frames in 4 "
                             "bands, one launch")
            del e_calls
            got = F.rgba_to_rgb(SH.gather_global(out, mesh)).cpu().numpy()
            require(np.array_equal(got, want),
                    f"banded {name}: differs from BatchDecoder")

            bpfs = bd.prepare_batch(frames8)
            rows_b = bd.upload()

            def banded_kernel(pf0=bpfs[0], sd=sd):
                return SH.decode_batch_sharded(
                    brows, bands[0].nseg, pf0.tables, pf0.op, mesh=mesh,
                    geom=bgeom, band_rows=bands[0].band_rows,
                    fancy_upsample=sd.fancy, exact_idct=sd.exact_idct)

            banded_ms[name] = (
                cuda_ms(banded_kernel, reps=5, burst=1) / 8,
                cuda_ms(lambda: bd._dec.decode_rows(bpfs[0], rows_b),
                        reps=5, burst=1) / 8,
                wall_ms(lambda: SH.decode_frames_sharded(frames8, mesh, 4,
                                                         decoder=sd),
                        reps=3) / 8,
                wall_ms(lambda: bd.decode_prepared(bd.prepare_batch(
                    frames8)), reps=3) / 8)
            del rows_b
            log(f"(l) banded {name}: 8 4K frames in 4 bands of "
                f"{bands[0].band_rows} MCU rows == BatchDecoder byte for "
                f"byte, one launch of each of {keys} gated to band_mcus "
                f"{bmcus[0].tolist()}; per frame: banded "
                f"{banded_ms[name][0]:.4f} ms on the card (rows resident; "
                f"BatchDecoder's decode_rows {banded_ms[name][1]:.4f} ms), "
                f"wall with the host's prepare and upload "
                f"{banded_ms[name][2]:.3f} ms (BatchDecoder prepare_batch + "
                f"decode_prepared {banded_ms[name][3]:.3f} ms); medians of "
                f"5 CUDA-event timings and 3 walls, on {card}")
        del brows
        for tag, exact, planes in (("K2", False, False),
                                   ("K2x", True, False),
                                   ("K3 integer", True, True),
                                   ("K3 float", False, True)):
            pf0 = Decoder(exact_idct=exact).prepare(frames8[0])
            gated_vs_twins(f"4K {tag}", bands, pf0, bgeom, exact, planes)
        # The Ri = 7 stream, from the 4K frame's top-left 1080p by the
        # port's encoder.
        t0 = time.perf_counter()
        data7 = encoder.encode(main_rgb[:1080, :1920], sampling="422",
                               quality=90, restart_interval_mcus=7)
        img7 = analyze(data7)
        require((img7.width_mcus, img7.height_mcus, img7.restart_interval)
                == (120, 135, 7) and img7.total_mcus % 7,
                "the Ri = 7 stream has another geometry")
        log(f"(l) 1920x1080 4:2:2 Ri = 7 encoded in "
            f"{time.perf_counter() - t0:.1f} s: {len(data7)} bytes, "
            f"{img7.total_restart_intervals} segments, band rows "
            f"{SH.band_rows_for(img7, 4)}")
        for name, knobs, keys in (
                ("nearest", {}, ("fused",)),
                ("exact_idct", {"exact_idct": True}, ("fused_exact",)),
                ("fancy + exact", {"fancy_upsampling": True,
                                   "exact_idct": True},
                 ("planes", "epilogue"))):
            want = Decoder(**knobs).decode(data7)
            out, lcounts = drive(lambda: SH.decode_frames_sharded(
                [data7] * 2, mesh, 4, decoder=BatchDecoder(**knobs)))
            require(one_launch_each(lcounts, keys),
                    f"banded Ri = 7 {name}: launches {lcounts}")
            for k in keys:
                banded_launches[k] = banded_launches.get(k, 0) + lcounts[k]
            got = F.rgba_to_rgb(out).cpu().numpy()
            require(got.shape == (2, 1080, 1920, 3)
                    and all(np.array_equal(g, want) for g in got),
                    f"banded Ri = 7 {name}: differs from Decoder")
            log(f"(l) banded Ri = 7 {name}: 2 frames in 4 bands == "
                f"Decoder().decode byte for byte, one launch of each of "
                f"{keys}")
        # 4:2:0 under the fancy filter: the batch of four 40 x 136 frames at
        # Ri = 5 in 4 bands, whose content ends inside the first band (the
        # chroma's content edge, valid, in E's launch).
        c420 = list(vec["batch_labels"]).index("420 ri=5 40x136")
        frames420 = [vec[f"batch{c420}_jpeg_{f}"].tobytes()
                     for f in range(nframes)]
        knobs = {"fancy_upsampling": True, "exact_idct": True}
        want = BatchDecoder(**knobs).decode(frames420)
        (out, e_calls), lcounts = drive(lambda: e_spy(
            lambda: SH.decode_frames_sharded(frames420, mesh, 4,
                                             decoder=BatchDecoder(**knobs))))
        require(one_launch_each(lcounts, ("planes", "epilogue")),
                f"banded 4:2:0: launches {lcounts}")
        for k in ("planes", "epilogue"):
            banded_launches[k] += lcounts[k]
        valids = [h[2] for h in e_calls[0][1]["halos"] if h is not None]
        require(valids and all(v is not None for v in valids),
                f"banded 4:2:0: E was given no content edge: {valids}")
        e_calls_vs_plain(e_calls, "banded 4:2:0 fancy, 4 frames in 4 bands, "
                         f"valid {valids}")
        got = F.rgba_to_rgb(out).cpu().numpy()
        require(np.array_equal(got, want),
                "banded 4:2:0 fancy: differs from BatchDecoder")
        log(f"(l) banded 4:2:0 fancy + exact, {nframes} frames of 40x136 at "
            f"Ri = 5 in 4 bands: == BatchDecoder byte for byte, one launch of "
            f"K3 and one of E (content edge valid = {valids}), E == its "
            f"plain twin")
        bands7 = [SH.prepare_banded(img7, 4)] * 2
        require(bands7[0].band_mcus.tolist() == [4200, 4200, 4200, 3600]
                and bands7[0].seg_mcus[3, 514] == 2,
                f"Ri = 7 in 4 bands: band_mcus {bands7[0].band_mcus}")
        for tag, exact, planes in (("K2", False, False),
                                   ("K2x", True, False),
                                   ("K3 integer", True, True)):
            pf7 = Decoder(exact_idct=exact).prepare(data7)
            gated_vs_twins(f"Ri = 7 {tag}", bands7, pf7, pf7.geom, exact,
                           planes)
    finally:
        dist.destroy_process_group()
    log(f"(l) the banded decode in {time.perf_counter() - t_l:.1f} s; "
        f"launches {banded_launches}")

    # ---- (m) the measurement tools, in their quick forms ------------------
    # In process, on the same card: each tool's last stdout line must parse
    # as its JSON result. The resident decode's busy time must lie within
    # [0.8, 1.5] x K2's burst time of phase (f): with the rows on the card
    # K2 is all the card does.
    def tool_line(mod, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(argv)
        name = mod.__name__.rsplit('.', 1)[-1]
        for line in buf.getvalue().splitlines():
            log(f"(m) {name}: {line}")
        require(rc == 0, f"tools.{name} {argv}: exit {rc}")
        return json.loads(buf.getvalue().strip().splitlines()[-1])

    def tools_quick():
        res = {"bench": tool_line(bench_tool, ["--frames", "30", "--rounds",
                                               "3"])}
        for flag in ([], ["--exact"], ["--fancy"]):
            res["trace_ops" + "".join(flag)] = tool_line(trace_ops, flag)
        res["bench_stream"] = tool_line(bench_stream,
                                   ["--device", "--frames", "16"])
        res["trace_sharded"] = tool_line(trace_sharded, ["1"])
        res["bench_scaling"] = tool_line(bench_scaling, ["--max-ranks", "1"])
        return res

    # Every torch.profiler session of this run lies in this phase, a few
    # seconds apart: a session started a minute or more after the last one
    # can lose device records (PERF.md section 7); trace_device_ms finds a
    # launch without its device record and traces again. First
    # decode_prepared's device busy total (kernels, device copies, memsets)
    # beside the CUDA-event span around each call, which also holds the
    # pageable upload and the host's gaps.
    t_m = time.perf_counter()
    traced = profiling.trace_device(lambda: dec.decode_prepared(pf), frames=5)
    log(f"(m) decode_prepared per frame: device busy (trace_device_ms) "
        f"{traced.total_ms:.4f} ms, CUDA-event span {traced.event_ms:.4f} ms "
        f"on {card}; summed {traced.counted}; torch.profiler rows: "
        f"{[(round(t, 4), n, name[:40]) for t, n, name in traced.rows[:3]]}")
    require(0 < traced.total_ms < traced.event_ms,
            f"decode_prepared's busy total {traced.total_ms} is not below "
            f"its event span {traced.event_ms}")
    res_m, tools_launches = drive(tools_quick)
    b = res_m["bench"]
    require(all(v is not None for v in b.values()) and b["device"]["name"],
            f"tools.bench: a null field: {b}")
    require(b["trace_ms"] <= b["trace_event_ms"],
            f"tools.bench: trace_ms {b['trace_ms']} over its event span "
            f"{b['trace_event_ms']}")
    require(0.8 * ms["K2"] <= b["trace_ms"] <= 1.5 * ms["K2"],
            f"tools.bench: trace_ms {b['trace_ms']} outside [0.8, 1.5] x K2's "
            f"{ms['K2']} ms")
    for key in ("trace_ops", "trace_ops--exact", "trace_ops--fancy"):
        t = res_m[key]
        require(0 < t["trace_ms"] <= t["trace_event_ms"],
                f"tools.{key}: device total {t['trace_ms']}, event span "
                f"{t['trace_event_ms']}")
    fancy_trace = res_m["trace_ops--fancy"]
    fancy_kernels = sum(n for cat, n in fancy_trace["counted"].items()
                        if cat.lower() == "kernel") / fancy_trace["frames"]
    log(f"(m) trace_ops --fancy: device total {fancy_trace['trace_ms']:.4f} "
        f"ms a frame in {fancy_kernels:g} kernels a frame (K3 and E), "
        f"counted {fancy_trace['counted']}; rows "
        f"{[(round(t, 4), n, name[:48]) for t, n, name in fancy_trace['rows']]}"
        f" on {card}")
    idle = res_m["bench_stream"]["stream"]["idle_share"]
    require(0 <= idle <= 1, f"tools.bench_stream: idle share {idle}")
    require(res_m["trace_sharded"]["equal"],
            "tools.trace_sharded: the banded decode differs")
    sc = res_m["bench_scaling"]
    require(sc["counts"] == [1] and sc["value"] is not None and sc["valid"],
            f"tools.bench_scaling: {sc}")
    log(f"(m) the measurement tools in {time.perf_counter() - t_m:.1f} s on "
        f"{card}: value {b['value']:.1f} frames/s, trace_ms "
        f"{b['trace_ms']:.4f} (event span {b['trace_event_ms']:.4f}, K2 "
        f"burst {ms['K2']:.4f}), stream idle share {idle:.3f}, banded / "
        f"unbanded {res_m['trace_sharded']['ratio']:.3f}; launches "
        f"{tools_launches}")

    # ---- (n) lanes inside a restart-less segment --------------------------
    # 1080p 4:2:0 q95 frames with no restart markers, as cv2.imwrite writes
    # them, from the port's encoder (tools/exp_lanes.py's pictures): one
    # frame at its own row width, and LANE_BATCH frames that differ as one
    # [B, 1, W] batch padded with zero words to the widest, as a resident
    # pool holds them. Kernel L's table must equal the plain serial decode's
    # bit for bit; K2, K2x and K3 (integer and float) on its lanes must equal
    # their one-lane launch and their plain twins on the same lanes (K2 and
    # K3 float within 1: the f32 IDCT sums in another order); and
    # Decoder.decode_rows, driven with the counts zeroed, must launch L, K3
    # and E once each and equal its decode with one lane a segment.
    t_n = time.perf_counter()
    from compeg_tpu_torch.ops import lanes as LN

    with ProcessPoolExecutor(
            8, mp_context=multiprocessing.get_context("spawn")) as ex:
        lane_cases = list(ex.map(lane_case, range(LANE_BATCH)))
    dec_lx = Decoder(exact_idct=True, fancy_upsampling=True)
    dec_lf = Decoder()
    pfs_n = [dec_lx.prepare(d) for d, _ in lane_cases]
    pf_n, pf_nf = pfs_n[0], dec_lf.prepare(lane_cases[0][0])
    g_n, tab_n = pf_n.geom, pf_n.tables
    require(pf_n.nseg == 1 and g_n.total_mcus == 8160,
            f"the 1080p frame has {pf_n.nseg} segments, {g_n.total_mcus} "
            "MCUs: not one restart-less segment")
    width_n = max(p.rows.shape[1] for p in pfs_n)
    batch_n = torch.zeros((LANE_BATCH, 1, width_n), dtype=torch.int32)
    for b, p in enumerate(pfs_n):
        batch_n[b, :, :p.rows.shape[1]] = torch.from_numpy(
            p.rows[:1].view(np.int32))
    one_n, batch_n = dec_lx.upload(pf_n), batch_n.cuda()
    plain_tab = torch.from_numpy(np.stack([t for _, t in lane_cases]))
    log(f"(n) {LANE_BATCH} restart-less 1080p q95 frames, "
        f"{min(map(len, (d for d, _ in lane_cases)))}-"
        f"{max(map(len, (d for d, _ in lane_cases)))} bytes, encoded with "
        f"their plain lane tables in {time.perf_counter() - t_n:.1f} s")
    for L in sorted({LN.LANE_MCUS, 4}):
        for tag, rows_n, want in (("one frame", one_n, plain_tab[0]),
                                  (f"batch of {LANE_BATCH}", batch_n,
                                   plain_tab)):
            got = LN.lane_index(rows_n, 1, tab_n, g_n, L).table
            torch.cuda.synchronize()
            require(torch.equal(got.cpu(), want[..., ::L, :]),
                    f"kernel L's table of lanes of {L} MCUs differs from "
                    f"the plain table ({tag})")
    log(f"(n) kernel L == the plain lane table bit for bit, one frame and "
        f"the batch, lanes of {sorted({LN.LANE_MCUS, 4})} MCUs")
    lanes_1 = LN.lane_index(one_n, 1, tab_n, g_n, LN.LANE_MCUS)
    lanes_b = LN.lane_index(batch_n, 1, tab_n, g_n, LN.LANE_MCUS)
    lane_kernels = {
        "K2": (F.fused_decode_rgba, F.fused_decode_rgba_reference, pf_nf),
        "K2x": (F.fused_decode_rgba_exact,
                F.fused_decode_rgba_exact_reference, pf_n),
        "K3 int": (functools.partial(F.fused_decode_planes, exact=True),
                   functools.partial(F.fused_decode_planes_reference,
                                     exact=True), pf_n),
        "K3 float": (F.fused_decode_planes, F.fused_decode_planes_reference,
                     pf_nf),
    }
    lane_err = 0
    for name, (kernel, twin, p) in lane_kernels.items():
        def outs(x):
            return x if isinstance(x, tuple) else (x,)

        for tag, rows_n, lanes in (("one frame", one_n, lanes_1),
                                   (f"batch of {LANE_BATCH}", batch_n,
                                    lanes_b)):
            got = outs(kernel(rows_n, 1, p.tables, p.op, g_n, lanes=lanes))
            whole = outs(kernel(rows_n, 1, p.tables, p.op, g_n))
            frames_n = ([(rows_n, lanes)] if rows_n.dim() == 2 else
                        [(r, lanes._replace(table=lanes.table[b]))
                         for b, r in enumerate(rows_n)])
            plains = [outs(twin(r, 1, p.tables, p.op, g_n, lanes=ln))
                      for r, ln in frames_n]
            torch.cuda.synchronize()
            for i, (a, w) in enumerate(zip(got, whole)):
                require(torch.equal(a, w), f"{name} on lanes differs from "
                        f"its one-lane launch ({tag}, output {i})")
                want = torch.stack([pl[i] for pl in plains]) \
                    if rows_n.dim() == 3 else plains[0][i]
                err = int((a.view(torch.uint8).int()
                           - want.view(torch.uint8).int()).abs().max())
                require(err == 0 or (err <= 1 and name in ("K2", "K3 float")),
                        f"{name} on lanes: max |diff| {err} from its plain "
                        f"twin on the same lanes ({tag}, output {i})")
                lane_err = max(lane_err, err)
    log(f"(n) K2, K2x, K3 integer and float on lanes of {LN.LANE_MCUS} "
        f"MCU(s) == their one-lane launch, and their plain twins on the same "
        f"lanes (max |diff| {lane_err}), one frame and the batch")
    lane_launches = {}
    for tag, rows_n in (("one frame", one_n),
                        (f"batch of {LANE_BATCH}", batch_n)):
        frames_n = 1 if rows_n.dim() == 2 else rows_n.shape[0]
        before = profiling.get_counts()
        got, counts = drive(lambda: dec_lx.decode_rows(pf_n, rows_n))
        after = profiling.get_counts()
        only(counts, "lanes", f"Decoder.decode_rows, {tag}",
             also=("planes", "epilogue"))
        require(counts["lanes"] == 1, f"decode_rows, {tag}: {counts}")
        for k, v in counts.items():
            lane_launches[k] = lane_launches.get(k, 0) + v

        def moved(name):
            return after.get(name, 0) - before.get(name, 0)

        require(moved(profiling.LANES_LAUNCHED)
                == moved(profiling.MCUS_LAUNCHED) // LN.LANE_MCUS
                == 8160 * frames_n // LN.LANE_MCUS,
                f"decode_rows, {tag}: lanes "
                f"{moved(profiling.LANES_LAUNCHED)}, MCUs "
                f"{moved(profiling.MCUS_LAUNCHED)}")
        split, LN.SPLIT_MCUS = LN.SPLIT_MCUS, ((1, 10**9),)  # one lane
        try:
            whole = dec_lx.decode_rows(pf_n, rows_n)
        finally:
            LN.SPLIT_MCUS = split
        torch.cuda.synchronize()
        require(torch.equal(got, whole), f"decode_rows, {tag}: the lanes "
                "differ from one lane a segment")
    oneshot = dec_lx.decode(lane_cases[0][0])
    require(np.array_equal(np.asarray(oneshot), rgb(
        dec_lx.decode_rows(pf_n, one_n))),
        "Decoder.decode of the restart-less frame differs from decode_rows")
    log(f"(n) Decoder.decode_rows launches L, K3 and E once each, one frame "
        f"and the batch, and equals one lane a segment; Decoder.decode "
        f"equals it; counts {lane_launches}")
    ms["L"] = cuda_ms(lambda: LN.lane_index(one_n, 1, tab_n, g_n,
                                            LN.LANE_MCUS))
    batch_ms["L"] = cuda_ms(lambda: LN.lane_index(
        batch_n, 1, tab_n, g_n, LN.LANE_MCUS)) / LANE_BATCH
    lane_k3_ms = [cuda_ms(lambda: F.fused_decode_planes(
        r, 1, tab_n, pf_n.op, g_n, exact=True, lanes=ln)) / n
        for r, ln, n in ((one_n, lanes_1, 1),
                         (batch_n, lanes_b, LANE_BATCH))]
    plain["L"] = wall_ms(lambda: LN.lane_index_reference(
        one_n.cpu(), 1, tab_n, g_n, LN.LANE_MCUS), reps=1)
    log(f"(n) kernel L {ms['L']:.4f} ms a frame alone, {batch_ms['L']:.4f} "
        f"ms a frame of {LANE_BATCH}; K3 integer on its lanes "
        f"{lane_k3_ms[0]:.4f} / {lane_k3_ms[1]:.4f}; the plain table "
        f"{plain['L']:.0f} ms; on {card}; phase in "
        f"{time.perf_counter() - t_n:.1f} s")

    # ---- the kernels line ------------------------------------------------------
    # bound_ms: the larger of bytes (inputs read once, outputs written once)
    # over the memory rate and operations over the float32 rate. Operations
    # are the IDCT's and the colour conversion's on this frame's data (the
    # float IDCT skips zero coefficients, so it counts the nonzero ones);
    # the entropy phase's bit operations are not counted, which keeps the
    # bound a lower one.
    nnz = int(np.count_nonzero(k1))
    n_du = pf.nseg * g.ri * len(g.du_to_comp)
    in_bytes = pf.nseg * pf.rows.shape[1] * 4 + pf.tables.packed.numel() * 4
    px = g.height * g.width
    plane_bytes = sum(h * w for h, w in F.plane_shapes(g))
    colour_ops = 12 * px

    def bound(nbytes, ops):
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
        return {"bound_ms": max(by_bytes, by_ops) * 1e3,
                "bound_by": "bytes" if by_bytes >= by_ops else "operations"}

    bounds = {
        "K1": bound(in_bytes + n_du * 64 * 4, 0),
        "K2": bound(in_bytes + pf.op.numel() * 4 + px * 4,
                    2 * 64 * nnz + colour_ops),
        "K2x": bound(in_bytes + qz.numel() * 4 + px * 4,
                     768 * n_du + colour_ops),
        "K3 int": bound(in_bytes + qz.numel() * 4 + plane_bytes, 768 * n_du),
        "K3 float": bound(in_bytes + pf.op.numel() * 4 + plane_bytes,
                          2 * 64 * nnz),
        # E: the planes read once and the raster written once; the colour
        # conversion, and with the triangle filter about six operations per
        # chroma sample of the output grid.
        "E nearest": bound(plane_bytes + px * 4, colour_ops),
        "E fancy": bound(plane_bytes + px * 4, colour_ops + 12 * px),
        "E nearest 4:2:0": bound(sum(p.numel() for p in planes420) + px * 4,
                                 colour_ops),
        "E fancy 4:2:0": bound(sum(p.numel() for p in planes420) + px * 4,
                               colour_ops + 12 * px),
        # L: phase (n)'s frame's row and the tables read once, the lane
        # table (16 bytes a lane) written once.
        "L": bound(one_n.numel() * 4 + tab_n.packed.numel() * 4
                   + lanes_1.table.numel() * 4, 0),
    }
    for k in SCALES:
        zlen = {1: 1, 2: 5, 4: 25}[k]
        bounds[f"K2s k={k}"] = bound(
            in_bytes + lq[k].numel() * 4 + px * k * k // 64 * 4,
            2 * k * k * min(nnz, zlen * n_du) + colour_ops * k * k // 64)

    def entry(name, replaces, keys, err, ms_key, source=SOURCE, **extra):
        """One kernel's line; its launches are summed over the paths that
        run it (each driven with the counts zeroed)."""
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(v.get(k, 0) for v in launch_sets
                                for k in keys),
                "max_abs_err": err, "ms": ms[ms_key],
                "plain_ms": plain[ms_key], **bounds[ms_key],
                "library_ms": None, **extra}

    launch_sets = [launches, batch_launches, {"stream": stream_launches},
                   staged_batch_launches, capture_launches, banded_launches,
                   tools_launches, lane_launches]

    def relayout_entry(name, key, replaces, probe_name, **extra):
        res = next(r for r in tool if r["probe"] == probe_name)
        return {"name": name, "route": "cuda", "source": RELAYOUT_SOURCE,
                "replaces": replaces, "launches": rl_counts[key],
                "max_abs_err": rl_err[key], "ms": res["ms"],
                "plain_ms": res["library_ms"], "bound_ms": res["bound_ms"],
                "bound_by": "bytes", "library_ms": res["library_ms"],
                "probe": probe_name, "bytes": res["bytes"], **extra}

    log(json.dumps({
        "kernels": [
            entry("fused_decode_kernel<kIdctNone, kOutCoefs> (K1)",
                  "compeg_tpu/ops/entropy.py:440",
                  ("entropy",), k1_err, "K1",
                  staged_path_max_abs_err=staged_err,
                  staged_stage_ms=stage_ms),
            entry("fused_decode_kernel<kIdctFloat, kOutRgba> (K2)",
                  "compeg_tpu/ops/fused.py:419", ("fused", "stream"),
                  max(vs_plain[0], batch_err["K2"]), "K2",
                  batched_ms_per_frame=batch_ms["K2"]),
            entry("fused_decode_kernel<kIdctInt, kOutRgba> (K2x)",
                  "compeg_tpu/ops/fused.py:419", ("fused_exact",),
                  max(k2x_err, batch_err["K2x"]), "K2x",
                  batched_ms_per_frame=batch_ms["K2x"]),
            entry("fused_decode_kernel<kIdct*, kOutPlanes> (K3)",
                  "compeg_tpu/ops/fused.py:580", ("planes",),
                  max(k3_err, batch_err["K3"]), "K3 int",
                  batched_ms_per_frame=batch_ms["K3 int"],
                  float_ms=ms["K3 float"], float_plain_ms=plain["K3 float"],
                  float_bound_ms=bounds["K3 float"]["bound_ms"]),
            entry("planes_epilogue_kernel (E)",
                  "compeg_tpu/ops/fused.py:890", ("epilogue",), e_err[0],
                  "E fancy", source=EPILOGUE_SOURCE,
                  replaces_what="finalize_planes, the XLA output fusion of "
                  "decode_frame_fused_planes (compeg_tpu/pipeline.py:153); "
                  "no pl.pallas_call",
                  nearest_ms=ms["E nearest"],
                  nearest_plain_ms=plain["E nearest"],
                  nearest_bound_ms=bounds["E nearest"]["bound_ms"],
                  batched_ms_per_frame={k: batch_ms[f"E {k}"]
                                        for k in ("nearest", "fancy")},
                  ms_plain_ms_bound_ms_420={
                      k: [ms[f"E {k} 4:2:0"], plain[f"E {k} 4:2:0"],
                          bounds[f"E {k} 4:2:0"]["bound_ms"]]
                      for k in ("nearest", "fancy")},
                  trace_ops_fancy_kernels_per_frame=fancy_kernels,
                  cases=len(e_checked)),
            entry("fused_decode_kernel<kIdctScaled, kOutRgba> (K2s)",
                  "compeg_tpu/ops/fused.py:419", ("scaled",), scaled_err,
                  "K2s k=1", ms_by_k={k: ms[f"K2s k={k}"] for k in SCALES},
                  plain_ms_by_k={k: plain[f"K2s k={k}"] for k in SCALES},
                  bound_ms_by_k={k: bounds[f"K2s k={k}"]["bound_ms"]
                                 for k in SCALES}),
            # ms, plain_ms and bound_ms at phase (n)'s 1080p q95 frame
            entry("lane_sync_kernel, lane_round_kernel, lane_fix_kernel and "
                  "lane_index_kernel (L)", None, ("lanes",), 0, "L",
                  replaces_what="no TPU kernel: compeg_tpu decodes one "
                  "restart segment a lane",
                  batched_ms_per_frame=batch_ms["L"],
                  k3_int_on_lanes_ms_batched_ms_per_frame=lane_k3_ms,
                  lanes_max_abs_err=lane_err),
            relayout_entry("relayout_interleave_vec_kernel and "
                           "relayout_word_tile_kernel (P1)", "interleave",
                           "tools/exp_interleave.py:135",
                           "P1 interleave + row stack",
                           ms_transpose_ms_bound_ms_route=interleave_ms),
            relayout_entry("relayout_interleave_vec_kernel<Idx, true> and "
                           "relayout_word_tile_kernel (P2)", "swap_crop",
                           "tools/exp_swap_pallas.py:51", "P2 swap + crop",
                           ms_library_ms_bound_ms_route=swap_ms),
            relayout_entry("relayout_stack_kernel (P3)", "stack",
                           "tools/exp_assembly2.py:51", "P3 sublane stack"),
            relayout_entry("relayout_copy_vec_kernel, "
                           "relayout_spread_merge_vec_kernel and "
                           "relayout_spread_merge_kernel (P4)",
                           "spread_merge", "tools/exp_mosaic_bisect.py:23",
                           "P1 copy floor",
                           ms_clone_ms_bound_ms_route={
                               k: v for k, v in copy_ms.items()
                               if v[3] == "vec"}),
            # Its launches: the copies of the three views that take it, each
            # driven with the counts zeroed; its times one word off.
            {"name": "relayout_copy_shift_kernel (P4's copy, shift route)",
             "route": "cuda", "source": RELAYOUT_SOURCE,
             "replaces": "tools/exp_mosaic_bisect.py:23",
             "launches": shift_launches, "max_abs_err": shift_err,
             "ms": copy_ms["one word off"][0],
             "plain_ms": copy_ms["one word off"][1],
             "bound_ms": copy_ms["one word off"][2], "bound_by": "bytes",
             "library_ms": copy_ms["one word off"][1],
             "ms_clone_ms_bound_ms_route": {
                 k: v for k, v in copy_ms.items() if v[3] == "shift"}},
        ],
    }))
    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "compeg_tpu")]
    require(not leaked, f"imported {leaked[:5]}")
    log("(a) sys.modules holds neither jax nor compeg_tpu; packer=native")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
