"""Smoke run of compeg_tpu_torch on one CUDA card: build, check, time.

    python3 chip_smoke.py

Builds the port's CUDA kernels from compeg_tpu_torch/csrc with nvcc, checks
them against their plain PyTorch versions and against the golden decoder's
answers on small streams of every supported sampling and on the 4K benchmark
frame, drives the main path (``Decoder().decode``) with the launch counters
zeroed, checks that garbage entropy bits terminate, and times the kernels
against their plain versions. Any failure exits non-zero. The last three
lines are the kernels JSON, the card's nvidia-smi name and power limit, and
the result JSON. Needs one CUDA device.

It imports compeg_tpu_torch (which reuses compeg_tpu's jax-free host
modules) and no jax, and runs no golden or encoder code: golden's answers
come from compeg_tpu_torch/testdata/smoke.npz, which
tests/test_torch_smoke_vectors.py writes and checks on the CPU.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.join(ROOT, "bench_assets", "bench4k.jpg")
REPS = 20


def log(*args):
    print(*args, flush=True)


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


def cuda_ms(fn, reps=REPS, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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


def main() -> int:
    import torch

    # ---- (a) the card -------------------------------------------------------
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; needs a CUDA card")
        return 1
    sys.path.insert(0, ROOT)
    from compeg_tpu_torch import testdata
    from compeg_tpu_torch.ops import _build
    from compeg_tpu_torch.ops import entropy as E
    from compeg_tpu_torch.ops import fused as F
    from compeg_tpu_torch.pipeline import Decoder

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
        k2 = F.fused_decode_rgba(rows, pf.nseg, pf.tables, pf.lq_t, g)
        plain = F.fused_decode_rgba_reference(rows, pf.nseg, pf.tables,
                                              pf.lq_t, g)
        alpha_ok = bool(((k2.cpu().numpy() >> 24) & 0xFF == 0xFF).all())
        return (pf, rows, k1, k1_err, F.rgba_to_rgb(k2).cpu().numpy(),
                F.rgba_to_rgb(plain).cpu().numpy(), alpha_ok)

    # ---- (c) small streams ---------------------------------------------------
    vec = testdata.load()
    for i, label in enumerate(vec["labels"]):
        _, _, k1, k1_err, k2_rgb, plain_rgb, alpha_ok = kernels_and_plain(
            vec[f"jpeg_{i}"].tobytes(), int(vec["retained"][i]))
        want = vec[f"coeffs_{i}"]
        if k1.shape != want.shape or not np.array_equal(k1, want) or k1_err:
            raise AssertionError(f"{label}: K1 coefficients differ from golden "
                                 f"(max |diff| from plain K1: {k1_err})")
        vs_plain = pixel_stats(k2_rgb, plain_rgb)
        vs_golden = pixel_stats(k2_rgb, vec[f"rgb_{i}"])
        log(f"(c) {label}: K1 == golden == plain K1; K2 vs plain max "
            f"{vs_plain[0]}, vs golden max {vs_golden[0]} (tolerance: max 1)")
        if vs_plain[0] > 1 or vs_golden[0] > 1 or not alpha_ok:
            raise AssertionError(f"{label}: K2 outside +-1 (plain {vs_plain}, "
                                 f"golden {vs_golden}, alpha {alpha_ok})")

    # ---- (d) the 4K frame ----------------------------------------------------
    # Golden's answers for it: the digests of its coefficients and RGB, and
    # its RGB on three MCU rows. The full frame is held to the plain K2.
    with open(BENCH, "rb") as f:
        data4k = f.read()
    if hashlib.sha256(data4k).hexdigest() != str(vec["bench4k_jpeg_sha256"]):
        raise AssertionError(f"{BENCH} is not the frame of {testdata.PATH}")
    pf, rows4k, k1, k1_err, k2_rgb, plain4k, alpha_ok = kernels_and_plain(
        data4k)
    if testdata.digest(k1) != str(vec["bench4k_coeffs_sha256"]) or k1_err:
        raise AssertionError(f"4K: K1 coefficients differ from golden's "
                             f"(max |diff| from plain K1: {k1_err})")
    rows = vec["bench4k_rows"]
    golden_rows = vec["bench4k_rgb_rows"]
    vs_plain = pixel_stats(k2_rgb, plain4k)
    log(f"(d) 4K: {pf.nseg} segments of {pf.rows.shape[1]} words; K1 == "
        f"golden coefficients (sha256) == plain K1; K2 vs plain max "
        f"{vs_plain[0]}, frac>1 {vs_plain[1]:.3g} (tolerance: K1 exact; "
        f"max 2, frac>1 <= 1e-5)")
    dec = Decoder()
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
    rgb = dec.decode(data4k)  # the main path
    launches = dict(_build.LAUNCHES)
    log(f"(d) Decoder().decode(bench4k) launches: {launches}")
    if launches["fused"] < 1:
        raise AssertionError("the main path did not launch the fused kernel")
    if rgb.shape != plain4k.shape:
        raise AssertionError(f"4K: decode() gave {rgb.shape}, "
                             f"not {plain4k.shape}")
    checks = {
        "K2 vs plain K2": vs_plain,
        "decode() vs plain K2": pixel_stats(rgb, plain4k),
        "decode() vs golden rows": pixel_stats(rgb[rows], golden_rows),
        "plain K2 vs golden rows": pixel_stats(plain4k[rows], golden_rows),
    }
    for name, (mx, frac) in checks.items():
        log(f"(d) {name}: max {mx}, frac>1 {frac:.3g}")
    same = testdata.digest(rgb) == str(vec["bench4k_rgb_sha256"])
    log(f"(d) decode() bit-identical to golden.decode_rgb (sha256): {same}")
    if not alpha_ok or any(mx > 2 or frac > 1e-5
                           for mx, frac in checks.values()):
        raise AssertionError("4K decode outside the PARITY.md envelope")

    # ---- (e) garbage entropy bits terminate ---------------------------------
    img = pf.image
    off = img.scan_offset
    scan = np.frombuffer(data4k[off:off + len(img.scan_data)], np.uint8).copy()
    keep = scan == 0xFF
    keep[1:] |= keep[:-1]  # every FF and the byte after it (RST, stuffing)
    noise = np.random.default_rng(5).integers(0, 255, scan.size, dtype=np.uint8)
    scan[~keep] = noise[~keep]
    garbage = data4k[:off] + scan.tobytes() + data4k[off + scan.size:]
    gdec = Decoder()
    gpf = gdec.prepare(garbage)
    grows = gdec.upload(gpf)
    g = gpf.geom
    t0 = time.perf_counter()
    gk1 = E.entropy_decode(grows, gpf.nseg, gpf.tables, g.ri, g.total_mcus,
                           g.du_to_comp)
    gk2 = F.fused_decode_rgba(grows, gpf.nseg, gpf.tables, gpf.lq_t, g)
    torch.cuda.synchronize()
    log(f"(e) garbage bits: both kernels returned in "
        f"{time.perf_counter() - t0:.3f} s; K2 {tuple(gk2.shape)}")
    gref = E.entropy_decode_reference(grows, gpf.nseg, gpf.tables, g.ri,
                                      g.total_mcus, g.du_to_comp)
    if not torch.equal(gk1, gref) or tuple(gk2.shape) != (g.height, g.width):
        raise AssertionError("garbage bits: K1 differs from its plain version")
    log("(e) garbage bits: K1 == plain K1")

    # ---- (f) times -----------------------------------------------------------
    g = pf.geom
    k2_ms = cuda_ms(lambda: F.fused_decode_rgba(rows4k, pf.nseg, pf.tables,
                                                pf.lq_t, g))
    k1_ms = cuda_ms(lambda: E.entropy_decode(rows4k, pf.nseg, pf.tables, g.ri,
                                             g.total_mcus, g.du_to_comp))
    plain_ms = cuda_ms(lambda: F.fused_decode_rgba_reference(
        rows4k, pf.nseg, pf.tables, pf.lq_t, g), warmup=1)
    plain_k1_ms = cuda_ms(lambda: E.entropy_decode_reference(
        rows4k, pf.nseg, pf.tables, g.ri, g.total_mcus, g.du_to_comp),
        warmup=1)
    prep_ms = wall_ms(lambda: dec.prepare(data4k))
    h2d_ms = wall_ms(lambda: dec.upload(pf))
    out4k = F.fused_decode_rgba(rows4k, pf.nseg, pf.tables, pf.lq_t, g)
    d2h_ms = wall_ms(lambda: F.rgba_to_rgb(out4k).cpu())
    dec_ms = wall_ms(lambda: dec.decode(data4k))
    for name, v in (("K2 fused_decode_rgba", k2_ms), ("K1 entropy_decode", k1_ms),
                    ("plain K2", plain_ms), ("plain K1", plain_k1_ms)):
        log(f"(f) {name} at 4K: {v:.4f} ms (median of {REPS} CUDA-event "
            f"timings) on {card}")
    log(f"(f) prepare {prep_ms:.3f} ms, H2D {h2d_ms:.3f} ms "
        f"({pf.rows[:pf.nseg].nbytes} B), RGB readback {d2h_ms:.3f} ms, "
        f"decode() {dec_ms:.3f} ms wall "
        f"(median of {REPS}) on {card}; packer {pf.packer}")

    source = "compeg_tpu_torch/csrc/decode.cu"
    log(json.dumps({
        "kernels": [{
            "name": "fused_decode_kernel", "route": "cuda", "source": source,
            "replaces": "compeg_tpu/ops/fused.py:419",
            "launches": launches["fused"], "max_abs_err": vs_plain[0],
            "ms": k2_ms, "plain_ms": plain_ms,
        }],
        # Ported, but not on Decoder().decode's path.
        "off_path_kernels": [{
            "name": "entropy_kernel", "route": "cuda", "source": source,
            "replaces": "compeg_tpu/ops/entropy.py:440",
            "launches": launches["entropy"], "max_abs_err": k1_err,
            "ms": k1_ms, "plain_ms": plain_k1_ms,
        }],
    }))
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
    if leaked:
        raise AssertionError(f"imported {leaked[:5]}")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
