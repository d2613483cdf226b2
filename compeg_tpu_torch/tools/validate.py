"""Validation sweep of the port on the card: streams made by the port's own
encoder, decoded in every mode of the port and held to the port's golden
decoder, then a corruption soak on the compiled kernels.

    python -m compeg_tpu_torch.tools.validate                # the card, in full
    python -m compeg_tpu_torch.tools.validate --quick        # small streams, short soak
    python -m compeg_tpu_torch.tools.validate --device cpu --quick

Counterpart of the JAX package's on-chip sweep, tools/tpu_validate.py.

Streams: that tool's 13 configurations (six samplings, restart intervals
1, 2, 3, 5, 7 and none, qualities 60-90, sizes up to 128 x 256), then a
geometry grid drawn from a seed as tests/test_geometry_soak.py draws it
(9-56 x 9-72, random sampling, quality and restart interval); without
``--quick`` also bench_assets/bench4k.jpg (its golden decodes are pure
Python, tens of seconds). Every stream in every mode, each mode with the
tolerance chip_smoke.py's phase (c) applies:

    Decoder()                     golden.decode_rgb                 max |diff| 1
    exact_idct=True               golden idct="int"                 byte for byte
    zrl_compat + exact            golden zrl17=True, idct="int"     byte for byte
    decode_ycbcr (exact)          golden's planes (assemble_planes) byte for byte
    fancy_upsampling + exact      ops/color.finalize_planes_reference
                                  over golden's integer planes      byte for byte
    decode_scaled(k), k = 1, 2, 4 golden scale_blocks=k             max |diff| 1
    fused=False                   golden                            max |diff| 1
    fused=False, exact            golden idct="int"                 byte for byte

and for frames of a few grid geometries (three pictures each), a
BatchDecoder and a StreamDecoder batch equal to each frame's single decode.

A float decode (the default and fused=False) that is off by more than 1 at a
sample passes only where it equals the reference's own float arithmetic
there (golden's ``idct="aan"``, the jidctflt model): golden's matrix IDCT
(a numpy einsum) rounds in another order than the kernels, PyTorch's or
XLA's matrix products, and one chroma sample rounded the other way moves R
or B by 2 after BT.601 (PARITY.md, "IDCT arithmetic"; ROADMAP queue 3 has
the stream where it shows).

The soak (tests/test_device_soak.py, tests/test_robustness.py) on a 16 x 32
stream: garbage entropy bits (every scan byte random but the markers) at 4:2:2
with the float IDCT and at 4:2:0 exact, each decode of the right shape with
alpha 255 and every tenth decoded twice to the same bytes; unconstrained scan
bytes, each an error (CompegError) or a decode of the right shape, and at
least one error; single-byte header mutations, each either refused by the
parser with CompegError or decoded to the header's shape or refused with
CompegError. Any other exception is a failure.

Prints one line per check (OK or FAIL, stream, mode, max |diff|, samples off
by more than 1), then ALL OK or the count of failures, then one JSON line;
exits 1 on any failure. It runs on the card unless ``--device cpu`` asks for
the plain versions, and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
import zlib
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import encoder, golden, testdata
from ..batch import BatchDecoder, StreamDecoder
from ..errors import CompegError
from ..metadata import analyze
from ..ops import color as C
from ..ops import fused as F
from ..pipeline import Decoder

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "bench_assets", "bench4k.jpg")

# tools/tpu_validate.py's configurations: sampling, restart interval,
# quality, (height, width).
CONFIGS = [
    ("422", 1, 90, (64, 128)),
    ("422", 3, 75, (72, 96)),
    ("422", 7, 85, (128, 256)),
    ("444", 1, 90, (64, 64)),
    ("444", 2, 60, (48, 80)),
    ("420", 1, 85, (64, 64)),
    ("420", 5, 85, (96, 128)),
    ("gray", 1, 85, (40, 72)),
    ("440", 1, 85, (64, 64)),
    ("440", 3, 75, (96, 80)),
    ("411", 1, 85, (64, 128)),
    ("411", 2, 90, (48, 192)),
    ("422", None, 80, (32, 32)),  # no DRI: one interval
]
SAMPLINGS = ["422", "420", "444", "440", "411", "gray"]
GRID_SEED = 20260820  # tests/test_geometry_soak.py's
SCALES = (1, 2, 4)
# The run's size, in full and with --quick: geometries of the grid,
# garbage-bit seeds a mode, single-byte header mutations.
SIZES = {False: (48, 200, 200), True: (16, 20, 40)}


def img_of(h: int, w: int, seed: int) -> np.ndarray:
    """tools/tpu_validate.py's picture: gradients with noise."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx * 3 + yy * 5) % 256], axis=-1)
    return np.clip(base + r.integers(0, 24, base.shape), 0, 255).astype(
        np.uint8)


def noise_of(h: int, w: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(
        np.uint8)


def gradient_of(h: int, w: int) -> np.ndarray:
    """The soak's picture (tests/conftest.py's "gradient")."""
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 255 // max(h + w - 2, 1)],
                    axis=-1).astype(np.uint8)


def grid(n: int, seed: int = GRID_SEED) -> list:
    """``n`` geometries (h, w, sampling, quality, ri), drawn as
    tests/test_geometry_soak.py draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h = int(rng.integers(9, 57))
        w = int(rng.integers(9, 73))
        sampling = SAMPLINGS[int(rng.integers(0, len(SAMPLINGS)))]
        quality = int(rng.integers(35, 98))
        ri = [None, 1, 2, 3, 5][int(rng.integers(0, 5))]
        out.append((h, w, sampling, quality, ri))
    return out


def streams(grid_n: int) -> List[tuple]:
    """``(name, jpeg)`` of the configurations and of a grid of ``grid_n``
    geometries."""
    out = []
    for sampling, ri, q, (h, w) in CONFIGS:
        seed = zlib.crc32(f"{sampling} {ri}".encode()) & 0xFFFF
        out.append((f"{sampling} ri={ri} q={q} {h}x{w}", encoder.encode(
            img_of(h, w, seed), sampling=sampling, quality=q,
            restart_interval_mcus=ri)))
    for h, w, sampling, q, ri in grid(grid_n):
        out.append((f"grid {sampling} ri={ri} q={q} {h}x{w}", encoder.encode(
            noise_of(h, w, h * 1000 + w), sampling=sampling, quality=q,
            restart_interval_mcus=ri)))
    return out


class Report:
    """The checks' lines and their failures."""

    def __init__(self):
        self.checks = 0
        self.failures: List[str] = []

    def line(self, ok: bool, stream: str, mode: str, text: str) -> bool:
        self.checks += 1
        status = "OK  " if ok else "FAIL"
        msg = f"{status} {stream:<28} {mode:<24} {text}"
        print(msg, flush=True)
        if not ok:
            self.failures.append(msg)
        return ok

    def compare(self, stream: str, mode: str, got, want, tol: int,
                aan: Optional[Callable[[], np.ndarray]] = None) -> bool:
        """``got`` within ``tol`` of ``want`` (arrays, or lists of them),
        shapes equal. With ``aan`` (a float decode: ``want`` is golden's
        matrix IDCT), a sample further off passes where it equals
        ``aan()``, the reference's own float arithmetic, at that sample."""
        got = got if isinstance(got, list) else [got]
        want = want if isinstance(want, list) else [want]
        if len(got) != len(want) or any(
                np.shape(g) != np.shape(w) for g, w in zip(got, want)):
            return self.line(False, stream, mode, "shape "
                             f"{[np.shape(g) for g in got]} != "
                             f"{[np.shape(w) for w in want]}")
        d = [np.abs(np.asarray(g).astype(np.int32)
                    - np.asarray(w).astype(np.int32)) for g, w in
             zip(got, want)]
        worst = max(int(x.max()) if x.size else 0 for x in d)
        over = sum(int((x > 1).sum()) for x in d)
        text = f"max|diff| {worst}  >1: {over}"
        if worst > tol and aan is not None:
            off = d[0] > tol
            ref = aan()
            if np.array_equal(np.asarray(got[0])[off], ref[off]):
                return self.line(True, stream, mode, text + " (each of them "
                                 "= the reference's AAN arithmetic)")
            text += " (not the reference's AAN arithmetic either)"
        return self.line(worst <= tol, stream, mode, text)

    def run(self, stream: str, mode: str, fn: Callable[[], object]):
        """fn(), or None with a FAIL line where it raises."""
        try:
            return fn()
        except Exception as e:  # a crash is a finding, not the end
            self.line(False, stream, mode, f"raised {type(e).__name__}: {e}")
            traceback.print_exc(file=sys.stdout)
            return None

    def check(self, stream, mode, fn, want, tol, aan=None):
        got = self.run(stream, mode, fn)
        if got is not None:
            self.compare(stream, mode, got, want, tol, aan)


def reference_arithmetic(data: bytes) -> Callable[[], np.ndarray]:
    """golden.decode_rgb(data, idct="aan"), the reference's own float IDCT
    (jidctflt, operation for operation), computed at the first call."""
    cache = []

    def aan():
        if not cache:
            cache.append(golden.decode_rgb(data, idct="aan"))
        return cache[0]
    return aan


def planes_rgb(planes, img) -> np.ndarray:
    """Fancy upsampling and colour (ops/color.finalize_planes_reference, the
    planes epilogue's plain twin) over u8 component planes on the CPU, as
    RGB."""
    samplings = [(c.h_sample, c.v_sample) for c in img.components]
    out = C.finalize_planes_reference(
        [torch.from_numpy(p) for p in planes], samplings, img.width,
        img.height, fancy=True, rgb=img.color_space == "rgb")
    return F.rgba_to_rgb(out).numpy()


def crop_planes(planes, img) -> list:
    """Golden's MCU-padded planes cropped as ``decode_ycbcr`` crops them."""
    return [p[:-(-img.height * c.v_sample // img.max_v),
              :-(-img.width * c.h_sample // img.max_h)]
            for p, c in zip(planes, img.components)]


def validate_stream(rep: Report, name: str, data: bytes, device) -> None:
    """One stream in every mode of the port against the golden decoder."""
    img = analyze(data)
    want = golden.decode_rgb(data)
    want_int = golden.decode_rgb(data, idct="int")
    aan = reference_arithmetic(data)
    rep.check(name, "Decoder()", lambda: Decoder(device=device).decode(data),
              want, 1, aan)
    rep.check(name, "exact_idct",
              lambda: Decoder(device=device, exact_idct=True).decode(data),
              want_int, 0)
    rep.check(name, "zrl_compat + exact",
              lambda: Decoder(device=device, exact_idct=True,
                              zrl_compat=True).decode(data),
              golden.decode_rgb(data, zrl17=True, idct="int"), 0)
    planes = golden.assemble_planes(img, golden.idct_pixels_int(
        golden.decode_coefficients(img, dequant=False), img))
    rep.check(name, "decode_ycbcr (exact)",
              lambda: Decoder(device=device, exact_idct=True)
              .decode_ycbcr(data), crop_planes(planes, img), 0)
    rep.check(name, "fancy + exact",
              lambda: Decoder(device=device, exact_idct=True,
                              fancy_upsampling=True).decode(data),
              planes_rgb(planes, img), 0)
    scaler = Decoder(device=device)
    for k in SCALES:
        rep.check(name, f"decode_scaled({k})",
                  lambda: scaler.decode_scaled(data, k),
                  golden.decode_rgb(data, scale_blocks=k), 1)
    rep.check(name, "fused=False",
              lambda: Decoder(device=device, fused=False).decode(data),
              want, 1, aan)
    rep.check(name, "fused=False, exact",
              lambda: Decoder(device=device, fused=False,
                              exact_idct=True).decode(data), want_int, 0)


def validate_group(rep: Report, geometry, device) -> None:
    """Three pictures of one geometry through a BatchDecoder (float and
    exact) and a StreamDecoder, each frame equal to its single decode."""
    h, w, sampling, q, ri = geometry
    name = f"batch {sampling} ri={ri} q={q} {h}x{w}"
    frames = [encoder.encode(noise_of(h, w, 7 * h + w + i), sampling=sampling,
                             quality=q, restart_interval_mcus=ri)
              for i in range(3)]
    for exact in (False, True):
        one = Decoder(device=device, exact_idct=exact)
        singles = rep.run(name, "Decoder() of each frame",
                          lambda: [one.decode(f) for f in frames])
        if singles is None:
            continue
        got = rep.run(name, "BatchDecoder", lambda: BatchDecoder(
            device=device, exact_idct=exact).decode(frames))
        if got is not None:
            rep.compare(name, "BatchDecoder" + (", exact" if exact else ""),
                        list(got), singles, 0)
        if not exact:
            got = rep.run(name, "StreamDecoder", lambda: list(StreamDecoder(
                device=device, prepare_threads=2).decode_iter_rgb(frames)))
            if got is not None:
                rep.compare(name, "StreamDecoder", got, singles, 0)


def validate_4k(rep: Report, device) -> None:
    """bench_assets/bench4k.jpg against the golden decoder, default and
    exact (its two golden decodes are pure Python: tens of seconds)."""
    with open(BENCH, "rb") as f:
        data = f.read()
    name = "bench4k 3840x2160 422 ri=1"
    t0 = time.perf_counter()
    want = golden.decode_rgb(data)
    rep.check(name, "Decoder()", lambda: Decoder(device=device).decode(data),
              want, 1, reference_arithmetic(data))
    del want
    rep.check(name, "exact_idct",
              lambda: Decoder(device=device, exact_idct=True).decode(data),
              golden.decode_rgb(data, idct="int"), 0)
    print(f"     (bench4k: {time.perf_counter() - t0:.1f} s, most of it the "
          "golden decodes)", flush=True)


def unconstrained_scan(data: bytes, img, seed: int) -> bytes:
    """Every scan byte random, markers included (tests/test_device_soak.py's
    ``allow_markers=True``)."""
    n = len(img.scan_data)
    noise = np.random.default_rng(1000 + seed).integers(0, 256, n,
                                                        dtype=np.uint8)
    return data[:img.scan_offset] + noise.tobytes() + data[
        img.scan_offset + n:]


def soak(rep: Report, device, seeds: int, unconstrained: int,
         mutations: int) -> dict:
    """The corruption soak on the compiled kernels (or the plain versions
    on the CPU); returns its counts."""
    counts = {}
    for sampling, exact in (("422", False), ("420", True)):
        name = f"soak 16x32 {sampling} ri=2"
        mode = f"garbage bits x{seeds}" + (", exact" if exact else "")
        data = encoder.encode(gradient_of(16, 32), sampling=sampling,
                              quality=80, restart_interval_mcus=2)
        img = analyze(data)
        dec = Decoder(device=device, exact_idct=exact)
        bad_shape, unequal, opaque = [], 0, True

        def run():
            nonlocal unequal, opaque
            for seed in range(seeds):
                bad = testdata.garbage_scan(data, img.scan_offset,
                                            len(img.scan_data), seed)
                out = dec.decode_rgba(bad)
                if out.shape != (16, 32, 4) or out.dtype != np.uint8:
                    bad_shape.append((seed, out.shape))
                    continue
                opaque &= bool((out[..., 3] == 255).all())
                if seed % 10 == 0:
                    unequal += not np.array_equal(out, dec.decode_rgba(bad))
            return True

        if rep.run(name, mode, run):
            rep.line(not bad_shape and not unequal and opaque, name, mode,
                     f"wrong shapes {bad_shape[:3]}, twice unequal {unequal}, "
                     f"alpha 255 {opaque}")
        counts[f"garbage_{sampling}"] = seeds

    name = "soak 16x32 422 ri=1"
    data = encoder.encode(gradient_of(16, 32), sampling="422", quality=80,
                          restart_interval_mcus=1)
    img = analyze(data)
    dec = Decoder(device=device)
    errors, decoded, wrong = 0, 0, []
    mode = f"scan bytes x{unconstrained}"
    for seed in range(unconstrained):
        bad = unconstrained_scan(data, img, seed)
        try:
            out = dec.decode(bad)
        except CompegError:
            errors += 1
            continue
        except Exception as e:
            rep.line(False, name, mode, f"seed {seed} raised "
                     f"{type(e).__name__}: {e}")
            continue
        decoded += 1
        if out.shape != (16, 32, 3):
            wrong.append((seed, out.shape))
    rep.line(errors > 0 and not wrong, name, mode,
             f"CompegError {errors}, decoded {decoded}, wrong shapes "
             f"{wrong[:3]}")
    counts.update(unconstrained=unconstrained, unconstrained_errors=errors)

    rng = np.random.default_rng(1234)
    hdr = img.scan_offset
    dec = Decoder(device=device)
    refused = parsed = decoded = 0
    mode = f"header bytes x{mutations}"
    bad_cases = []
    for i in range(mutations):
        pos = int(rng.integers(0, hdr))
        val = int(rng.integers(0, 256))
        bad = data[:pos] + bytes([val]) + data[pos + 1:]
        try:
            head = analyze(bad)
        except CompegError:
            refused += 1
            continue
        except Exception as e:
            bad_cases.append(f"byte {pos} = {val}: analyze raised "
                             f"{type(e).__name__}: {e}")
            continue
        parsed += 1
        try:
            out = dec.decode(bad)
        except CompegError:
            continue
        except Exception as e:
            bad_cases.append(f"byte {pos} = {val}: decode raised "
                             f"{type(e).__name__}: {e}")
            continue
        decoded += 1
        if out.shape != (head.height, head.width, 3):
            bad_cases.append(f"byte {pos} = {val}: shape {out.shape}, "
                             f"header {head.height}x{head.width}")
    for case in bad_cases[:5]:
        print(f"     {case}", flush=True)
    rep.line(not bad_cases, name, mode,
             f"refused by the parser {refused}, parsed {parsed}, decoded "
             f"{decoded}, faults {len(bad_cases)}")
    counts.update(header_mutations=mutations, header_refused=refused,
                  header_parsed=parsed, header_decoded=decoded)
    return counts


def card_name() -> Optional[str]:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--quick", action="store_true",
                    help="no 4K frame, a short soak")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("validate: no CUDA device (pass --device cpu for the plain "
              "versions)", flush=True)
        return 1
    device = torch.device(args.device)
    grid_n, seeds, mutations = SIZES[args.quick]
    card = card_name() if device.type == "cuda" else None
    where = (f"{torch.cuda.get_device_name(0)} ({card})"
             if device.type == "cuda" else "cpu (the plain versions)")
    print(f"validate on {where}: {len(CONFIGS)} configurations, a grid of "
          f"{grid_n}, soak of {seeds} seeds", flush=True)
    t0 = time.perf_counter()
    rep = Report()
    todo = streams(grid_n)
    for name, data in todo:
        validate_stream(rep, name, data, device)
    for geometry in grid(grid_n)[:max(1, min(4, grid_n // 4))]:
        validate_group(rep, geometry, device)
    if not args.quick:
        validate_4k(rep, device)
    counts = soak(rep, device, seeds, max(10, seeds // 2), mutations)
    seconds = time.perf_counter() - t0
    print("ALL OK" if not rep.failures else
          f"{len(rep.failures)} FAILURES", flush=True)
    print(json.dumps({
        "tool": "compeg_tpu_torch.tools.validate", "device": where,
        "ok": not rep.failures, "checks": rep.checks,
        "failures": len(rep.failures), "streams": len(todo),
        "bench4k": not args.quick, "soak": counts,
        "seconds": round(seconds, 3)}), flush=True)
    return 1 if rep.failures else 0


if __name__ == "__main__":
    sys.exit(main())
