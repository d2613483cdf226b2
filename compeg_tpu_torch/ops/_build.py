"""Build and bind the hand-written CUDA kernels (the port's counterpart of
Pallas compilation).

``library()`` compiles every ``compeg_tpu_torch/csrc/*.cu`` with ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together) and links them
into one shared library with a plain C interface, at first use, and loads it
with ``ctypes``. The library's file name carries a hash of the
sources and flags, so a stale build is never loaded; it lives in
``build/compeg_tpu_torch/`` at the checkout root (gitignored).

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0, so a
refused launch (too much shared memory, a bad configuration) never passes
silently.

``LAUNCHES`` counts kernel launches per kernel. A wrapper adds one right
after its kernel was launched and nowhere else, so a caller can zero the
counts, drive the decode and see which kernels ran.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "compeg_tpu_torch")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

# One count per kernel: K1, K2, K2x, K3 (either IDCT) and K2s, then the four
# relayout kernels, the copy's shift route apart from P4's other kernels,
# the planes epilogue E and the lane index L (its kernels one launch).
# A batch of B frames is one launch and adds one.
LAUNCHES = {"entropy": 0, "fused": 0, "fused_exact": 0, "planes": 0,
            "scaled": 0, "interleave": 0, "swap_crop": 0, "stack": 0,
            "spread_merge": 0, "copy_shift": 0, "epilogue": 0, "lanes": 0}

# C entry points and their number of tensor arguments (data pointers
# before the params struct and the stream; csrc/decode.cu, csrc/relayout.cu,
# csrc/epilogue.cu).
ENTRY_POINTS = {
    "compeg_entropy_decode": 3,
    "compeg_fused_decode": 4,
    "compeg_fused_decode_exact": 4,
    "compeg_fused_decode_planes": 6,
    "compeg_fused_decode_planes_exact": 6,
    "compeg_fused_decode_scaled": 4,
    "compeg_lane_index": 4,
    "compeg_fused_decode_lanes": 5,
    "compeg_fused_decode_exact_lanes": 5,
    "compeg_fused_decode_planes_lanes": 7,
    "compeg_fused_decode_planes_exact_lanes": 7,
    "compeg_relayout_interleave": 2,
    "compeg_relayout_swap_crop": 2,
    "compeg_relayout_stack": 2,
    "compeg_relayout_spread_merge": 3,
    "compeg_planes_epilogue": 10,
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


class DecodeParams(ctypes.Structure):
    """Mirror of ``DecodeParams`` in csrc/entropy.cuh (all int32)."""

    _fields_ = [
        ("nseg", ctypes.c_int32),
        ("words", ctypes.c_int32),
        ("ri", ctypes.c_int32),
        ("total_mcus", ctypes.c_int32),
        ("dus", ctypes.c_int32),
        ("ncomp", ctypes.c_int32),
        ("du_to_comp", ctypes.c_int32 * 6),
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("width_mcus", ctypes.c_int32),
        ("rgb", ctypes.c_int32),
        ("comp_h", ctypes.c_int32 * 3),
        ("comp_v", ctypes.c_int32 * 3),
        ("comp_slot", ctypes.c_int32 * 3),
        ("zrl17", ctypes.c_int32),
        ("blk", ctypes.c_int32),
        ("zlen", ctypes.c_int32),
        ("frames", ctypes.c_int32),
        ("frame_rows", ctypes.c_int32),
        ("mcu_w", ctypes.c_int32),
        ("mcu_h", ctypes.c_int32),
        ("row_off", ctypes.c_int32 * 16),
        ("col_off", ctypes.c_int32 * 32),
        ("plane_units", ctypes.c_int32),
        ("unit_du", ctypes.c_int32 * 6),
        ("unit_pair", ctypes.c_int32 * 6),
        ("unit_row", ctypes.c_int32 * 6),
        ("unit_col", ctypes.c_int32 * 6),
        ("plane_pitch", ctypes.c_int32 * 3),
        ("ntables", ctypes.c_int32),
        ("table_of", ctypes.c_int32 * 6),
        ("bands", ctypes.c_int32),
        ("band0", ctypes.c_int32),
        ("image_mcus", ctypes.c_int32),
        ("seg_ri", ctypes.c_int32),
    ]


class RelayoutParams(ctypes.Structure):
    """Mirror of ``RelayoutParams`` in csrc/relayout.cu (all int64)."""

    _fields_ = [(name, ctypes.c_int64) for name in (
        "n", "x", "l", "in_stride", "tiles", "h", "w", "sr", "g", "vec")]


class EpilogueParams(ctypes.Structure):
    """Mirror of ``EpilogueParams`` in csrc/epilogue.cu (all int32)."""

    _fields_ = [
        ("frames", ctypes.c_int32),
        ("ncomp", ctypes.c_int32),
        ("rgb", ctypes.c_int32),
        ("fancy", ctypes.c_int32),
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("plane_h", ctypes.c_int32 * 3),
        ("plane_w", ctypes.c_int32 * 3),
        ("fx", ctypes.c_int32 * 3),
        ("fy", ctypes.c_int32 * 3),
        ("valid", ctypes.c_int32 * 3),
    ]


def make_params(nseg, words, ri, total_mcus, du_to_comp, samplings,
                width=0, height=0, width_mcus=0, rgb=False, zrl17=False,
                blk=8, zlen=64, frames=1, frame_rows=0,
                composite=None, planes=None, table_of=None,
                gate=None, seg_ri=0) -> DecodeParams:
    """The launch parameters; the frame fields are read by the fused
    kernels only, ``blk`` and ``zlen`` by the scaled one. ``nseg``,
    ``total_mcus`` and the sizes are one frame's; a batch sets ``frames``
    and ``frame_rows``, the rows between two frames' first rows.
    ``composite`` is ``(mcu_w, mcu_h, row_off, col_off)`` of
    :func:`compeg_tpu_torch.ops.fused.composite_offsets`, read by the RGBA
    kernels, ``planes`` the store units of
    :func:`compeg_tpu_torch.ops.fused.plane_offsets`, ``(du, pair, row,
    col)`` each, read by the planes kernels; the planes' pitches follow
    ``width_mcus``. ``table_of`` maps component ``c``'s DC and AC table to
    rows ``table_of[2 * c]`` and ``table_of[2 * c + 1]`` of the packed
    tables (``EntropyTables.table_of``); without it no kernel launches.
    ``gate`` is a banded launch's ``(image_mcus, bands, first)``
    (:class:`compeg_tpu_torch.ops.fused.BandGate`): frame ``f`` is band
    ``first + f % bands`` of an image of ``image_mcus`` MCUs and holds only
    its MCUs inside the image; without it every frame holds ``total_mcus``.
    ``seg_ri`` makes it a lane launch (:mod:`compeg_tpu_torch.ops.lanes`):
    ``nseg`` lanes of ``ri`` MCUs cut from restart segments of ``seg_ri``
    MCUs."""
    if not 1 <= len(du_to_comp) <= 6 or not 1 <= len(samplings) <= 3:
        raise ValueError(
            f"unsupported MCU layout: {len(du_to_comp)} data units, "
            f"{len(samplings)} components"
        )
    p = DecodeParams(
        nseg=nseg, words=words, ri=ri, total_mcus=total_mcus,
        dus=len(du_to_comp), ncomp=len(samplings), width=width,
        height=height, width_mcus=width_mcus, rgb=int(rgb),
        zrl17=int(zrl17), blk=blk, zlen=zlen, frames=frames,
        frame_rows=frame_rows, seg_ri=seg_ri,
    )
    if composite is not None:
        p.mcu_w, p.mcu_h, row_off, col_off = composite
        if len(row_off) > 16 or len(col_off) > 32:
            raise ValueError(f"MCU of {p.mcu_w} x {p.mcu_h} pixels is "
                             "larger than 32 x 16")
        p.row_off[:len(row_off)] = row_off
        p.col_off[:len(col_off)] = col_off
    if planes is not None:
        p.plane_units = len(planes)
        for i, unit in enumerate(planes):
            p.unit_du[i], p.unit_pair[i], p.unit_row[i], p.unit_col[i] = unit
        for i, (h, _) in enumerate(samplings):
            p.plane_pitch[i] = width_mcus * 8 * h
    if table_of is not None:
        if (len(table_of) != 2 * len(samplings)
                or sorted(set(table_of)) != list(range(max(table_of) + 1))):
            raise ValueError(f"table_of {tuple(table_of)} does not map "
                             f"{len(samplings)} components onto packed rows")
        p.ntables = max(table_of) + 1
        p.table_of[:len(table_of)] = table_of
    if gate is not None:
        p.image_mcus, p.bands, p.band0 = gate
        if p.bands < 1 or p.band0 < 0:
            raise ValueError(f"band gate {tuple(gate)}: bands must be at "
                             "least 1 and the first band at least 0")
    slot = 0
    for i, c in enumerate(du_to_comp):
        p.du_to_comp[i] = c
    for i, (h, v) in enumerate(samplings):
        p.comp_h[i], p.comp_v[i], p.comp_slot[i] = h, v, slot
        slot += h * v
    return p


def _sources(csrc: str = CSRC):
    return sorted(glob.glob(os.path.join(csrc, "*.cu"))), sorted(
        glob.glob(os.path.join(csrc, "*.cuh"))
    )


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME is not None:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = cand if os.path.exists(cand) else None
    if found is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME); the "
            "compeg_tpu_torch kernels are built from source at first use"
        )
    return found


def library_path(csrc: str = CSRC) -> str:
    cu, cuh = _sources(csrc)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + cuh:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libcompeg_kernels_{h.hexdigest()[:16]}.so")


def _compile(so: str, csrc: str = CSRC) -> None:
    """One ``nvcc -c`` per source, all running at once, then the link."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    cu, _ = _sources(csrc)
    stem = f"{so}.{os.getpid()}"
    objs = [f"{stem}.{os.path.basename(src)}.o" for src in cu]
    procs = [(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True), src)
             for src, obj in zip(cu, objs)]
    try:
        failed = []
        for proc, src in procs:
            log_text, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) on {src}:\n"
                              f"{log_text}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = f"{stem}.tmp"
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                f"{res.stdout}{res.stderr}"
            )
        os.replace(tmp, so)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)


def load(csrc: str = CSRC) -> ctypes.CDLL:
    """Build (unless a library of these very sources exists) and bind the
    kernel sources in ``csrc``: the package's own, or another tree with the
    same entry points that a tool wants to time beside them (an older tree
    may lack the newer ones, which are then left unbound)."""
    so = library_path(csrc)
    if not os.path.exists(so):
        _compile(so, csrc)
    lib = ctypes.CDLL(so)
    for name, npointers in ENTRY_POINTS.items():
        if csrc != CSRC and not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        # data pointers, then the params struct pointer and the stream
        fn.argtypes = [ctypes.c_void_p] * (npointers + 2)
        fn.restype = ctypes.c_int
    lib.compeg_error_string.argtypes = [ctypes.c_int]
    lib.compeg_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The kernel library, built on first use. Raises if the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load()
        return _lib


def launch(name: str, *tensors, params: ctypes.Structure,
           lib: Optional[ctypes.CDLL] = None) -> None:
    """Launch C entry point ``name`` on the current stream of the tensors'
    device (a ``None`` tensor passes a null pointer); raises with the CUDA
    error string if the launch failed. ``lib`` is a library of :func:`load`
    other than the package's own."""
    import torch

    lib = lib or library()
    dev = tensors[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = [None if t is None else t.data_ptr() for t in tensors]
    fn = getattr(lib, name)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, ctypes.byref(params), stream)
    else:  # switching the device costs more than a short kernel runs
        with torch.cuda.device(dev):
            rc = fn(*args, ctypes.byref(params), stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {rc} "
            f"({lib.compeg_error_string(rc).decode()})"
        )
