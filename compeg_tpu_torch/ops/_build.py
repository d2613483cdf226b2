"""Build and bind the hand-written CUDA kernels (the port's counterpart of
Pallas compilation).

``library()`` compiles every ``compeg_tpu_torch/csrc/*.cu`` with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, at first use,
and loads it with ``ctypes``. The library's file name carries a hash of the
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
    "-shared", "-Xcompiler", "-fPIC",
)

# One count per kernel: K1, K2, K2x, K3 (either IDCT) and K2s.
LAUNCHES = {"entropy": 0, "fused": 0, "fused_exact": 0, "planes": 0,
            "scaled": 0}

# C entry points and their number of tensor arguments (data pointers
# before the params struct and the stream; csrc/decode.cu).
ENTRY_POINTS = {
    "compeg_entropy_decode": 3,
    "compeg_fused_decode": 4,
    "compeg_fused_decode_exact": 4,
    "compeg_fused_decode_planes": 6,
    "compeg_fused_decode_planes_exact": 6,
    "compeg_fused_decode_scaled": 4,
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
    ]


def make_params(nseg, words, ri, total_mcus, du_to_comp, samplings,
                width=0, height=0, width_mcus=0, rgb=False, zrl17=False,
                blk=8, zlen=64) -> DecodeParams:
    """The launch parameters; the frame fields are read by the fused
    kernels only, ``blk`` and ``zlen`` by the scaled one."""
    if not 1 <= len(du_to_comp) <= 6 or not 1 <= len(samplings) <= 3:
        raise ValueError(
            f"unsupported MCU layout: {len(du_to_comp)} data units, "
            f"{len(samplings)} components"
        )
    p = DecodeParams(
        nseg=nseg, words=words, ri=ri, total_mcus=total_mcus,
        dus=len(du_to_comp), ncomp=len(samplings), width=width,
        height=height, width_mcus=width_mcus, rgb=int(rgb),
        zrl17=int(zrl17), blk=blk, zlen=zlen,
    )
    slot = 0
    for i, c in enumerate(du_to_comp):
        p.du_to_comp[i] = c
    for i, (h, v) in enumerate(samplings):
        p.comp_h[i], p.comp_v[i], p.comp_slot[i] = h, v, slot
        slot += h * v
    return p


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))), sorted(
        glob.glob(os.path.join(CSRC, "*.cuh"))
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


def library_path() -> str:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + cuh:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libcompeg_kernels_{h.hexdigest()[:16]}.so")


def library() -> ctypes.CDLL:
    """The kernel library, built on first use. Raises if the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cu, _ = _sources()
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                    f"{res.stdout}{res.stderr}"
                )
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        for name, npointers in ENTRY_POINTS.items():
            fn = getattr(lib, name)
            # data pointers, then the params struct pointer and the stream
            fn.argtypes = [ctypes.c_void_p] * (npointers + 2)
            fn.restype = ctypes.c_int
        lib.compeg_error_string.argtypes = [ctypes.c_int]
        lib.compeg_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def launch(name: str, *tensors, params: DecodeParams) -> None:
    """Launch C entry point ``name`` on the current stream of the tensors'
    device (a ``None`` tensor passes a null pointer); raises with the CUDA
    error string if the launch failed."""
    import torch

    lib = library()
    dev = tensors[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = getattr(lib, name)(
            *[None if t is None else t.data_ptr() for t in tensors],
            ctypes.byref(params), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {rc} "
            f"({lib.compeg_error_string(rc).decode()})"
        )
