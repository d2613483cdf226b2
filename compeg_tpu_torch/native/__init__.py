"""ctypes loader for the port's native host library, built at first use, with
a clean fallback to the pure-Python implementations in
:mod:`compeg_tpu_torch.scan` and :mod:`compeg_tpu_torch.parser`.

The library is the CPU hot loop (container parse, scan destuff/split/pack
into per-segment rows). Its sources are the port's own copies beside this
file, ``compeg_host.cpp`` and ``compeg_parse.cpp`` (from
compeg_tpu/native/); :func:`load` compiles them with the host C++ compiler
into ``build/compeg_tpu_torch/`` at the checkout root, under a file name that
carries a hash of the sources and flags, so an edit rebuilds and a stale
build is never loaded. It never loads or builds the JAX package's library.
``load()`` returns None when no compiler is available or
``COMPEG_TPU_TORCH_NO_NATIVE`` is set; callers must handle both.

Of the library's entry points the port binds what it calls: the parse, the
scanners (:func:`scan_info`, and :func:`find_scan_end`, the parser's search
for the marker that ends a scan) and the linear row packer. The
``[G, W, 8, 128]`` block packers and the raster-tiled slot permutation are
TPU layouts and are not bound.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from ..errors import bail

log = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("compeg_host.cpp", "compeg_parse.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "compeg_tpu_torch")
# The flags of compeg_tpu/native/Makefile.
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-pthread")
SEGMENTS_PER_BLOCK = 1024  # the packer's row granularity (scan.py)

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _cpu_flags() -> bytes:
    """The host CPU's feature flags: ``-march=native`` code is this CPU's,
    so a build directory carried to another machine must not be loaded."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _cpu_flags())
    for name in SOURCES:
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libcompeg_host_{h.hexdigest()[:16]}.so")


def _build(so: str) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        log.warning("native build skipped: no C++ compiler (c++, g++) found")
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", tmp,
           *(os.path.join(_DIR, name) for name in SOURCES)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:  # build env dependent
        log.warning("native build failed: %s", e)
        return False
    os.replace(tmp, so)
    return True


def load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("COMPEG_TPU_TORCH_NO_NATIVE"):
            return None
        so = library_path()
        if not os.path.exists(so) and not _build(so):
            return None
        lib = ctypes.CDLL(so)
        lib.compeg_scan_info.restype = ctypes.c_int
        lib.compeg_scan_info.argtypes = [
            ctypes.c_void_p,  # accepts bytes or a raw address (offset view)
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.compeg_parse.restype = ctypes.c_int
        lib.compeg_parse.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib.compeg_find_scan_end.restype = ctypes.c_int64
        lib.compeg_find_scan_end.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.compeg_pack_rows.restype = ctypes.c_int
        lib.compeg_pack_rows.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def _loaded() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError("the native host library is not available")
    return lib


def scan_info(
    scan, offset: int = 0, length: Optional[int] = None
) -> Tuple[int, int]:
    """(num_intervals, max_destuffed_segment_bytes) — native fast path.

    ``scan`` may be the whole file with ``offset``/``length`` selecting the
    entropy-coded span (no slice copy — the scanner is terminator-aware)."""
    lib = _loaded()
    if not isinstance(scan, bytes):
        scan = bytes(scan)  # memoryview callers without an offset
    if length is None:
        length = len(scan) - offset
    base = ctypes.cast(ctypes.c_char_p(scan), ctypes.c_void_p).value + offset
    n = ctypes.c_int64()
    mx = ctypes.c_int64()
    rc = lib.compeg_scan_info(base, length, ctypes.byref(n), ctypes.byref(mx))
    if rc != 0:
        bail(f"native scan_info failed ({rc})")
    return n.value, mx.value


def find_scan_end(data, offset: int = 0) -> int:
    """Offset (into ``data``) of the marker terminating the scan that starts
    at ``offset``: the first ``FF`` followed by a byte that is not ``00``,
    ``FF`` or RST0-7; ``len(data)`` if there is none."""
    lib = _loaded()
    if not isinstance(data, bytes):
        data = bytes(data)  # bytearray and memoryview callers
    return int(lib.compeg_find_scan_end(data, len(data), offset))


class CompegImageInfo(ctypes.Structure):
    _fields_ = [
        ("status", ctypes.c_int32),
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("precision", ctypes.c_int32),
        ("sof_marker", ctypes.c_int32),
        ("ncomp", ctypes.c_int32),
        ("comp_id", ctypes.c_int32 * 4),
        ("comp_h", ctypes.c_int32 * 4),
        ("comp_v", ctypes.c_int32 * 4),
        ("comp_q", ctypes.c_int32 * 4),
        ("comp_dc", ctypes.c_int32 * 4),
        ("comp_ac", ctypes.c_int32 * 4),
        ("has_dri", ctypes.c_int32),
        ("restart_interval", ctypes.c_int32),
        ("scan_offset", ctypes.c_int64),
        ("scan_len", ctypes.c_int64),
        ("ss", ctypes.c_int32),
        ("se", ctypes.c_int32),
        ("ah", ctypes.c_int32),
        ("al", ctypes.c_int32),
        ("qtab_present", ctypes.c_int32 * 4),
        ("qtab", (ctypes.c_int32 * 64) * 4),
        ("n_huff", ctypes.c_int32),
        ("ht_class", ctypes.c_int32 * 8),
        ("ht_dest", ctypes.c_int32 * 8),
        ("ht_nvalues", ctypes.c_int32 * 8),
        ("ht_counts", (ctypes.c_uint8 * 16) * 8),
        ("ht_values", (ctypes.c_uint8 * 256) * 8),
        ("scan_ncomp", ctypes.c_int32),
        ("scan_comp_id", ctypes.c_int32 * 4),
    ]


def parse(data: bytes) -> CompegImageInfo:
    """Native one-pass container parse. Raises CompegError on failure."""
    lib = _loaded()
    info = CompegImageInfo()
    rc = lib.compeg_parse(data, len(data), ctypes.byref(info))
    if rc != 0:
        bail(f"native parse failed (status {rc})")
    return info


def pack_rows(
    scan: bytes,
    expected: int,
    words_per_segment: int,
    num_blocks: int,
    n_threads: int = 0,
    offset: int = 0,
    length: Optional[int] = None,
    out: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Destuff + split + pack into contiguous per-segment rows
    ``[G*1024, W]`` u32, segment ``i`` in row ``i`` and the rows past
    ``expected`` zero, and the ``[G, 8, 128]`` active mask. ``scan`` may be
    the whole file with ``offset``/``length`` selecting the entropy-coded
    span (no slice copy). ``out``, a C-contiguous ``[G*1024, W]`` uint32
    array, is written in place of a new array (a pinned staging buffer)."""
    lib = _loaded()
    G, W = num_blocks, words_per_segment
    if length is None:
        length = len(scan) - offset
    shape = (G * SEGMENTS_PER_BLOCK, W)
    if out is None:
        out = np.empty(shape, dtype=np.uint32)
    elif (out.shape != shape or out.dtype != np.uint32
          or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(f"out must be a writeable C-contiguous {shape} "
                         f"uint32 array, got {out.dtype} {out.shape}")
    active = np.empty((G, 8, 128), dtype=np.int32)
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    rc = lib.compeg_pack_rows(
        scan,
        len(scan),
        offset,
        length,
        expected,
        W,
        G,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        active.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads,
        0,
        0,
        0,
    )
    if rc != 0:
        bail(f"native pack_rows failed ({rc})")
    return out, active


def available() -> bool:
    return load() is not None
