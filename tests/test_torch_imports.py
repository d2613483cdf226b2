"""The port stands on its own: nothing under compeg_tpu_torch/ and not
chip_smoke.py imports jax or anything of the JAX package ``compeg_tpu``, not
even a module there that is free of jax. A fresh interpreter shows it at run
time, a scan of the sources statically."""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from compeg_tpu import encoder  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SOURCES = sorted(
    glob.glob(os.path.join(ROOT, "compeg_tpu_torch", "**", "*.py"),
              recursive=True)) + [os.path.join(ROOT, "chip_smoke.py")]
FORBIDDEN = ("jax", "jaxlib", "compeg_tpu")

PROBE = r"""
import sys
import numpy as np
import compeg_tpu_torch as T
from compeg_tpu_torch import native
from compeg_tpu_torch.tools import exp_relayout, validate
from compeg_tpu_torch import mjpeg, v4l2
from compeg_tpu_torch.parallel import multihost, sharding
from compeg_tpu_torch.tools import dryrun_multiproc, enc, viewer
from compeg_tpu_torch.tools import (bench, bench_host, bench_scaling,
                                    bench_stream, trace_ops, trace_sharded)
data = np.load(sys.argv[1]).tobytes()
assert T.encoder.encode(np.zeros((8, 8, 3), np.uint8), sampling="444")
assert T.golden.decode_rgb(data).shape == (16, 24, 3)
outs = [T.Decoder(device="cpu").decode(data),
        T.Decoder(device="cpu", exact_idct=True, fancy_upsampling=True).decode(data),
        T.BatchDecoder(device="cpu").decode([data, data])[1],
        next(T.StreamDecoder(device="cpu", prepare_threads=2).decode_iter_rgb([data]))]
assert all(o.shape == (16, 24, 3) for o in outs), [o.shape for o in outs]
assert native.available() and "compeg_tpu_torch" in native.library_path()
assert all(r["ok"] for r in exp_relayout.probes("cpu", groups=1))
assert list(mjpeg.split_frames(data * 2)) == [data, data]
assert T.decode_scaled(data, 2, device="cpu").shape == (4, 6, 3)
sharding.dryrun(1, device="cpu")
segments = bench_host.counts(data)["segments"]
assert segments == T.analyze(data).total_restart_intervals
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "compeg_tpu"))
assert not bad, bad
print("ok")
"""


def test_fresh_process_imports_neither_jax_nor_the_jax_package(tmp_path):
    img = (np.arange(16 * 24 * 3) % 251).astype(np.uint8).reshape(16, 24, 3)
    data = encoder.encode(img, sampling="420", restart_interval_mcus=1)
    path = tmp_path / "frame.npy"
    np.save(path, np.frombuffer(data, np.uint8))
    res = subprocess.run([sys.executable, "-c", PROBE, str(path)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "ok"


def imported_roots(path):
    """Top-level names of every absolute import in ``path`` (relative
    imports stay inside the port)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=[os.path.relpath(p, ROOT) for p in PORT_SOURCES])
def test_source_imports_nothing_of_jax_or_the_jax_package(path):
    bad = [(name, line) for name, line in imported_roots(path)
           if name in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_the_scan_covers_the_whole_port():
    names = {os.path.relpath(p, ROOT) for p in PORT_SOURCES}
    for must in ("compeg_tpu_torch/__init__.py", "compeg_tpu_torch/batch.py",
                 "compeg_tpu_torch/native/__init__.py",
                 "compeg_tpu_torch/ops/relayout.py",
                 "compeg_tpu_torch/tools/exp_relayout.py",
                 "compeg_tpu_torch/golden.py", "compeg_tpu_torch/encoder.py",
                 "compeg_tpu_torch/tools/validate.py",
                 "compeg_tpu_torch/mjpeg.py", "compeg_tpu_torch/v4l2.py",
                 "compeg_tpu_torch/parallel/__init__.py",
                 "compeg_tpu_torch/parallel/sharding.py",
                 "compeg_tpu_torch/parallel/multihost.py",
                 "compeg_tpu_torch/tools/viewer.py",
                 "compeg_tpu_torch/tools/enc.py",
                 "compeg_tpu_torch/tools/dryrun_multiproc.py",
                 "compeg_tpu_torch/tools/_common.py",
                 "compeg_tpu_torch/tools/bench.py",
                 "compeg_tpu_torch/tools/bench_host.py",
                 "compeg_tpu_torch/tools/bench_stream.py",
                 "compeg_tpu_torch/tools/bench_scaling.py",
                 "compeg_tpu_torch/tools/trace_ops.py",
                 "compeg_tpu_torch/tools/trace_sharded.py",
                 "chip_smoke.py"):
        assert must in names, must


def test_the_native_sources_are_the_ports_own():
    """The port builds its own copies of the C++ sources, byte for byte the
    JAX package's, into build/compeg_tpu_torch/."""
    from compeg_tpu_torch import native

    for name in native.SOURCES:
        with open(os.path.join(ROOT, "compeg_tpu_torch", "native", name),
                  "rb") as f, open(os.path.join(ROOT, "compeg_tpu", "native",
                                                name), "rb") as g:
            assert f.read() == g.read(), name
    assert os.path.dirname(native.library_path()) == os.path.join(
        ROOT, "build", "compeg_tpu_torch")
