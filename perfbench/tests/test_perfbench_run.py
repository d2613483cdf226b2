"""Whole runs of the harness: with no card the command exits non-zero and
prints no result; in a directory that holds only the benchmark it fails;
the import rule holds by whole top-level names; a new traffic mix and a new
metric are found by name; every cell runs on the CPU at a small size."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench.harness import bench

from .small import CELLS, run_small

ROOT = os.path.dirname(bench.PERFBENCH)


def command(cwd, *extra):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "cam1080_420_exact_fancy.oneshot", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_no_card_exits_nonzero_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    res = command(ROOT)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA card" in res.stderr


def test_fails_where_only_the_benchmark_is(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(bench.PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = command(tmp_path)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "compeg_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxlibrary.sub", sys)
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "compeg_tpu.pipeline", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert bench.forbidden_modules() == ["compeg_tpu", "jax"]


def loaded_by(code):
    """Top-level names of the modules a fresh interpreter holds after
    ``code``."""
    res = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    names = loaded_by(
        "import runpy, sys; sys.argv = ['run.py']\n"
        "sys.path.insert(0, '.')\n"
        "import perfbench.harness.bench, perfbench.harness.loops\n"
        "import compeg_tpu_torch, compeg_tpu_torch.ops.fused\n"
        "import compeg_tpu_torch.ops.color, compeg_tpu_torch.batch")
    assert "compeg_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "compeg_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    names = loaded_by("import sys; sys.path.insert(0, '.')\n"
                      "import perfbench.reference.jpeg, perfbench.harness.check")
    assert not names & {"jax", "jaxlib", "flax", "compeg_tpu",
                        "compeg_tpu_torch"}


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_runs_correct_on_the_cpu(cell, capsys):
    line, rc = run_small(cell, capsys)
    assert rc == 0 and line["correct"] is True
    names = {m["name"] for m in bench.cell_metrics(
        bench.load_json(os.path.join(ROOT, "BENCHMARK.json")), cell, False)}
    assert set(line["metrics"]) == names
    assert list(line)[-1] == "checks"


def test_a_new_mix_and_metric_are_found_by_name(tmp_path):
    """A later change adds a cell, its traffic and a metric as new files and
    entries, editing no file that is there: here the stream cell that this
    benchmark measured and left out (PERF.md), with a mix of its own."""
    shutil.copytree(bench.PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "compeg_tpu_torch"),
               tmp_path / "compeg_tpu_torch")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(os.path.join(bench.PERFBENCH, "traffic", "stream.json")) as f:
        mix = json.load(f)
    mix.update(depth=1, prepare_threads=1)
    (tmp_path / "perfbench" / "traffic" / "stream_d1.json").write_text(
        json.dumps(mix))
    (tmp_path / "perfbench" / "metrics" / "frames_attempted.py").write_text(
        "def read(ctx):\n    return ctx.result['attempted']\n")
    cell = "uvc4k_422.stream_d1"
    spec["workloads"].append({"name": cell, "config": "uvc4k_422",
                              "traffic": "stream_d1", "chips": 1,
                              "why": "one frame in flight"})
    spec["end_to_end"].append({
        "name": "fps.stream", "unit": "frames/s", "better": "higher",
        "bound": 0.25, "source": "host_clock", "workloads": [cell]})
    for name, layer in (("frames_attempted", "device"),
                        ("prepare_fps.stream", "host prepare"),
                        ("device_idle_pct.stream", "device")):
        spec["per_layer"].append({
            "name": name, "unit": "frames", "better": "higher",
            "source": "program_counter", "layer": layer,
            "moves": "fps.stream", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import sys, time, json\nsys.path.insert(0, '.')\n"
        "from perfbench.harness import bench\n"
        "from perfbench.tests.small import SMALL\n"
        "trace = int(sys.argv[1])\n"
        "sys.exit(bench.run(['--workload', 'uvc4k_422.stream_d1', '--seed',"
        " '5', '--seconds', '0.3', '--trace', str(trace)],"
        " time.perf_counter(), '.', device='cpu', overrides=SMALL))\n")
    lines = []
    for trace in (0, 1):
        res = subprocess.run([sys.executable, "-c", code, str(trace)],
                             cwd=tmp_path, capture_output=True, text=True,
                             timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
        lines.append(json.loads(res.stdout.strip().splitlines()[-1]))
    assert set(lines[0]["metrics"]) == {"fps.stream", "setup_s"}
    assert lines[1]["metrics"]["frames_attempted"]["value"] == \
        lines[1]["attempted"]
    assert "prepare_fps.stream" in lines[1]["metrics"]
    assert all(line["correct"] is True for line in lines)


@pytest.mark.card
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    res = command(ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"


def test_benchmark_json_keeps_to_its_shape():
    """Every entry has the keys it may have, every name is a name, and every
    configuration, traffic mix and metric named has its file."""
    import re

    spec = bench.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.match(c["name"]) and os.path.exists(
            os.path.join(ROOT, c["file"]))
    cells = {w["name"] for w in spec["workloads"]}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert name.match(w["name"]) and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(bench.PERFBENCH, "traffic",
                                           w["traffic"] + ".json"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert name.match(m["name"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(bench.PERFBENCH, "metrics",
                                           m["name"] + ".py"))
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for cell in cells:  # setup_s, another end-to-end and a per-layer one
        assert len(bench.cell_metrics(spec, cell, False)) >= 2
        assert bench.cell_metrics(spec, cell, True)
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
