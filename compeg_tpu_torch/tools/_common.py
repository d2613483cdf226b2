"""What the measurement tools share: the device, the card's name and power
limit, the workload and the result line.

Each tool (``bench``, ``bench_host``, ``bench_stream``, ``bench_scaling``,
``trace_ops``, ``trace_sharded``) runs on ``--device cuda`` by default and
fails where there is no card: a host clock is never printed under a device
metric's name. ``--device cpu`` runs the kernels' plain versions on a small
frame, for the tests; every device-time field is then ``None`` (null in the
JSON line, "not measured").
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import List, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
# 3840 x 2160, 4:2:2, restart interval 1: 64,800 segments.
ASSET = os.path.join(ROOT, "bench_assets", "bench4k.jpg")
SMALL = (64, 128)  # the CPU's frame, 4:2:2, restart interval 1
SEED = 0


def device(name: str):
    """``torch.device(name)``; raises for ``cuda`` where there is no card
    (the tools never carry on on the CPU unasked)."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the measurement tools time the card; pass "
            "--device cpu for the plain versions at a small size (no device "
            "times)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


def cards(devs) -> List[dict]:
    """Each CUDA device of ``devs``' ``{"name", "power_limit_w"}`` as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them, the card found by its UUID: nvidia-smi counts the host's cards,
    torch only those ``CUDA_VISIBLE_DEVICES`` shows it."""
    import torch

    uuids = [f"GPU-{torch.cuda.get_device_properties(d).uuid}" for d in devs]
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,name,power.limit",
         "--format=csv,noheader", "-i", ",".join(uuids)],
        capture_output=True, text=True, check=True, timeout=60)
    found = {}
    for line in res.stdout.strip().splitlines():
        uuid, rest = (p.strip() for p in line.split(",", 1))
        name, limit = (p.strip() for p in rest.rsplit(",", 1))
        try:
            watts: Optional[float] = float(limit.split()[0])
        except ValueError:  # "[N/A]"
            watts = None
        found[uuid] = {"name": name, "power_limit_w": watts}
    return [found[u] for u in uuids]


def card(dev) -> Optional[dict]:
    """The card of ``dev`` (``None`` on the CPU), printed on a ``#`` line
    to stderr so that every time the tool prints has it beside it."""
    if dev.type != "cuda":
        print("# device: cpu, plain versions; device times not measured",
              file=sys.stderr, flush=True)
        return None
    [info] = cards([dev])
    print(f"# device: {info['name']}, {info['power_limit_w']} W",
          file=sys.stderr, flush=True)
    return info


def workload(dev) -> bytes:
    """The frame a tool times: ``bench_assets/bench4k.jpg`` on the card,
    a 64 x 128 4:2:2 Ri = 1 frame from the port's encoder on the CPU."""
    if dev.type == "cuda":
        with open(ASSET, "rb") as f:
            return f.read()
    from ..encoder import encode

    img = np.random.default_rng(SEED).integers(
        0, 256, SMALL + (3,)).astype(np.uint8)
    return encode(img, sampling="422", quality=85, restart_interval_mcus=1)


def sync(dev) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def measured(dev, value):
    """``value`` on the card, ``None`` ("not measured") on the CPU."""
    return value if dev.type == "cuda" else None


def emit(result: dict) -> dict:
    """Print ``result`` as the tool's one JSON line and return it."""
    print(json.dumps(result), flush=True)
    return result
