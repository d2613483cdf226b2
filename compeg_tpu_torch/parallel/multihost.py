"""Process-group initialization and scaling measurement: the port of
compeg_tpu/parallel/multihost.py.

The recipe, as in the JAX package, with ``torch.distributed`` in place of
``jax.distributed``:

 * each process calls :func:`init_distributed` once (NCCL and one card a
   rank on CUDA, gloo on the CPU), given the rendezvous address, the world
   size and its rank (nothing on the machine announces a cluster);
 * :func:`global_mesh` builds the (data, seq) mesh over every rank;
 * every rank decodes its part of the batch
   (``sharding.decode_frames_sharded`` or ``decode_batch_sharded``).

``tools/dryrun_multiproc.py`` spawns the processes of such a job on one
host.
"""

from __future__ import annotations

import socket
import statistics
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..errors import bail
from .sharding import make_mesh


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now, for a rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> None:
    """Join the process group of a ``num_processes``-rank job whose
    rendezvous is ``coordinator_address`` (``host:port``). No-op for one
    process (the common case). On CUDA the backend is NCCL and rank ``r``
    takes card ``r`` of this host, which must have a card for every rank;
    on the CPU it is gloo."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        bail("init_distributed needs the rendezvous address and this "
             "process's rank")
    dev = torch.device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if cards < num_processes:
            raise RuntimeError(
                f"{num_processes} NCCL ranks need a card each; this host has "
                f"{cards} (NCCL refuses two ranks on one card)")
        torch.cuda.set_device(process_id)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def global_mesh(n_seq: int = 1, device_type: Optional[str] = None):
    """The (data, seq) mesh over every rank of the job: ``world / n_seq``
    by ``n_seq``."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % n_seq:
        bail(f"{n} ranks not divisible by seq={n_seq}")
    return make_mesh(n // n_seq, n_seq, device_type)


def _device(process_id: int, device) -> str:
    dev = torch.device(device)
    return f"cuda:{process_id}" if dev.type == "cuda" else "cpu"


def _test_frame(h: int, w: int, ri: int, mult: Tuple[int, int] = (7, 5),
                sampling: str = "422"):
    from ..encoder import encode

    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * mult[0] % 256, yy * mult[1] % 256, (xx + yy) % 256],
                   axis=-1).astype(np.uint8)
    return encode(img, sampling=sampling, quality=85,
                  restart_interval_mcus=ri)


def dryrun_multiprocess(
    process_id: int,
    num_processes: int = 2,
    coordinator_address: Optional[str] = None,
    device="cuda",
) -> None:
    """One worker of a multi-process dryrun: the real path of a job over
    several processes — the process group, a global (data, seq) mesh that
    spans them (``n_seq = 2`` when the world is even), each rank decoding its
    part with the halo exchange between ranks — in three configurations:
    Ri = 1 nearest, Ri = 1 fancy 4:2:0 (the halo; the last band holds one
    MCU row of content and one of padding, so the content edge clamps), and
    Ri = 3 with ``exact_idct`` (bands cut at a restart boundary). Each rank checks its part against
    the same rows of a one-process ``Decoder`` decode on its own device.
    The launcher (``tools/dryrun_multiproc.py``) spawns ``num_processes``
    of these and hands them one rendezvous, ``coordinator_address``
    (``host:port``, a port it found free), which a job of more than one
    process needs."""
    from ..batch import BatchDecoder
    from ..metadata import analyze
    from ..pipeline import Decoder, FrameGeometry
    from . import sharding as SH

    init_distributed(coordinator_address, num_processes, process_id, device)
    dev = _device(process_id, device)
    try:
        n_seq = 2 if num_processes % 2 == 0 else 1
        mesh = global_mesh(n_seq, torch.device(dev).type)
        n_data = num_processes // n_seq
        s = SH.mesh_coordinate(mesh)[1]
        h, w = 48, 32
        for ri, sampling, knobs in (
                (1, "422", {}), (1, "420", {"fancy_upsampling": True}),
                (3, "422", {"exact_idct": True})):
            data = _test_frame(h, w, ri, sampling=sampling)
            out = SH.decode_frames_sharded(
                [data] * (2 * n_data), mesh,
                decoder=BatchDecoder(device=dev, **knobs))
            want = Decoder(device=dev, **knobs).decode(data)
            # Two frames a data rank, one band a seq rank: its rows of each
            # frame, and the whole frames gathered from every rank.
            img = analyze(data)
            shard_h = SH.band_geometry(FrameGeometry.from_image(img),
                                       SH.band_rows_for(img, n_seq)).height
            ref = want[s * shard_h:(s + 1) * shard_h]
            for part, rows, frames in ((out, ref, 2),
                                       (SH.gather_global(out, mesh), want,
                                        2 * n_data)):
                got = part.cpu().numpy().view(np.uint8).reshape(
                    *part.shape, 4)[..., :3]
                if got.shape != (frames,) + rows.shape or not all(
                        np.array_equal(f, rows) for f in got):
                    raise AssertionError(
                        f"rank {process_id}, Ri {ri} {sampling} {knobs}: "
                        f"{got.shape} differs from the one-process decode")
    finally:
        if num_processes > 1:
            dist.destroy_process_group()


def bench_multiprocess(
    process_id: int,
    num_processes: int = 2,
    coordinator_address: Optional[str] = None,
    device="cuda",
    frames_per_rank: int = 4,
    iters: int = 8,
) -> float:
    """Timed multi-process decode step: every rank decodes its share of a
    data-parallel batch (``frames_per_rank`` frames of 64 x 128) ``iters``
    times between two barriers. Returns this rank's frames/s for the GLOBAL
    batch (the slowest rank sets the job's rate; the launcher takes the
    min). ``num_processes=1`` is the one-process baseline of the weak-scaling
    comparison (``tools/dryrun_multiproc.py --bench``), which needs no
    ``coordinator_address``."""
    from ..batch import BatchDecoder
    from . import sharding as SH

    init_distributed(coordinator_address, num_processes, process_id, device)
    dev = _device(process_id, device)
    try:
        mesh = global_mesh(1, torch.device(dev).type)
        frames = [_test_frame(64, 128, 1, (3, 5))] * (
            frames_per_rank * num_processes)
        dec = BatchDecoder(device=dev)

        def step():
            out = SH.decode_frames_sharded(frames, mesh, decoder=dec)
            _wait(out)

        step()
        if num_processes > 1:
            dist.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        if num_processes > 1:
            dist.barrier()
        dt = (time.perf_counter() - t0) / iters
        return len(frames) / dt
    finally:
        if num_processes > 1:
            dist.destroy_process_group()


def _wait(out) -> None:
    """Block until the device work behind ``out`` (a tensor) is done."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


def measure_scaling(
    decode_fn,
    batch_for,
    device_counts: List[int],
    iters: int = 3,
    trials: int = 1,
) -> List[Tuple[int, float, float]]:
    """Weak-scaling measurement: for each n in ``device_counts`` decode a
    batch proportional to n (``decode_fn(n, *batch_for(n))``, the batch's
    frames along the first dimension of its first argument) and wait for the
    device (``torch.cuda.synchronize`` where the result is on a card).
    Returns ``[(n, frames_per_s, efficiency_vs_smallest)]``. ``trials``
    repeats the timed loop and keeps the MEDIAN (time-shared CPUs steal
    cycles; a min would let the smallest n harvest one quiet moment that a
    larger n, needing all its cores quiet at once, cannot)."""
    results = []
    base_rate = None
    for n in device_counts:
        args = batch_for(n)
        _wait(decode_fn(n, *args))
        times = []
        for _ in range(max(1, trials)):
            t0 = time.perf_counter()
            for _ in range(iters):
                out = decode_fn(n, *args)
            _wait(out)
            times.append((time.perf_counter() - t0) / iters)
        rate = args[0].shape[0] / statistics.median(times)
        if base_rate is None:
            base_rate = rate / n
        results.append((n, rate, rate / (n * base_rate)))
    return results
