"""The comparison that decides ``correct`` has to fail what is wrong: the
harness driven on the CPU at a small size with the timed path broken
underneath (the card's look skipped), and the control, the reference at
the next lower precision in the program's place."""

import numpy as np
import pytest
import torch

from compeg_tpu_torch import pipeline
from perfbench.harness import check

from .small import CELLS, run_small
from .test_perfbench_inputs import small_config

RESIDENT = [c for c in CELLS if c.endswith("resident")]


def stale(orig):
    """A decode that hands back the previous call's output, the state it
    held, in place of the new one."""
    last = []

    def decode_rows(self, pf, rows):
        out = orig(self, pf, rows)
        prev = last[0] if last else out
        last[:] = [out]
        return prev
    return decode_rows


def altered(orig):
    """A decode whose answer is altered where it is produced: the first
    pixel of every frame gets its colour inverted."""
    def decode_rows(self, pf, rows):
        out = orig(self, pf, rows).clone()
        out[..., 0, 0] ^= 0x00FFFFFF
        return out
    return decode_rows


def half(orig):
    """A batched decode that leaves out the second half of the batch."""
    def decode_rows(self, pf, rows):
        if rows.dim() != 3:
            return orig(self, pf, rows)
        b = rows.shape[0]
        out = orig(self, pf, rows[:b // 2])
        return torch.cat([out, torch.zeros_like(out)])[:b]
    return decode_rows


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [stale, altered])
def test_a_broken_decode_is_not_correct(cell, fault, monkeypatch, capsys):
    monkeypatch.setattr(pipeline.Decoder, "decode_rows",
                        fault(pipeline.Decoder.decode_rows))
    line, rc = run_small(cell, capsys)
    assert rc == 0 and line["correct"] is False


@pytest.mark.parametrize("cell", RESIDENT)
def test_half_a_batch_left_out_is_not_correct(cell, monkeypatch, capsys):
    monkeypatch.setattr(pipeline.Decoder, "decode_rows",
                        half(pipeline.Decoder.decode_rows))
    line, rc = run_small(cell, capsys)
    assert rc == 0 and line["correct"] is False


@pytest.mark.parametrize("name", ["uvc4k_422", "cam1080_420_exact_fancy"])
def test_the_control_fails_and_the_reference_passes(name):
    """The reference at the next lower precision (bfloat16 for the float
    IDCT, 8-bit constants for the integer one) in the program's place fails
    the configuration's limits; the reference itself passes them."""
    from perfbench.inputs import frames as F

    cfg = small_config(name)
    src = F.source(cfg)
    sample = [(j, None) for j in range(4)]

    def frame(j):
        return src.frame(13, j)

    ctl = check.compare(cfg, frame, sample, 4, control=cfg["reference"][
        "control"])
    assert any(v > lim for v, lim in ctl.values())
    ref = check.compare(cfg, frame,
                        [(j, check.reference(cfg, frame(j))) for j in
                         range(4)], 4)
    assert all(v <= lim for v, lim in ref.values())


def test_a_missing_sample_is_not_correct():
    cfg = small_config("uvc4k_422")
    got = check.compare(cfg, lambda j: b"", [], 2)
    assert got["frames_short"] == (2, 0)


def test_gaps_count_a_wrong_shape_as_all_wrong():
    g = check.gaps(np.zeros((2, 2, 3), np.uint8), np.zeros((2, 3, 3),
                                                           np.uint8))
    assert g["diff"] == g["samples"] == 18
