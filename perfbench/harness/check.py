"""Whether what the window delivered is correct: the sampled frames'
pixels against the plain reference (:mod:`perfbench.reference.jpeg`), which
decodes each frame's bytes itself.

The numbers compared and their limits are the configuration's
(``limits``): for the float mode the widest gap of a sample to the
reference (``max_abs_diff``) and the share of samples more than 1 off
(``share_over_1``); for the exact integer mode the count of samples that
differ at all (``diff_samples``). ``frames_short`` counts sampled frames
that were due but not compared (limit 0).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..reference import jpeg as R

NUMBERS = ("max_abs_diff", "share_over_1", "diff_samples")


def gaps(program: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """The comparison's counts for one frame."""
    if program.shape != ref.shape:
        return {"max_abs_diff": 255, "over_1": ref.size, "diff": ref.size,
                "samples": ref.size}
    d = np.abs(program.astype(np.int16) - ref.astype(np.int16))
    return {"max_abs_diff": int(d.max()), "over_1": int((d > 1).sum()),
            "diff": int((d != 0).sum()), "samples": int(d.size)}


def numbers(per_frame: Sequence[Dict[str, float]]) -> Dict[str, float]:
    samples = sum(g["samples"] for g in per_frame) or 1
    return {"max_abs_diff": max([g["max_abs_diff"] for g in per_frame],
                                default=0),
            "share_over_1": sum(g["over_1"] for g in per_frame) / samples,
            "diff_samples": sum(g["diff"] for g in per_frame)}


def reference(cfg: dict, data: bytes, precision: str = "",
              lanes: Optional[R.Lanes] = None) -> np.ndarray:
    rc = cfg["reference"]
    return R.decode(data, rc["idct"], rc["chroma"], precision, lanes)


def compare(cfg: dict, frame: Callable[[int], bytes],
            sample: List[Tuple[int, np.ndarray]], expected: int,
            control: Optional[str] = None,
            lanes: Callable[[int], Optional[R.Lanes]] = lambda j: None
            ) -> Dict[str, Tuple[float, float]]:
    """``{number: (value, limit)}`` over the ``sample`` of ``(pool index,
    program RGB)``; ``expected`` is the size the sample should have.
    ``control`` puts the reference at that lower precision in the
    program's place (the program's RGB is then not read). ``lanes(j)``
    gives the frame source's hints for frame ``j``, if any."""
    per_frame = []
    for j, rgb in sample:
        data, hint = frame(j), lanes(j)
        ref = reference(cfg, data, lanes=hint)
        got = reference(cfg, data, control, hint) if control else rgb
        per_frame.append(gaps(got, ref))
    got = numbers(per_frame)
    limits = cfg["limits"]
    out = {k: (got[k], limits[k]) for k in NUMBERS if k in limits}
    out["frames_short"] = (max(0, expected - len(sample)), 0)
    return out
