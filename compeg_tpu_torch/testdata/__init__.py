"""Golden reference data for checking the port where the JAX package is not
imported (``chip_smoke.py`` on the card).

``smoke.npz`` holds small streams of every supported sampling with the golden
decoder's raw coefficients, float and integer RGB, integer planes, scaled RGB
and fancy RGB; a ZRL stream and a stream of int32-wrapping blocks with their
answers; and for ``bench_assets/bench4k.jpg`` the digests of golden's
coefficients, RGB, integer RGB, integer planes and fancy RGB plus some of
golden's float and scaled RGB rows. tests/test_torch_smoke_vectors.py writes
it and checks it against golden.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "smoke.npz")


def load(path: str = PATH) -> dict:
    """Every array of the file, by name."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def digest(a: np.ndarray) -> str:
    """sha256 of an array's dtype, shape and C-order bytes."""
    a = np.ascontiguousarray(a)
    head = f"{a.dtype.str} {a.shape}".encode()
    return hashlib.sha256(head + a.tobytes()).hexdigest()
