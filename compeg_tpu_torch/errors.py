"""Error type for the compeg_tpu_torch decode engine (the port's own copy of
compeg_tpu/errors.py; the two classes are distinct).

Mirrors the contract of the reference's single opaque error type
(reference: src/error.rs:5-46, src/lib.rs:589-592): any `CompegError` raised
by this library means "this file is outside the supported envelope or
corrupt; fall back to a fully-featured software decoder".
"""

from __future__ import annotations


class CompegError(Exception):
    """Raised when a JPEG cannot be decoded by this engine.

    The message describes the reason; callers should treat any instance as a
    signal to fall back to a general-purpose software decoder rather than a
    fatal application error.
    """


def bail(msg: str) -> None:
    raise CompegError(msg)
