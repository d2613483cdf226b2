"""The port's copied parser (compeg_tpu_torch/parser.py) held to the JAX
package's parser snapshots.

tests/test_snapshots.py renders a corpus of deliberately out-of-envelope
files (progressive, 16-bit tables, non-interleaved scans, truncations,
trailing garbage, ...) with ``dump_segments`` and compares each with its
committed ``tests/snapshots/<name>.log``. Here the same corpus, imported
from that file unchanged, goes through the port's ``dump_segments`` and
must give the same logs, once with the scan's end found by
``native.find_scan_end`` and once by the numpy search
(``native.available`` patched false). The logs are only read. The entries
the JAX encoder makes, the port's encoder must make byte for byte."""

import inspect
import os

import pytest

pytest.importorskip("torch")

import test_snapshots as JS  # noqa: E402
from compeg_tpu_torch import encoder as PE  # noqa: E402
from compeg_tpu_torch import native  # noqa: E402
from compeg_tpu_torch import parser as PP  # noqa: E402

ENCODED = sorted(name for name, make in JS.CORPUS.items()
                 if "encoder." in inspect.getsource(make))


@pytest.mark.parametrize("search", ["native", "numpy"])
@pytest.mark.parametrize("name", sorted(JS.CORPUS))
def test_port_parser_matches_the_snapshot(name, search, monkeypatch):
    if search == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip("the native host library is not built here")
    data = JS.CORPUS[name]()
    with open(os.path.join(JS.SNAP_DIR, f"{name}.log")) as f:
        want = f.read()
    assert PP.dump_segments(data) == want, name


@pytest.mark.parametrize("name", ENCODED)
def test_port_encoder_makes_the_corpus_bytes(name, monkeypatch):
    want = JS.CORPUS[name]()
    monkeypatch.setattr(JS, "encoder", PE)
    assert JS.CORPUS[name]() == want, name


def test_corpus_is_whole():
    """Every committed log has its corpus entry, and the encoder made most
    of them."""
    logs = {f[:-4] for f in os.listdir(JS.SNAP_DIR) if f.endswith(".log")}
    assert logs == set(JS.CORPUS)
    assert len(ENCODED) == 13
