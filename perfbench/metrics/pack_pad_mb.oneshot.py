"""pack_pad_mb.oneshot: the zero rows that the program's ``Decoder.prepare``
packs past a frame's last segment, in MB (10^6 bytes) a frame: its counter
``pack_pad_bytes`` (added once a prepare) over its ``prepare`` spans, over
the run."""

from perfbench.harness.counters import count, ratio, spans


def read(ctx):
    return ratio(count("pack_pad_bytes"), 1e6 * spans("prepare"))
