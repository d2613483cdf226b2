"""prepare_span_ms.oneshot: the mean duration, in ms, of the program's
``compeg.prepare`` spans in the traced stretch: ``Decoder.prepare`` as it ran
inside the window (``prepare_ms.oneshot`` times it again after the
window)."""

from perfbench.harness.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "prepare")
