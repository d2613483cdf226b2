"""readback_span_ms.oneshot: the mean duration, in ms, of the program's
``compeg.readback`` spans in the traced stretch: the one-shot decode's wait
for its frame and the copy of its RGB to host memory."""

from perfbench.harness.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "readback")
