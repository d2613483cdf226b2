"""launch_span_ms.resident: the mean duration, in ms, of the program's
``compeg.launch`` spans in the traced stretch: the host's time to enqueue
one batch's device work in ``Decoder.decode_rows``."""

from perfbench.harness.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "launch")
