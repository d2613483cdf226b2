"""idle_in_upload_pct.oneshot: the share of the traced stretch, in per
cent, in which the card ran no kernel, memcpy or memset while the host was
inside a ``compeg.upload`` span of the program."""

from perfbench.harness.spans import idle_in_pct


def read(ctx):
    return idle_in_pct(ctx, "upload")
