"""device_idle_pct.stream: the share of the traced stretch in which no kernel,
memcpy or memset ran on the card (the union of their intervals), in per
cent."""


def read(ctx):
    if ctx.stretch is None or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
