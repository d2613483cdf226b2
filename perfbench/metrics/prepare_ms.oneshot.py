"""prepare_ms.oneshot: the mean wall time, in ms, of the public
Decoder(**the configuration's knobs).prepare over the cell's frames on one
thread, after the window."""


def read(ctx):
    return 1e3 / ctx.prepare_rate(threads=1, passes=4, **ctx.cfg["decoder"])
