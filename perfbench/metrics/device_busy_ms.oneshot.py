"""device_busy_ms.oneshot: the card's busy time a frame in the traced stretch
(the union of its kernel and copy records, uploads and readbacks
included), in ms."""


def read(ctx):
    if ctx.stretch is None or not ctx.frames_traced:
        return None
    return 1e3 * ctx.busy_s / ctx.frames_traced
