"""decode_roofline: the least time the traced frames' decode needs on the
card (each frame's entropy-coded data, counted from its JPEG bytes, read
once and its RGBA written once, at the card's peak bandwidth) over the
card's busy time in the traced stretch, in per cent. The count is of the
work, not of the kernels that do it or of the form the program packs the
data in."""

from perfbench.harness.roofline import bound_s


def read(ctx):
    if ctx.stretch is None or not ctx.frames_traced or not ctx.busy_s:
        return None
    least = bound_s(ctx.frames_traced * ctx.frame_bytes(), ctx.kind)
    return 100.0 * least / ctx.busy_s
