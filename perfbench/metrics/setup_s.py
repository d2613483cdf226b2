"""setup_s: process start to the window's first timed frame."""


def read(ctx):
    return ctx.setup_s
