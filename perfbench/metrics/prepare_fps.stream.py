"""prepare_fps.stream: frames/s of the public Decoder(pack_threads=1)
.prepare on 4 threads over the cell's frames, after the window: the
configuration StreamDecoder gives its prepare workers."""


def read(ctx):
    return ctx.prepare_rate(threads=4, passes=8, pack_threads=1)
