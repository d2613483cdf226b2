"""fps.resident: frames whose pixels were complete where the cell delivers them,
over all the seconds of the window (the loop's own count)."""


def read(ctx):
    return ctx.result.get("fps")
