"""Window milliseconds over the requests completed in it."""


def read(ctx):
    if ctx.kind != "infer" or not ctx.items:
        return None
    return 1e3 * ctx.window_s / ctx.items
