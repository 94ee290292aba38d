"""Valid voxels of all steps completed in the window over the window's
seconds (the window ends with a synchronise)."""


def read(ctx):
    if ctx.kind != "train" or not ctx.items:
        return None
    return ctx.voxels / ctx.window_s
