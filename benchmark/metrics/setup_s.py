"""Set-up seconds: process start until the window opens (loading, the
kernel build where it is not cached, weights, the traffic pool and its
work counts, the warm-up or the compared first steps)."""


def read(ctx):
    return ctx.setup_s
