"""torch.cuda.max_memory_allocated() over the window, after a reset at its
start, in GiB."""


def read(ctx):
    if ctx.kind != "train" or not ctx.peak_window_bytes:
        return None
    return ctx.peak_window_bytes / 2 ** 30
