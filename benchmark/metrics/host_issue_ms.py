"""Host milliseconds from calling the timed entry (the train step, or the
forward of a request) to its return, before any synchronise, averaged over
the window's (untraced) steps or requests. Read for ``host_issue_ms.train``
and ``host_issue_ms.infer``."""


def read(ctx):
    if not ctx.issue_s:
        return None
    return 1e3 * sum(ctx.issue_s) / len(ctx.issue_s)
