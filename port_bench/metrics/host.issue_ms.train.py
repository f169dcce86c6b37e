"""Host issue time of a step in ms: the host clock from the call to its
return, with no synchronization, averaged over the traced run's issue
steps (each started on an idle card), before the profiler starts."""


def read(ctx):
    if ctx.kind != "train" or not ctx.issue_ms:
        return None
    return sum(ctx.issue_ms) / len(ctx.issue_ms)
