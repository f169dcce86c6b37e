"""Share of the traced window, in %, in which no device operation ran
(torch.profiler, after one discarded warm-up step)."""


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or ctx.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us() / ctx.trace.window_us)
