"""Host time, ms a request, in which the program derives the weights it
runs with from its parameters again (BN folded into the convs, the s2d
kernel and bias layouts, the kernels' weight packing): the summed duration
of the outermost ``mgu.weights`` ranges (``utils/profiling.py::span``) of
the traced steps, over the steps. Nothing where the trace holds none. A
call that makes the host wait on the card inside such a range counts with
its wait: the wait of a sync marker (``mgu.sync@``) inside ``mgu.weights``
is in both this and ``host.sync_wait_ms.serve``."""


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None:
        return None
    spans = sorted(((h["ts"], h["ts"] + h["dur"]) for h in ctx.trace.host if h["name"] == "mgu.weights"),
                   key=lambda s: (s[0], -s[1]))
    if not spans:
        return None
    total_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b <= end:  # inside the last outermost one
            continue
        total_us += b - a
        end = b
    return total_us / 1e3 / ctx.steps
