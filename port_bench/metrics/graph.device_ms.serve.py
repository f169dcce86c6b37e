"""Device time, ms a request, of the operations launched inside the ranges
of the graph branch and heads: the lattice GAT, MinCut, the region GAT and
the detection head (forward hooks on those submodules)."""


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None:
        return None
    us = ctx.trace.device_us("pb.layer:graph")
    return us / 1e3 / ctx.steps if us > 0 else None
