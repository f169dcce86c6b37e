"""Device time, ms a step, of the connected components: the operations
launched inside the program's ranges ``mgu.cc.*`` (``ops/cc.py``: the
labelling and the top-instance selection; the end-to-end driver opens each
as ``pb.mgu.<name>`` too, which the trace reader ties operations to).
Nothing where none lies inside them."""


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    us = [o.dur for o in ctx.trace.ops if any(r.startswith("pb.mgu.cc.") for r in o.ranges)]
    return sum(us) / 1e3 / ctx.steps if us else None
