"""Device operations a step launched inside the program's ranges
``mgu.cc.*`` (``ops/cc.py``; opened as ``pb.mgu.<name>`` too by the
end-to-end driver): kernels, copies and memsets of the connected
components. Nothing where none lies inside them."""


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    n = sum(1 for o in ctx.trace.ops if any(r.startswith("pb.mgu.cc.") for r in o.ranges))
    return n / ctx.steps if n else None
