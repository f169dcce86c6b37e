"""Device time, ms a step, of the graph branch, the heads and the losses,
forward only: the operations launched inside the program's ranges
``mgu.graph.*``, ``mgu.detection`` and ``mgu.loss.*``
(``utils/profiling.py::span``; the end-to-end driver opens each as
``pb.mgu.<name>`` too, which the trace reader ties operations to), less
those inside ``mgu.cc.*``. Nothing where no operation lies inside
``mgu.loss.*`` (a program without those ranges)."""

GRAPH = ("pb.mgu.graph.", "pb.mgu.detection", "pb.mgu.loss.")
CC = "pb.mgu.cc."


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    ops = ctx.trace.ops
    if not any(r.startswith("pb.mgu.loss.") for o in ops for r in o.ranges):
        return None
    us = sum(o.dur for o in ops
             if any(r.startswith(GRAPH) for r in o.ranges) and not any(r.startswith(CC) for r in o.ranges))
    return us / 1e3 / ctx.steps
