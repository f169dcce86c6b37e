"""Calls a request of the program that made the host wait on the card: the
program's ``mgu.sync@<file>:<line>`` markers in the traced steps
(``utils/profiling.py::span``), over the steps. 0 where the program's
``mgu.`` spans are in the trace and no marker is; nothing where the trace
holds no ``mgu.`` span (a program without them)."""


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None:
        return None
    names = [h["name"] for h in ctx.trace.host if h["name"].startswith("mgu.")]
    if not names:
        return None
    return sum(n.startswith("mgu.sync@") for n in names) / ctx.steps
