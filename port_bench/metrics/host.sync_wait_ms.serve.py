"""Host time, ms a request, in the program's calls that made the host wait
on the card. The program leaves a marker ``mgu.sync@<file>:<line>`` as
such a call returns (``utils/profiling.py::span``); the call is the
outermost host operation (an aten op, not a range of the program's or the
harness's) that ended last at or before the marker, and its whole duration
counts. 0 where the program's ``mgu.`` spans are in the trace and no marker
is; nothing where the trace holds no ``mgu.`` span."""


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None:
        return None
    host = ctx.trace.host
    if not any(h["name"].startswith("mgu.") for h in host):
        return None
    ops = [(h["ts"], h["ts"] + h["dur"]) for h in host if not h["name"].startswith(("mgu.", "pb."))]
    total_us = 0.0
    for m in host:
        if not m["name"].startswith("mgu.sync@"):
            continue
        done = [op for op in ops if op[1] <= m["ts"]]
        if not done:
            continue
        last = max(done, key=lambda op: op[1])
        outer = min((op for op in done if op[0] <= last[0] and op[1] >= last[1]), key=lambda op: (op[0], -op[1]))
        total_us += outer[1] - outer[0]
    return total_us / 1e3 / ctx.steps
