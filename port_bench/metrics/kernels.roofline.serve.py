"""The port's hand-written kernel launches in the traced steps: the sum of
each call's bound (``max(bytes / 3.35 TB/s, operations / peak)`` from its
shapes, ``roofline/<kernel>.py``) over the sum of the device time of the
operations the call launched, in %."""


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None or not ctx.calls:
        return None
    dev = {}
    for op in ctx.trace.ops:
        for r in op.ranges:
            if r.startswith("pb.kernel:"):
                dev[r] = dev.get(r, 0.0) + op.dur
    used = [c for i, c in enumerate(ctx.calls) if f"pb.kernel:{c.kernel}:{i}" in dev]
    total_us = sum(dev.values())
    if not used or total_us <= 0:
        return None
    return 100.0 * sum(c.bound_s for c in used) * 1e6 / total_us
