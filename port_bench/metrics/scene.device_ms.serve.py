"""Device time, ms a request, of the large scene's windows and stitch: the
operations launched inside the program's ranges ``mgu.scene.*``
(``parallel/spatial.py``, ``train/infer.py``: the windows cut, each
window's f32 concat, the stitch; the scene driver opens each as
``pb.mgu.<name>`` too, which the trace reader ties operations to). Nothing
where none lies inside them."""


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None:
        return None
    us = [o.dur for o in ctx.trace.ops if any(r.startswith("pb.mgu.scene.") for r in o.ranges)]
    return sum(us) / 1e3 / ctx.steps if us else None
