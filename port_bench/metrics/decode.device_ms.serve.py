"""Device time, ms a request, of the dense decode: the operations launched
inside the program's ranges ``mgu.decode.*`` (``models/detection.py::
decode_dense_detections``: scores, boxes and the top-k; NMS and the
survivors; opened as ``pb.mgu.<name>`` too by the scene driver). Nothing
where none lies inside them."""


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None:
        return None
    us = [o.dur for o in ctx.trace.ops if any(r.startswith("pb.mgu.decode.") for r in o.ranges)]
    return sum(us) / 1e3 / ctx.steps if us else None
