"""Device operations a request launched inside the program's ranges
``mgu.decode.*`` (``models/detection.py::decode_dense_detections``; opened
as ``pb.mgu.<name>`` too by the scene driver): kernels, copies and memsets
of the dense decode, the NMS loop's among them. Nothing where none lies
inside them."""


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None:
        return None
    n = sum(1 for o in ctx.trace.ops if any(r.startswith("pb.mgu.decode.") for r in o.ranges))
    return n / ctx.steps if n else None
