"""Device time, ms a request, of the operations launched inside the U-Net's
range (forward hooks on the U-Net module)."""


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None:
        return None
    us = ctx.trace.device_us("pb.layer:unet")
    return us / 1e3 / ctx.steps if us > 0 else None
