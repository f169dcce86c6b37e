"""Device time, ms a step, of the operations launched outside the forward's
range: augmentation and the losses, autograd's backward (its own thread),
the kernel gradient and Adam."""


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    us = ctx.trace.device_us(exclude="pb.layer:forward")
    return us / 1e3 / ctx.steps if us > 0 else None
