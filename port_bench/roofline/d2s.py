"""K5: ``ops/kernels/pool.py::depth_to_space_kernel``, an s2d tensor back to
full resolution. Bound by its bytes: in and out once."""

WRAPPER = ("mingraph_unet_tpu_torch.ops.kernels.pool", "depth_to_space_kernel")


def flops(*args, **kw) -> float:
    return 0.0
