"""K3: ``ops/kernels/pool.py::phase_max_pool_kernel``, the 2×2 max pool of
an s2d tensor (a max over its four phases). Bound by its bytes: in and
out once."""

WRAPPER = ("mingraph_unet_tpu_torch.ops.kernels.pool", "phase_max_pool_kernel")


def flops(*args, **kw) -> float:
    return 0.0
