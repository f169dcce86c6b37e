"""K6: ``ops/kernels/histeq.py::equalize_channel``, the histogram
equalization of uint8 luma, one image a cluster. Bound by its bytes: in
and out once."""

WRAPPER = ("mingraph_unet_tpu_torch.ops.kernels.histeq", "equalize_channel")


def flops(*args, **kw) -> float:
    return 0.0
