"""K4 forward: ``ops/kernels/psconv.py::psconv_fwd``, the train-mode s2d
3×3 conv (no bias, no ReLU). Operations: 2 × every full-resolution pixel ×
9 taps × C_in × C_out; bytes: the tensors in and out, each once."""

WRAPPER = ("mingraph_unet_tpu_torch.ops.kernels.psconv", "psconv_fwd")


def flops(x_s2d, kernel, *rest, **kw) -> float:
    b, hh, ww, _ = x_s2d.shape
    return 2.0 * b * hh * ww * 4 * 9 * kernel.shape[2] * kernel.shape[3]
