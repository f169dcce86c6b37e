"""K1: ``ops/kernels/psconv.py::psel_conv3x3``, the s2d 3×3 conv (eval,
bias and ReLU fused). Operations: 2 × every full-resolution pixel × 9 taps
× C_in × C_out; bytes: the tensors in and out, each once."""

WRAPPER = ("mingraph_unet_tpu_torch.ops.kernels.psconv", "psel_conv3x3")


def flops(x_s2d, kernel, *rest, **kw) -> float:
    b, hh, ww, _ = x_s2d.shape
    return 2.0 * b * hh * ww * 4 * 9 * kernel.shape[2] * kernel.shape[3]
