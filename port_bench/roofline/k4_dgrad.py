"""K4 dgrad: ``ops/kernels/psconv.py::psconv_dgrad``, the data gradient of
the s2d 3×3 conv (the adjoint kernel). Operations: 2 × every
full-resolution pixel × 9 taps × C_in × C_out; bytes: in and out once."""

WRAPPER = ("mingraph_unet_tpu_torch.ops.kernels.psconv", "psconv_dgrad")


def flops(g_s2d, kernel, *rest, **kw) -> float:
    b, hh, ww, _ = g_s2d.shape
    return 2.0 * b * hh * ww * 4 * 9 * kernel.shape[2] * kernel.shape[3]
