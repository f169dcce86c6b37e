"""K2: ``ops/kernels/psconv.py::dec_conv1_fused``, a decoder level's conv1
over [skip ‖ ConvTranspose(x_prev)] with the ConvTranspose folded into
x_prev's taps. Operations, the least the function needs: per
full-resolution pixel the skip's 9 taps (9 · C_skip · C_out) and the 4 live
taps of x_prev (4 · C_prev · C_out), × 2; bytes: in and out once."""

WRAPPER = ("mingraph_unet_tpu_torch.ops.kernels.psconv", "dec_conv1_fused")


def flops(x_skip_s2d, x_prev, k_skip, *rest, **kw) -> float:
    b, hh, ww, z = x_skip_s2d.shape
    cout = k_skip.shape[-1]
    return 2.0 * b * hh * ww * 4 * (9 * (z // 4) + 4 * x_prev.shape[-1]) * cout
