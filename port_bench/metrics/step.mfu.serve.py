"""The model FLOPs of one unit of work (``port_bench/core.py``: 2 × the
multiply-adds of every convolution, transposed convolution, linear layer
and attention product; a train step is 3 × the forward) over its mean time
in the measured window, as a share in % of the peak of the configuration's
precision (bf16 989 TFLOP/s; f32 989 / 3, the three bf16 products of the
port's hi/lo split)."""


def read(ctx):
    if ctx.kind != "serve" or not ctx.unit_s:
        return None
    return 100.0 * ctx.flops_per_unit / ctx.unit_s / ctx.peak
