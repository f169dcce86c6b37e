"""Plain PyTorch reference of the configurations the benchmark runs.

It imports neither JAX nor any package of this repository: every function
is written here from the model's equations (NHWC activations, HWIO conv
kernels, the parameter names of the flax tree the port keeps). Weights are
a flat ``{name: tensor}`` dict that the benchmark draws
(``port_bench/weights.py``) and hands to both sides.

``precision`` selects how every convolution, linear layer and attention
product is computed: ``"f32"`` (TF32 off: the reference), ``"tf32"``
(TF32 on the card; on the CPU its inputs rounded to TF32's 10-bit
mantissa) and ``"fp8"`` (inputs rounded to float8 e4m3 with a per-tensor
scale, products in f32). The last two are the controls of the f32 and the
bf16 configurations.
"""
