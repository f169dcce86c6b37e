"""The fused inference ConvBlock (K8, mingraph_unet_tpu_torch/ops/kernels/
conv_block.py) against the JAX package's Pallas kernel
(ops/pallas/conv_block.py) in interpret mode, on the CPU, where the wrapper
runs its plain PyTorch version; and against the port's own ConvBlock.

Tolerances: f32 5e-5 absolute, as the JAX test holds its kernel to its
reference (the same f32 products summed in another order, through two
convs); bf16 outputs 2^-7 of max |JAX| (both sides compute in f32 and round
once, so they differ by at most one bf16 step where the f32 results
straddle a rounding boundary); the port's ConvBlock in f32 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingraph_unet_tpu.ops.pallas import conv_block as jax_cb
from mingraph_unet_tpu_torch.models.unet import UNet
from mingraph_unet_tpu_torch.ops.kernels import conv_block as t_cb


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _params(rng, cin, c, positive_b1=False):
    """The JAX test's parameters; with ``positive_b1`` every b1 > 0, so an
    h border that conv2 does not see as zero changes the result."""
    w1 = (rng.standard_normal((3, 3, cin, c)) * 0.2).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, c, c)) * 0.2).astype(np.float32)
    s1 = (rng.random(c) + 0.5).astype(np.float32)
    b1 = (rng.random(c) + 0.5 if positive_b1 else rng.standard_normal(c) * 0.1).astype(np.float32)
    s2 = (rng.random(c) + 0.5).astype(np.float32)
    b2 = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return w1, s1, b1, w2, s2, b2


# tests/test_pallas_kernels.py's shapes (B, H, W, Cin, C), and an H that is
# not a multiple of the TPU kernel's band.
SHAPES = [(1, 8, 8, 1, 1), (2, 32, 32, 3, 32), (1, 128, 16, 8, 16), (1, 10, 6, 3, 8)]


def _jax(x, params):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax_cb.fused_conv_block(x, *map(jnp.asarray, params), interpret=True), np.float32)


@pytest.mark.parametrize("positive_b1", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_conv_block_plain_matches_pallas(shape, positive_b1):
    b, h, w, cin, c = shape
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    params = _params(rng, cin, c, positive_b1)
    ref = _jax(jnp.asarray(x), params)
    got = t_cb.fused_conv_block(_t(x), *map(_t, params))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5, rtol=0)


def test_positive_b1_needs_the_zero_h_border():
    """With every b1 > 0, an h border of relu(b1) (conv1 run over the
    zero-padded input) gives another result: the case has teeth."""
    rng = np.random.default_rng(0)
    x = _t(rng.standard_normal((1, 10, 6, 3)).astype(np.float32))
    w1, s1, b1, w2, s2, b2 = map(_t, _params(rng, 3, 8, positive_b1=True))
    ref = t_cb.fused_conv_block_plain(x, w1, s1, b1, w2, s2, b2)

    def conv(a, k):  # VALID
        return torch.nn.functional.conv2d(a.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)

    xp = torch.nn.functional.pad(x, (0, 0, 2, 2, 2, 2))
    h_unzeroed = torch.relu(conv(xp, w1) * s1 + b1)  # over the padded grid, border included
    wrong = torch.relu(conv(h_unzeroed, w2) * s2 + b2)
    assert (wrong - ref).abs().max() > 1e-2


@pytest.mark.parametrize("shape", [(2, 32, 32, 3, 32), (1, 10, 6, 3, 8)])
def test_fused_conv_block_plain_bf16_matches_pallas(shape):
    b, h, w, cin, c = shape
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    params = _params(rng, cin, c)
    ref = _jax(jnp.asarray(x, jnp.bfloat16), params)
    got = t_cb.fused_conv_block(_t(x).to(torch.bfloat16), *map(_t, params))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= 2**-7 * np.abs(ref).max(), err


def test_fold_bn_matches_jax():
    rng = np.random.default_rng(1)
    c = 6
    args = [rng.standard_normal(c), rng.random(c) + 0.5, rng.standard_normal(c), rng.standard_normal(c),
            rng.random(c) + 0.1]
    args = [a.astype(np.float32) for a in args]
    ref = jax_cb.fold_bn(*map(jnp.asarray, args))
    got = t_cb.fold_bn(*map(_t, args))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=0)


def test_fused_conv_block_plain_equals_unet_standard_block():
    """K8's plain version on a standard-layout ConvBlock of an f32 port
    U-Net, with its own kernels and fold_bn of its conv biases and BN,
    equals the block's eval forward (which folds BN into the kernels)."""
    model = UNet(torch.Generator().manual_seed(0), init_features=4, depth=3).eval()
    g = torch.Generator().manual_seed(1)
    for name, buf in model.named_buffers():
        buf.copy_(torch.randn(buf.shape, generator=g) * 0.2 if name.endswith(".mean")
                  else torch.rand(buf.shape, generator=g) + 0.5)
    for block in (model.encoder.block2, model.encoder.bottleneck, model.decoder.block0.conv_block):
        cin = block.conv1.kernel.shape[2]
        x = torch.randn((2, 6, 10, cin), generator=g)
        args = []
        for conv, bn in ((block.conv1, block.bn1), (block.conv2, block.bn2)):
            s, b = t_cb.fold_bn(conv.bias, bn.scale, bn.bias, bn.mean, bn.var, bn.epsilon)
            args += [conv.kernel, s, b]
        with torch.no_grad():
            got = t_cb.fused_conv_block_plain(x, *args)
            ref = block(x)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
