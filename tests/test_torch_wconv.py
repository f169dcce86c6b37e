"""The windowed s2d conv (K7, mingraph_unet_tpu_torch/ops/kernels/wconv.py)
against the JAX package's Pallas kernel (ops/pallas/wconv.py) in interpret
mode, on the CPU, where the wrapper runs its plain PyTorch version; and
against the port's own s2d convs at the U-Net's sites.

Tolerances: f32 1e-5 absolute (both sides sum the same f32 products in
another order; the JAX test holds the kernel to the direct conv at 1e-5);
bf16 outputs 1e-2 of max |JAX| (both round one f32 sum to bf16, so they
differ by at most one bf16 rounding where the sums straddle a rounding
boundary). The weights are a gather and must be equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingraph_unet_tpu.ops import s2d as jax_s2d
from mingraph_unet_tpu.ops.pallas import wconv as jax_wconv
from mingraph_unet_tpu_torch.models import pipeline as t_pipeline
from mingraph_unet_tpu_torch.models.unet import UNet
from mingraph_unet_tpu_torch.ops import s2d as t_s2d
from mingraph_unet_tpu_torch.ops.kernels import conv_block as t_cb
from mingraph_unet_tpu_torch.ops.kernels import psconv as t_psconv
from mingraph_unet_tpu_torch.ops.kernels import wconv as t_wconv


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("cin,cout", [(8, 16), (5, 4), (6, 4), (32, 32), (3, 32)])
def test_wconv_weights_bit_equal_to_jax(cin, cout):
    k = (np.random.default_rng(cin).standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    ref = np.asarray(jax_wconv.wconv3x3_weights(jnp.asarray(k)))
    got = t_wconv.wconv3x3_weights(_t(k)).numpy()
    assert got.shape == ref.shape == (16 * cin, 4 * cout)
    assert got.tobytes() == ref.tobytes()


def _case(cin, cout, h, w, groups, seed=0):
    """The JAX test's inputs (tests/test_pallas_kernels.py): a full-res x
    turned to s2d per group, a 3×3 kernel and a bias."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((2, h, w, cin)).astype(np.float32)
    k = (r.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = r.standard_normal((cout,)).astype(np.float32)
    offs = np.cumsum((0,) + (groups or (cin,)))
    xs = np.concatenate([np.asarray(jax_s2d.space_to_depth(jnp.asarray(x[..., offs[i]:offs[i + 1]])))
                         for i in range(len(offs) - 1)], -1)
    return xs, k, b


# The JAX test's cases, a U-Net conv2 width (32 → 32) and an H/2 that is
# not a multiple of JAX's row tile.
WCONV_CASES = [(8, 16, 16, 16, ()), (5, 4, 8, 12, ()), (6, 4, 8, 8, (2, 4)), (32, 32, 16, 16, ()),
               (16, 8, 10, 14, (8, 8))]


@pytest.mark.parametrize("cin,cout,h,w,groups", WCONV_CASES)
@pytest.mark.parametrize("relu", [True, False])
def test_wconv_plain_matches_pallas(cin, cout, h, w, groups, relu):
    xs, k, b = _case(cin, cout, h, w, groups)
    with jax.default_matmul_precision("highest"):
        ref = jax_wconv.wconv3x3_s2d(jnp.asarray(xs), jax_wconv.wconv3x3_weights(jnp.asarray(k)), jnp.asarray(b),
                                     groups=groups, relu=relu, row_tile=4, interpret=True)
    w2 = t_wconv.wconv3x3_weights(_t(k))
    got = t_wconv.wconv3x3_s2d(_t(xs), w2, _t(b), groups=groups, relu=relu)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.numpy(), t_wconv.wconv3x3_s2d_plain(_t(xs), w2, _t(b), groups, relu).numpy())


@pytest.mark.parametrize("cin,cout,h,w,groups", [(32, 32, 16, 16, ()), (6, 4, 8, 8, (2, 4))])
def test_wconv_plain_bf16_matches_pallas(cin, cout, h, w, groups):
    """bf16 in, bf16 out: w2 cast to bf16, products summed in f32, one
    rounding."""
    xs, k, b = _case(cin, cout, h, w, groups, seed=3)
    ref = jax_wconv.wconv3x3_s2d(jnp.asarray(xs, jnp.bfloat16), jax_wconv.wconv3x3_weights(jnp.asarray(k)),
                                 jnp.asarray(b), groups=groups, row_tile=4, interpret=True)
    got = t_wconv.wconv3x3_s2d(_t(xs).to(torch.bfloat16), t_wconv.wconv3x3_weights(_t(k)), _t(b), groups=groups)
    assert got.dtype == torch.bfloat16
    ref = np.asarray(ref, np.float32)
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= 1e-2 * np.abs(ref).max(), err


def _unet():
    model = UNet(torch.Generator().manual_seed(0), init_features=8, depth=2).eval()
    g = torch.Generator().manual_seed(1)
    for name, buf in model.named_buffers():  # perturbed BN statistics: a real fold
        buf.copy_(torch.randn(buf.shape, generator=g) * 0.2 if name.endswith(".mean")
                  else torch.rand(buf.shape, generator=g) + 0.5)
    return model


def test_wconv_plain_equals_psel_plain_at_unet_conv2():
    """At an s2d ConvBlock's conv2 (f32, BN folded) K7's plain version and
    K1's compute the same function."""
    block = _unet().encoder.block0
    k, b = block.folded(2)
    x = torch.randn((2, 8, 12, 4 * 8), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref = t_psconv.psel_conv3x3_plain(x, k, b)
        got = t_wconv.wconv3x3_s2d_plain(x, t_wconv.wconv3x3_weights(k), b)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


def test_wconv_grouped_equals_dec_conv1_plain_at_unet_decoder():
    """At an s2d decoder block's conv1, K7 over [skip ‖ s2d(upsample)] with
    groups (skip_c, up_c) equals the fused decoder conv1's plain version."""
    dec = _unet().decoder.block1  # level 0: skip 8, up 8, out 8
    g = torch.Generator().manual_seed(3)
    skip = torch.randn((2, 6, 10, 32), generator=g)
    x_prev = torch.randn((2, 6, 10, 16), generator=g)
    cb = dec.conv_block
    k, b = cb.folded(1)
    wt = t_s2d.s2d_convt2x2_kernel(dec.upsample.kernel)
    with torch.no_grad():
        up = x_prev @ wt + t_s2d.s2d_vector(dec.upsample.bias)
        got = t_wconv.wconv3x3_s2d_plain(torch.cat([skip, up], -1), t_wconv.wconv3x3_weights(k), b, groups=(8, 8))
        k_skip, k_prev = t_psconv.dec_conv1_weights(k, 8, wt)
        t9 = t_psconv.dec_conv1_bias_table(k, 8, dec.upsample.bias, b)
        ref = t_psconv.dec_conv1_fused_plain(skip, x_prev, k_skip, k_prev, t9)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


def test_serving_forward_calls_neither_k7_nor_k8(monkeypatch):
    """As in JAX, no entry point dispatches K7 or K8: the serving forward
    runs with both wrappers (and their plain versions) replaced by spies
    that record any call."""
    calls = []

    def spy(name):
        return lambda *a, **k: calls.append(name)

    for mod, names in ((t_wconv, ("wconv3x3_s2d", "wconv3x3_s2d_plain")),
                       (t_cb, ("fused_conv_block", "fused_conv_block_plain"))):
        for n in names:
            monkeypatch.setattr(mod, n, spy(n))
    model = t_pipeline.MinGraphUNet(device="cpu", init_features=8, depth=2, detection_pre_pool=4)
    out = model(torch.randn((1, 64, 64, 3), generator=torch.Generator().manual_seed(4)))
    assert torch.isfinite(out["logits"]).all()
    assert calls == []
