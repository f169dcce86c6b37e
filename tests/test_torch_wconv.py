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
from mingraph_unet_tpu_torch.models import unet as t_unet
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


def _k7_k8_calls(monkeypatch, dtype):
    """The K7 and K8 entry points that a serving forward in ``dtype`` calls,
    in order: both wrappers (and their plain versions) replaced by spies
    that record any call, the U-Net's K8 returning its plain result."""
    calls = []

    def spy(name, real=None):
        return lambda *a, **k: calls.append(name) or (real(*a, **k) if real else None)

    plain = t_cb.fused_conv_block_plain
    for mod, names in ((t_wconv, ("wconv3x3_s2d", "wconv3x3_s2d_plain")),
                       (t_cb, ("fused_conv_block", "fused_conv_block_plain"))):
        for n in names:
            monkeypatch.setattr(mod, n, spy(n))
    monkeypatch.setattr(t_unet, "fused_conv_block", spy("fused_conv_block", plain))
    x = torch.randn((1, 64, 64, 3), generator=torch.Generator().manual_seed(4))
    model = t_pipeline.MinGraphUNet(device="cpu", init_features=8, depth=2, detection_pre_pool=4, dtype=dtype)
    out = model(x)
    assert torch.isfinite(out["logits"]).all()
    return calls


def test_serving_forward_calls_neither_k7_nor_k8(monkeypatch):
    """As in JAX, no entry point of the serving forward in bf16 (the
    serving precision) dispatches K7 or K8."""
    assert _k7_k8_calls(monkeypatch, torch.bfloat16) == []


def test_f32_serving_forward_calls_k8_only_at_its_standard_block_and_never_k7(monkeypatch):
    """In f32 the U-Net's standard-layout ConvBlocks of an eval forward
    dispatch K8 (depth 2 at 64²: the bottleneck is the one standard block,
    one call); nothing dispatches K7."""
    assert _k7_k8_calls(monkeypatch, torch.float32) == ["fused_conv_block"]


def _unpack_wgmma_chunks(packed, groups, cout):
    """The bf16 kernel's weight chunks read back into w2 (16·Cin, 4·Cout).
    Chunk order: s2d channels in steps of 16, one chunk a step where every
    group width is a multiple of 16 (the step's own phase), else four (one
    a phase). A chunk of phase (py, px) holds 4 slabs, slab j for window
    tap (dy, dx) with dy the j // 2-th tap reading input-phase row py (1, 3
    for py = 0; 0, 2 for py = 1), dx likewise from j % 2; slab row s is s2d
    channel 16·step + s, which tap d reads as w2 row d·Cin + (its group's
    offset) + c when the channel is phase (py, px) of its group, and which
    must be zero otherwise. Within a slab, (k, n) sits at
    [n // 8, k // 8, n % 8, k % 8]. Returns w2 and the largest entry that
    should have been zero."""
    cin = sum(groups)
    owner, goff = [], 0
    for gw in groups:
        owner += [(goff, ph, c) for ph in range(4) for c in range(gw)]
        goff += gw
    dense = any(g % 16 for g in groups)
    chunks = [(st, ph) for st in range(0, 4 * cin, 16) for ph in (range(4) if dense else [owner[st][1]])]
    assert packed.shape[1] == len(chunks)
    taps = ((1, 3), (0, 2))
    ncb, np_ = packed.shape[0], packed.shape[3] * 8
    w = torch.zeros((16 * cin, ncb * np_), dtype=packed.dtype)
    stray = 0.0
    for i, (st, ph) in enumerate(chunks):
        for j in range(4):
            d = 4 * taps[ph >> 1][j >> 1] + taps[ph & 1][j & 1]
            block = torch.cat([packed[cb, i, j].permute(1, 3, 0, 2).reshape(16, np_) for cb in range(ncb)], dim=1)
            for k in range(16):
                ch = st + k
                if ch < 4 * cin and owner[ch][1] == ph:
                    w[d * cin + owner[ch][0] + owner[ch][2]] = block[k]
                else:
                    stray = max(stray, block[k].abs().max().item())
            if block.shape[1] > 4 * cout:  # the columns past 4·Cout
                stray = max(stray, block[:, 4 * cout :].abs().max().item())
    return w[:, : 4 * cout], stray


@pytest.mark.parametrize("groups,cout", [((3,), 32), ((5,), 4), ((2, 4), 4), ((64, 64), 64), ((16,), 70),
                                         ((5,), 3), ((2, 4), 5)])
def test_wgmma_weight_chunks_zero_padding_reproduces_plain(groups, cout):
    """The bf16 kernel's K packing: chunks of 16 channels, zero rows for the
    pad and for channels of another phase, 4·Cout padded to the wgmma width
    (and cut in 256-column blocks above it). Unpacked by an independent
    formula, it holds w2 and zeros elsewhere, and the plain version run
    with it gives the plain result exactly (integer data: every sum is
    exact)."""
    cin = sum(groups)
    rng = np.random.default_rng(cin + cout)
    x = _t(rng.integers(-3, 4, (2, 5, 7, 4 * cin)).astype(np.float64))
    w2 = _t(rng.integers(-3, 4, (16 * cin, 4 * cout)).astype(np.float64))
    bias = _t(rng.integers(-3, 4, cout).astype(np.float64))
    packed = t_wconv.wgmma_weight_chunks(w2, groups, cout)
    w2u, stray = _unpack_wgmma_chunks(packed, groups, cout)
    assert stray == 0
    torch.testing.assert_close(t_wconv.wconv3x3_s2d_plain(x, w2u, bias, groups),
                               t_wconv.wconv3x3_s2d_plain(x, w2, bias, groups), rtol=0, atol=0)
    torch.testing.assert_close(w2u, w2, rtol=0, atol=0)


@pytest.mark.parametrize("dtype,mma", [(torch.bfloat16, True), (torch.float32, False)])
def test_wconv_uses_tensor_cores_for_every_bf16_width(dtype, mma):
    """bf16 runs wgmma at every width (the odd ones through the zero padding
    above), f32 the SIMT kernel."""
    assert t_wconv.wconv_uses_mma(dtype) is mma
