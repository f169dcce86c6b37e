"""The fused inference ConvBlock (K8, mingraph_unet_tpu_torch/ops/kernels/
conv_block.py) against the JAX package's Pallas kernel
(ops/pallas/conv_block.py) in interpret mode, on the CPU, where the wrapper
runs its plain PyTorch version; and against the port's own ConvBlock.

Tolerances: f32 5e-5 absolute, as the JAX test holds its kernel to its
reference (the same f32 products summed in another order, through two
convs); bf16 outputs 2^-7 of max |JAX| (both sides compute in f32 and round
once, so they differ by at most one bf16 step where the f32 results
straddle a rounding boundary); the port's ConvBlock in f32 1e-5.

The card kernel's own arithmetic is checked here too: its weight packing
(hi + lo within 2^-16 of each weight: two roundings to 8 significant bits)
and a plain f32 emulation of its bf16 hi/lo split, held to the card's f32
tolerance, 1e-4 of max |reference|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mingraph_unet_tpu.ops.pallas import conv_block as jax_cb
from mingraph_unet_tpu_torch.models import unet as t_unet
from mingraph_unet_tpu_torch.models.unet import UNet
from mingraph_unet_tpu_torch.ops.conv import conv2d_nhwc
from mingraph_unet_tpu_torch.ops.kernels import conv_block as t_cb
from mingraph_unet_tpu_torch.parallel import mesh as t_mesh
from mingraph_unet_tpu_torch.parallel import spatial as t_spatial


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


def _perturb(model, g):
    """BN statistics and every bias away from their init (zeros), so folding
    BN in changes every conv and the conv biases pass through its scale."""
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.copy_(torch.randn(buf.shape, generator=g) * 0.2 if name.endswith(".mean")
                      else torch.rand(buf.shape, generator=g) + 0.5)
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)


def _folded_block(block, x):
    """A standard-layout ConvBlock's eval forward in the folded form: each
    conv with BN folded into its kernel (``ConvBlock.folded``) through
    ``conv2d_nhwc``, then ReLU."""
    for i in (1, 2):
        k, b = block.folded(i)
        x = torch.relu(conv2d_nhwc(x, k, b, padding=1))
    return x


def test_fused_conv_block_plain_equals_unet_standard_block():
    """K8's plain version on a standard-layout ConvBlock of an f32 port
    U-Net, with its own kernels and fold_bn of its conv biases and BN,
    equals the block in the folded form (BN folded into the kernels)."""
    model = UNet(torch.Generator().manual_seed(0), init_features=4, depth=3).eval()
    g = torch.Generator().manual_seed(1)
    _perturb(model, g)
    for block in (model.encoder.block2, model.encoder.bottleneck, model.decoder.block0.conv_block):
        cin = block.conv1.kernel.shape[2]
        x = torch.randn((2, 6, 10, cin), generator=g)
        args = []
        for conv, bn in ((block.conv1, block.bn1), (block.conv2, block.bn2)):
            s, b = t_cb.fold_bn(conv.bias, bn.scale, bn.bias, bn.mean, bn.var, bn.epsilon)
            args += [conv.kernel, s, b]
        with torch.no_grad():
            got = t_cb.fused_conv_block_plain(x, *args)
            ref = _folded_block(block, x)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


# A depth-4 U-Net at 32²: levels 0 and 1 run in s2d, and the five
# standard-layout ConvBlocks (encoder levels 2 and 3, the bottleneck, the
# decoder levels 3 and 2) take these inputs at init_features 4, in order.
STANDARD_INPUTS = [(2, 8, 8, 8), (2, 4, 4, 16), (2, 2, 2, 32), (2, 4, 4, 64), (2, 8, 8, 32)]


def _unet(seed=0, **options):
    model = UNet(torch.Generator().manual_seed(seed), init_features=4, depth=4, **options)
    _perturb(model, torch.Generator().manual_seed(seed + 1))
    return model


@pytest.mark.parametrize("mode", ["f32_eval", "bf16_eval", "f32_train", "f32_eval_spatial"])
def test_unet_dispatches_standard_blocks_to_fused_conv_block(mode, monkeypatch):
    """Every standard-layout ConvBlock of an f32 eval forward is one
    ``fused_conv_block`` call on the block's input; a bf16 eval forward, a
    train forward and an eval forward on an H-shard make none."""
    calls = []

    def spy(x, *args):
        calls.append((tuple(x.shape), x.dtype))
        return t_cb.fused_conv_block(x, *args)

    monkeypatch.setattr(t_unet, "fused_conv_block", spy)
    model = _unet(dtype=torch.bfloat16 if mode == "bf16_eval" else torch.float32).train(mode == "f32_train")
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(2))
    spatial = t_spatial.SpatialShard(t_mesh.make_mesh(), 0, 32) if mode == "f32_eval_spatial" else None
    with torch.set_grad_enabled(mode == "f32_train"):
        model(x, spatial=spatial)
    assert calls == ([(s, torch.float32) for s in STANDARD_INPUTS] if mode == "f32_eval" else [])


@pytest.mark.parametrize("use_batchnorm", [True, False])
def test_f32_eval_unet_logits_equal_the_folded_form(use_batchnorm, monkeypatch):
    """The f32 eval U-Net with its standard blocks on ``fused_conv_block``
    (BN as the scale/shift after each raw conv; scale 1 and the conv bias
    without BN) gives the logits of the same model with those blocks in the
    folded form, within 1e-5."""
    model = _unet(seed=3, use_batchnorm=use_batchnorm).eval()
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = model(x)["logits"]
        monkeypatch.setattr(t_unet.ConvBlock, "_forward", lambda block, x, spatial: _folded_block(block, x))
        ref = model(x)["logits"]
    assert not torch.equal(got, torch.zeros_like(got))
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


def test_scale_shift_without_batchnorm_is_the_raw_conv():
    block = _unet(use_batchnorm=False).encoder.block2
    k, s, b = block.scale_shift(2)
    assert k is block.conv2.kernel and b is block.conv2.bias and torch.equal(s, torch.ones_like(b))


# ---------------------------------------------------------------------------
# The card kernel's arithmetic: weights split into bf16 hi/lo pairs and packed
# into its stream of 16 KB stages, and products taken as hi·hi + hi·lo + lo·hi.
# ---------------------------------------------------------------------------

F32_TOL = 1e-4  # the card's f32 tolerance (chip_smoke.py, test_torch_card.py), of max |reference|

# chip_smoke.py's odd f32 shapes (B, H, W, Cin, C, every b1 > 0): Cin 1 and 3,
# every channel tile, C 1024 and 600 in several tiles.
ODD_SHAPES = [(1, 9, 7, 1, 8, True), (2, 13, 11, 3, 32, True), (1, 11, 19, 16, 64, False),
              (1, 10, 6, 64, 128, True), (1, 5, 9, 96, 256, False), (1, 6, 5, 256, 512, False),
              (1, 4, 6, 512, 1024, False), (2, 5, 3, 40, 600, True)]


def _card_params(rng, cin, c, positive_b1):
    """Weights at He scale and BN-like scales, as chip_smoke.py draws them."""
    w1 = (rng.standard_normal((3, 3, cin, c)) * (2.0 / (9 * cin)) ** 0.5).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, c, c)) * (2.0 / (9 * c)) ** 0.5).astype(np.float32)
    s1, s2 = (rng.random(c) + 0.5).astype(np.float32), (rng.random(c) + 0.5).astype(np.float32)
    b1 = (rng.random(c) + 0.5 if positive_b1 else rng.standard_normal(c) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return w1, s1, b1, w2, s2, b2


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 1e30])
def test_split_bf16_rebuilds_f32(scale):
    """hi + lo is the f32 value within 2^-16 of its magnitude, at any scale;
    hi is the value rounded to bf16."""
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(4096).astype(np.float32) * scale)
    hi, lo = t_cb.split_bf16(w)
    assert hi.dtype == lo.dtype == torch.bfloat16
    torch.testing.assert_close(hi, w.to(torch.bfloat16), rtol=0, atol=0)
    err = (hi.double() + lo.double() - w.double()).abs()
    assert (err <= 2.0**-16 * w.double().abs()).all(), (err / w.double().abs()).max()


def _unpack(stream, cin, c):
    """The weights (9, Cin_p, C1p) and (9, C1p, C2p) that ``stream`` holds
    (hi + lo), read back by the layout ``csrc/conv_block.cu`` consumes:
    per channel tile and h chunk, conv1's stages (x chunk, tap, 4 k-steps of
    a hi and a lo 16 × 64 slab), then conv2's (tap, 4 k-steps of a hi and a
    lo 16 × NT slab); a slab holds (k, n) at ((n // 8) * 2 + k // 8) * 64 +
    (n % 8) * 8 + k % 8."""
    nt = t_cb.channel_tile(c)
    ntl, hc, _ = stream.shape
    xc = -(-cin // 64)
    s = stream.float().numpy()
    k, n1, n = np.arange(16)[:, None], np.arange(64)[None, :], np.arange(nt)[None, :]
    at1 = ((n1 // 8) * 2 + k // 8) * 64 + (n1 % 8) * 8 + k % 8
    at2 = ((n // 8) * 2 + k // 8) * 64 + (n % 8) * 8 + k % 8
    w1 = np.zeros((ntl, 9, xc * 64, hc * 64), np.float32)
    w2 = np.zeros((9, hc * 64, ntl * nt), np.float32)
    one = xc * 9 * 4 * 2 * 1024
    for t in range(ntl):
        for h in range(hc):
            for x in range(xc):
                for tap in range(9):
                    for ks in range(4):
                        base = (((x * 9 + tap) * 4 + ks) * 2) * 1024
                        w1[t, tap, x * 64 + ks * 16:x * 64 + ks * 16 + 16, h * 64:h * 64 + 64] = (
                            s[t, h, base + at1] + s[t, h, base + 1024 + at1])
            for tap in range(9):
                for ks in range(4):
                    base = one + ((tap * 4 + ks) * 2) * 16 * nt
                    w2[tap, h * 64 + ks * 16:h * 64 + ks * 16 + 16, t * nt:t * nt + nt] = (
                        s[t, h, base + at2] + s[t, h, base + 16 * nt + at2])
    assert all((w1[t] == w1[0]).all() for t in range(ntl)), "conv1's stages differ between channel tiles"
    return w1[0], w2


@pytest.mark.parametrize("cin,c", [(1, 8), (3, 32), (16, 64), (64, 128), (96, 256), (40, 600), (256, 512)])
def test_pack_weights_unpacks_to_the_weights(cin, c):
    """The stream rebuilds both kernels within the split's 2^-16, holds the
    stage count the kernel walks, and is zero wherever it pads: input
    channels to a multiple of 64 (Cin 1 and 3 fill one k-step of 16 of a
    64-channel chunk), h channels to C1p, output channels to whole tiles."""
    rng = np.random.default_rng(cin + c)
    w1 = _t(rng.standard_normal((3, 3, cin, c)).astype(np.float32))
    w2 = _t(rng.standard_normal((3, 3, c, c)).astype(np.float32))
    stream = t_cb.pack_weights(w1, w2)
    nt = t_cb.channel_tile(c)
    ntl, hc, xc = -(-c // nt), -(-c // 64), -(-cin // 64)
    assert stream.dtype == torch.bfloat16 and stream.is_contiguous()
    assert tuple(stream.shape) == (ntl, hc, 9 * (xc + nt // 64) * t_cb.STAGE_BYTES // 2)
    got1, got2 = _unpack(stream, cin, c)
    ref1, ref2 = w1.reshape(9, cin, c).numpy(), w2.reshape(9, c, c).numpy()
    np.testing.assert_allclose(got1[:, :cin, :c], ref1, rtol=2.0**-16, atol=0)
    np.testing.assert_allclose(got2[:, :c, :c], ref2, rtol=2.0**-16, atol=0)
    assert not got1[:, cin:].any() and not got1[:, :, c:].any()
    assert not got2[:, c:].any() and not got2[:, :, c:].any()


def _split_f32(t):
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _split_emulation(x, w1, s1, b1, w2, s2, b2):
    """The card kernel's arithmetic in plain f32: each conv as
    hi·hi + hi·lo + lo·hi over bf16-rounded operands (products of two bf16
    values are exact in f32), a bf16 x's lo being zero; h split the same
    way before conv2. Only the summation order differs from the card."""

    def conv(a, w):
        return F.conv2d(a.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)

    def split_conv(a, w):
        (ah, al), (wh, wl) = _split_f32(a), _split_f32(w)
        return conv(ah, wh) + conv(ah, wl) + conv(al, wh)

    h = torch.relu(split_conv(x.float(), w1) * s1 + b1)
    return torch.relu(split_conv(h, w2) * s2 + b2)


@pytest.mark.parametrize("shape", ODD_SHAPES)
def test_split_arithmetic_matches_pallas_f32(shape):
    """The split arithmetic meets the card's f32 tolerance against the JAX
    Pallas kernel (interpret mode, f32 x) at the card's odd shapes, before
    the card runs it."""
    b, h, w, cin, c, positive_b1 = shape
    rng = np.random.default_rng(b * h * w + c)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    params = _card_params(rng, cin, c, positive_b1)
    ref = _jax(jnp.asarray(x), params)
    got = _split_emulation(_t(x), *map(_t, params)).numpy()
    assert np.abs(got - ref).max() <= F32_TOL * np.abs(ref).max()


@pytest.mark.parametrize("shape", [(2, 16, 16, 64, 128), (1, 8, 8, 128, 256), (1, 6, 5, 256, 512)])
def test_split_arithmetic_matches_reference_bf16_x(shape):
    """On bf16 x (lo zero: conv1 takes two products) the split arithmetic
    meets the f32 tolerance against JAX's ``conv_block_reference`` on the
    same values, widened to f32."""
    b, h, w, cin, c = shape
    rng = np.random.default_rng(cin * c)
    x = np.asarray(jnp.asarray(rng.standard_normal((b, h, w, cin)), jnp.bfloat16).astype(jnp.float32))
    params = _card_params(rng, cin, c, False)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_cb.conv_block_reference(jnp.asarray(x), *map(jnp.asarray, params)), np.float32)
    xt = _t(x)
    assert torch.equal(xt, xt.to(torch.bfloat16).float())
    got = _split_emulation(xt, *map(_t, params)).numpy()
    assert np.abs(got - ref).max() <= F32_TOL * np.abs(ref).max()
