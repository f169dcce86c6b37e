"""The split-form train conv (K10, mingraph_unet_tpu_torch/ops/kernels/
conv3x3.py) on the CPU, where its wrappers run their plain PyTorch
versions: the plain forward and dgrad against ``conv2d_nhwc`` and its
autograd in f64, the autograd Function's gradients, the packed weight
stream (the kernel's and its adjoint's) read back by the layout the card
kernel consumes, the tile chosen from the widths (and K8's stream, which
K10's shares, as it was), a plain emulation of the card's bf16 hi/lo split,
and the dispatch of the U-Net's standard blocks' train convs and of the
detection head's convs.

Tolerances: f64 1e-12 relative (the same products summed in another
order); the split emulation 1e-4 of max |reference| (the card's f32
tolerance); the ConvBlock's loss and gradients through the Function 1e-5
relative to those through ``conv2d_nhwc`` (f32, dx summed by another conv),
and so are the detection head's outputs and gradients.
"""

import numpy as np
import pytest
import torch

from mingraph_unet_tpu_torch.models import detection as t_det
from mingraph_unet_tpu_torch.models.unet import ConvBlock, UNet
from mingraph_unet_tpu_torch.ops.conv import conv2d_nhwc
from mingraph_unet_tpu_torch.ops.kernels import conv3x3 as t_c3
from mingraph_unet_tpu_torch.ops.kernels import conv_block as t_cb

# (B, H, W, Cin, Cout): one chunk and several, widths that are not multiples
# of 64 (and of 4), Cout in one, two and three channel tiles.
SHAPES = [(2, 8, 16, 64, 128), (1, 5, 7, 3, 8), (2, 9, 17, 96, 40), (1, 4, 6, 130, 600), (1, 3, 3, 256, 512)]


def _case(shape, dtype, seed=0):
    b, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, h, w, cin), generator=g, dtype=dtype)
    k = torch.randn((3, 3, cin, cout), generator=g, dtype=dtype) * (2.0 / (9 * cin)) ** 0.5
    bias = torch.randn((cout,), generator=g, dtype=dtype) * 0.1
    return x, k, bias


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_and_dgrad_equal_conv2d_nhwc_and_its_autograd_f64(shape):
    x, k, bias = _case(shape, torch.float64)
    ref = conv2d_nhwc(x, k, bias, padding=1)
    torch.testing.assert_close(t_c3.conv3x3_fwd(x, k, bias), ref, rtol=0, atol=0)
    g = torch.randn(ref.shape, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    xr = x.clone().requires_grad_(True)
    (dx_ref,) = torch.autograd.grad(conv2d_nhwc(xr, k, bias, padding=1), xr, g)
    dx = t_c3.conv3x3_dgrad(g, k)
    assert dx.shape == x.shape and dx.dtype == torch.float64
    torch.testing.assert_close(dx, dx_ref, rtol=1e-12, atol=1e-12 * dx_ref.abs().max().item())


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_train_function_gradients_equal_conv2d_nhwc_f64(shape):
    """``conv3x3_train``'s output and its x, kernel and bias gradients equal
    ``conv2d_nhwc``'s under autograd; dk and db are the same weight-gradient
    call."""
    x, k, bias = _case(shape, torch.float64, seed=2)
    g = torch.randn(shape[:3] + (shape[4],), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    sides = []
    for fn in (lambda a, b, c: conv2d_nhwc(a, b, c, padding=1), t_c3.conv3x3_train):
        leaves = [t.clone().requires_grad_(True) for t in (x, k, bias)]
        y = fn(*leaves)
        sides.append([y] + list(torch.autograd.grad(y, leaves, g)))
    for got, ref in zip(*sides):
        assert got.shape == ref.shape
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12 * ref.abs().max().item())


def test_adjoint_is_the_flipped_transposed_kernel():
    k = torch.arange(3 * 3 * 2 * 5, dtype=torch.float32).reshape(3, 3, 2, 5)
    a = t_c3.adjoint(k)
    assert a.shape == (3, 3, 5, 2)
    for dy in range(3):
        for dx in range(3):
            assert torch.equal(a[dy, dx], k[2 - dy, 2 - dx].T)


def _unpack(stream, cin, cout):
    """The kernel (9, Cin_p, Cout_p) that ``stream`` holds (hi + lo), read
    back by the layout ``csrc/conv3x3.cu`` consumes: per channel tile, x
    chunk and tap, the chunk's k-steps (4; in the last chunk, with the
    narrow tile, ceil(channels left / 16)), each a hi and a lo 16 × NT slab, one after
    the other; a slab holds (k, n) at
    ((n // 8) * 2 + k // 8) * 64 + (n % 8) * 8 + k % 8."""
    nt, last = t_c3.tile(cin, cout)
    ntl, xc = stream.shape[0], -(-cin // 64)
    live = [4] * (xc - 1) + [last]
    s = stream.float().numpy()
    k, n = np.arange(16)[:, None], np.arange(nt)[None, :]
    at = ((n // 8) * 2 + k // 8) * 64 + (n % 8) * 8 + k % 8
    w = np.zeros((9, xc * 64, ntl * nt), np.float32)
    for t in range(ntl):
        j = 0  # k-step of the stream
        for x in range(xc):
            for tap in range(9):
                for ks in range(live[x]):
                    base = j * 2 * 16 * nt
                    w[tap, x * 64 + ks * 16:x * 64 + ks * 16 + 16, t * nt:t * nt + nt] = (
                        s[t, base + at] + s[t, base + 16 * nt + at])
                    j += 1
        assert j * 2 * 16 * nt == s.shape[1]
    return w


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("cin,cout", [(64, 128), (128, 64), (3, 8), (96, 40), (130, 600), (512, 512), (96, 48),
                                      (48, 24)])
def test_pack_weights_unpacks_to_the_weights(cin, cout, adjoint):
    """The stream (of the kernel, or of its adjoint as the dgrad packs it)
    rebuilds that kernel within the split's 2^-16, holds the k-steps the
    kernel walks (9 · the chunks' k-steps a channel tile, those of the last
    chunk cut where Cin ends with the narrow tile), and is zero wherever it
    pads: input channels to the last k-step, output channels to whole
    tiles."""
    k = torch.from_numpy(np.random.default_rng(cin + cout).standard_normal((3, 3, cin, cout)).astype(np.float32))
    want = t_c3.adjoint(k) if adjoint else k
    ci, co = want.shape[2], want.shape[3]
    stream = t_c3.pack_weights(want)
    nt, last = t_c3.tile(ci, co)
    ntl = -(-co // nt)
    live = 4 * (-(-ci // 64) - 1) + last
    assert stream.dtype == torch.bfloat16 and stream.is_contiguous()
    assert tuple(stream.shape) == (ntl, 9 * live * 2 * 16 * nt)
    got = _unpack(stream, ci, co)
    ref = want.reshape(9, ci, co).numpy()
    np.testing.assert_allclose(got[:, :ci, :co], ref, rtol=2.0**-16, atol=0)
    assert not got[:, ci:].any() and not got[:, :, co:].any()


# Widths whose Cin and Cout are multiples of 64 (the standard blocks' convs
# and their adjoints), and widths that are not (the detection head's convs
# and their adjoints first).
WIDE = [(64, 128), (128, 128), (128, 256), (256, 256), (256, 512), (512, 512), (512, 256), (256, 128), (128, 64),
        (64, 64), (64, 1024)]
NARROW = [(96, 48), (48, 24), (24, 48), (48, 96), (3, 8), (96, 40), (130, 600), (66, 64), (64, 48), (100, 128),
          (16, 200)]


@pytest.mark.parametrize("cin,cout", WIDE + NARROW)
def test_tile_is_narrow_only_off_multiples_of_64(cin, cout):
    """``tile`` gives NT, the smallest built width that holds Cout: K8's
    channel tile and all 4 k-steps of the last x chunk where Cin and Cout
    are multiples of 64; the narrow tile (NT 24, 48 or 96, the last chunk
    cut at Cin's last 16-channel k-step) only where they are not, and at the
    head's 96 → 48 → 24 and their adjoints."""
    nt, last = t_c3.tile(cin, cout)
    assert nt in t_c3.WIDTHS and (nt >= cout or nt == 256)
    assert all(n < cout for n in t_c3.WIDTHS if n < nt)
    if cin % 64 == 0 and cout % 64 == 0:
        assert nt == t_cb.channel_tile(cout) and nt not in t_c3.NARROW and last == 4
    if nt in t_c3.NARROW:
        assert cout % 64 != 0 and last == -(-(cin - 64 * (-(-cin // 64) - 1)) // 16)
    else:
        assert last == 4
    assert {(96, 48): (48, 2), (48, 24): (24, 3), (24, 48): (48, 2), (48, 96): (96, 3)}.get((cin, cout),
                                                                                         (nt, last)) == (nt, last)


def _pack_stream_by_index(wp, nt):
    """``conv_block.pack_stream`` written out element by element: for each
    ``nt``-column tile, 64-row chunk, tap and k-step, the hi then the lo
    16 × nt slab, (k, n) at ((n // 8) * 2 + k // 8) * 64 + (n % 8) * 8 + k % 8."""
    hl = t_cb.split_bf16(wp).float().numpy()
    kc, ntl = wp.shape[1] // 64, wp.shape[2] // nt
    out = np.zeros((ntl, kc, 9 * 4 * 2 * 16 * nt), np.float32)
    k, n = np.arange(16)[:, None], np.arange(nt)[None, :]
    at = ((n // 8) * 2 + k // 8) * 64 + (n % 8) * 8 + k % 8
    for t in range(ntl):
        for c in range(kc):
            for tap in range(9):
                for ks in range(4):
                    for h in range(2):
                        base = (((tap * 4 + ks) * 2) + h) * 16 * nt
                        rows = slice(c * 64 + ks * 16, c * 64 + ks * 16 + 16)
                        out[t, c, base + at] = hl[h, tap, rows, t * nt:(t + 1) * nt]
    return out


@pytest.mark.parametrize("cin,c", [(64, 64), (64, 128), (128, 256), (256, 512), (512, 256), (256, 128)])
def test_k8_channel_tile_and_pack_stream_hold_at_k8_widths(cin, c):
    """K8's channel tile and its weight stream are what they were at K8's
    widths (the five standard blocks' conv1 and conv2): ``channel_tile``
    64 / 128 / 256 and ``pack_stream`` equal to its layout written out
    element by element; and K10's stream at those widths is
    ``pack_stream`` as it is (every k-step live, no padding)."""
    assert t_cb.channel_tile(c) == min(max(64, c), 256) and t_cb.channel_tile(c) in (64, 128, 256)
    w = torch.from_numpy(np.random.default_rng(cin + c).standard_normal((3, 3, cin, c)).astype(np.float32))
    nt = t_cb.channel_tile(c)
    wp = w.reshape(9, cin, c)
    got = t_cb.pack_stream(wp, nt)
    assert tuple(got.shape) == (c // nt, cin // 64, 9 * 4 * 2 * 16 * nt)
    np.testing.assert_array_equal(got.float().numpy(), _pack_stream_by_index(wp, nt))
    np.testing.assert_array_equal(t_c3.pack_weights(w).float().numpy(), got.reshape(c // nt, -1).float().numpy())


def _split_f32(t):
    hi = t.to(torch.bfloat16).double()
    return hi, (t.double() - hi).to(torch.bfloat16).double()


@pytest.mark.parametrize("shape", SHAPES)
def test_split_emulation_holds_the_card_tolerance(shape):
    """The card kernel's arithmetic, x and the kernel as bf16 hi/lo pairs and
    each product hi·hi + hi·lo + lo·hi (each exact in f32), is within 1e-4
    of max |f64 conv|; so is its dgrad on the adjoint."""
    x, k, bias = _case(shape, torch.float32, seed=4)
    (xh, xl), (kh, kl) = _split_f32(x), _split_f32(k)

    def conv(a, w):
        return conv2d_nhwc(a, w, None, padding=1)

    got = conv(xh, kh) + conv(xh, kl) + conv(xl, kh) + bias.double()
    ref = conv(x.double(), k.double()) + bias.double()
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    g = torch.randn(ref.shape, generator=torch.Generator().manual_seed(5))
    (gh, gl), (ah, al) = _split_f32(g), _split_f32(t_c3.adjoint(k))
    got = conv(gh, ah) + conv(gh, al) + conv(gl, ah)
    ref = t_c3.conv3x3_dgrad(g.double(), k.double())
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


# ---------------------------------------------------------------------------
# The dispatch: ConvBlock's train convs on the kernel where the block is f32,
# unsharded and on the card.
# ---------------------------------------------------------------------------


class _Card:
    """A stand-in with a CUDA device, for the predicate alone."""

    device = torch.device("cuda")
    is_cuda = True

    def __init__(self, dtype):
        self.dtype = dtype


class _Shard:
    """A stand-in for ``SpatialShard`` on one rank: its 'SAME' conv."""

    def conv_same(self, x, kernel, bias):
        return conv2d_nhwc(x, kernel, bias, padding=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("card", [False, True])
def test_split_conv_predicate(dtype, sharded, card, monkeypatch):
    """``conv3x3.split_conv`` holds for an f32 tensor on the card; a
    train-mode ConvBlock asks it at both convs unsharded and never on an
    H-shard, whose conv is the shard's."""
    x = _Card(dtype) if card else torch.zeros(1, dtype=dtype)
    assert t_c3.split_conv(x) == (card and dtype == torch.float32)
    asked = []
    monkeypatch.setattr(t_c3, "split_conv", lambda t: asked.append(t.dtype) or False)
    block = ConvBlock(4, 4, torch.Generator().manual_seed(0), dtype).train()
    block(torch.zeros((1, 4, 4, 4)), _Shard() if sharded else None)
    assert asked == ([] if sharded else [dtype, dtype])


# A depth-4 U-Net at 32², init_features 4: the ten convs of the standard
# blocks (enc2, enc3, the bottleneck, dec3, dec2), their inputs in order.
TRAIN_SITES = [(2, 8, 8, 8), (2, 8, 8, 16), (2, 4, 4, 16), (2, 4, 4, 32), (2, 2, 2, 32), (2, 2, 2, 64),
               (2, 4, 4, 64), (2, 4, 4, 32), (2, 8, 8, 32), (2, 8, 8, 16)]


@pytest.mark.parametrize("mode", ["f32_train_card", "f32_train_cpu", "bf16_train_card", "f32_eval_card"])
def test_unet_dispatches_standard_train_convs_to_split_conv(mode, monkeypatch):
    """With the device check reading 'card', an f32 train forward makes one
    ``conv3x3_train`` call at each of the ten standard-block convs, on the
    conv's input; a CPU tensor, a bf16 model or an eval forward make
    none."""
    calls = []
    real = t_c3.conv3x3_train

    def spy(x, kernel, bias):
        calls.append((tuple(x.shape), x.dtype, tuple(kernel.shape)))
        return real(x, kernel, bias)

    monkeypatch.setattr(t_c3, "conv3x3_train", spy)
    if mode.endswith("card"):
        monkeypatch.setattr(t_c3, "_on_card", lambda x: True)
    dtype = torch.bfloat16 if mode.startswith("bf16") else torch.float32
    model = UNet(torch.Generator().manual_seed(0), init_features=4, depth=4, dtype=dtype).train("train" in mode)
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(2))
    with torch.set_grad_enabled("train" in mode):
        model(x)
    if mode == "f32_train_card":
        assert [c[0] for c in calls] == TRAIN_SITES
        assert all(c[1] == torch.float32 and c[2][:3] == (3, 3, c[0][-1]) for c in calls)
    else:
        assert calls == []


@pytest.mark.parametrize("mode", ["f32_train_card", "f32_train_cpu", "bf16_train_card", "f32_eval_card"])
def test_detection_head_dispatches_its_convs_to_conv3x3_same(mode, monkeypatch):
    """``DetectionHead.forward`` reaches ``conv3x3_same`` at both convs, on
    their inputs (C → C/2 → C/4), in every mode; with the device check
    reading 'card', an f32 head (train or eval) runs ``conv3x3_train``
    there, and a CPU tensor or a bf16 head runs neither."""
    same, train = [], []
    real_same, real_train = t_c3.conv3x3_same, t_c3.conv3x3_train
    monkeypatch.setattr(t_det, "conv3x3_same", lambda x, k, b: same.append(tuple(x.shape)) or real_same(x, k, b))
    monkeypatch.setattr(t_c3, "conv3x3_train", lambda x, k, b: train.append(tuple(x.shape)) or real_train(x, k, b))
    if mode.endswith("card"):
        monkeypatch.setattr(t_c3, "_on_card", lambda x: True)
    dtype = torch.bfloat16 if mode.startswith("bf16") else torch.float32
    head = t_det.DetectionHead(24, torch.Generator().manual_seed(0), fc_hidden_dim=16, dtype=dtype)
    head.train("train" in mode)
    f = torch.randn((2, 6, 10, 24), generator=torch.Generator().manual_seed(1))
    with torch.set_grad_enabled("train" in mode):
        head(f, gen=torch.Generator().manual_seed(2))
    assert same == [(2, 6, 10, 24), (2, 6, 10, 12)]
    assert train == (same if mode.startswith("f32") and mode.endswith("card") else [])


@pytest.mark.parametrize("num_classes", [1, 3])
def test_train_detection_head_through_the_function_matches_conv2d_nhwc(num_classes, monkeypatch):
    """A train-mode f32 detection head on the CPU gives the same outputs,
    gradients (every parameter and its input) and BN statistics through
    ``conv3x3_train`` (the device check patched to 'card': two calls) as
    through ``conv2d_nhwc``, with the same dropout draws."""
    f = torch.randn((2, 9, 7, 16), generator=torch.Generator().manual_seed(8))
    sides, calls = [], []
    real = t_c3.conv3x3_train
    for forced in (False, True):
        head = t_det.DetectionHead(16, torch.Generator().manual_seed(9), fc_hidden_dim=32,
                                   num_classes=num_classes).train()
        if forced:
            monkeypatch.setattr(t_c3, "_on_card", lambda t: True)
            monkeypatch.setattr(t_c3, "conv3x3_train", lambda *a: calls.append(1) or real(*a))
        x = f.clone().requires_grad_(True)
        out = head(x, gen=torch.Generator().manual_seed(10))
        loss = sum((o * torch.linspace(-1, 1, o.numel()).reshape(o.shape)).sum() for o in out)
        grads = torch.autograd.grad(loss, [x] + list(head.parameters()))
        sides.append((out, grads, [b.clone() for b in head.buffers()]))
    (out0, grads0, stats0), (out1, grads1, stats1) = sides
    assert len(calls) == 2
    for got, ref in zip(tuple(out1) + grads1 + tuple(stats1), tuple(out0) + grads0 + tuple(stats0)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())


def _block_step(block, x):
    """A train-mode ConvBlock's loss and its gradients (every parameter and
    x), the BN running statistics after it."""
    x = x.clone().requires_grad_(True)
    y = block(x)
    loss = (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum()
    grads = torch.autograd.grad(loss, [x] + list(block.parameters()))
    return loss, grads, [b.clone() for b in block.buffers()]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("use_batchnorm", [True, False])
def test_train_conv_block_through_the_function_matches_conv2d_nhwc(use_batchnorm, remat, monkeypatch):
    """A train-mode f32 ConvBlock on the CPU gives the same loss, gradients
    and BN statistics through ``conv3x3_train`` (the device check patched to
    'card') as through ``conv2d_nhwc``; with remat the forward runs twice
    (two calls a conv) and BN's running statistics move once."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn((2, 6, 10, 12), generator=g)
    sides, calls = [], []
    real = t_c3.conv3x3_train
    for forced in (False, True):
        block = ConvBlock(12, 16, torch.Generator().manual_seed(7), use_batchnorm=use_batchnorm, remat=remat).train()
        if forced:
            monkeypatch.setattr(t_c3, "_on_card", lambda t: True)
            monkeypatch.setattr(t_c3, "conv3x3_train", lambda *a: calls.append(1) or real(*a))
        sides.append(_block_step(block, x))
    (loss0, grads0, stats0), (loss1, grads1, stats1) = sides
    assert len(calls) == (4 if remat else 2)
    torch.testing.assert_close(loss1, loss0, rtol=1e-5, atol=0)
    for got, ref in zip(grads1 + tuple(stats1), grads0 + tuple(stats0)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())
