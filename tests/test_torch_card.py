"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here is marked ``cuda`` and skips without
a card. This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest tests/test_torch_card.py -m cuda --noconftest -q

Tolerances are relative to max |plain|: f32 1e-4 (another summation order;
TF32 is off on both sides), bf16 1e-2 (the kernel rounds its f32 sum once
to bf16, the plain version rounds the cuDNN conv and then the bias add).
The pool selects one of its inputs, depth-to-space is a permutation and
hist-eq is integer-valued: all three must be bit-equal, as must the dense
decode on the card against the CPU. The training
conv's kernel gradient is PyTorch on both sides and is held to the same
tolerances.
"""

import numpy as np
import pytest
import torch

from mingraph_unet_tpu_torch.ops import s2d as t_s2d
from mingraph_unet_tpu_torch.ops.kernels import conv_block as t_cb
from mingraph_unet_tpu_torch.ops.kernels import histeq as t_histeq
from mingraph_unet_tpu_torch.ops.kernels import pool as t_pool
from mingraph_unet_tpu_torch.ops.kernels import psconv as t_psconv
from mingraph_unet_tpu_torch.ops.kernels import wconv as t_wconv


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_close_rel(got, ref, rel):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6)
    assert err <= rel, f"max error {err:.3g} of max |ref| > {rel}"


def _psel_case(shape, seed=0):
    b, hh, ww, c, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, hh, ww, 4 * c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, cout)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    return x, k, bias


def _dec1_args(shape, seed=1):
    b, hh, ww, c, cprev = shape
    rng = np.random.default_rng(seed)
    x_skip = rng.standard_normal((b, hh, ww, 4 * c)).astype(np.float32)
    x_prev = rng.standard_normal((b, hh, ww, cprev)).astype(np.float32)
    kernel = _t((rng.standard_normal((3, 3, 2 * c, c)) * 0.2).astype(np.float32))
    bias = _t(rng.standard_normal(c).astype(np.float32))
    kt = _t((rng.standard_normal((2, 2, cprev, c)) * 0.2).astype(np.float32))
    bias_up = _t(rng.standard_normal(c).astype(np.float32))
    k_skip, k_prev = t_psconv.dec_conv1_weights(kernel, c, t_s2d.s2d_convt2x2_kernel(kt))
    t9 = t_psconv.dec_conv1_bias_table(kernel, c, bias_up, bias)
    return _t(x_skip), _t(x_prev), k_skip, k_prev, t9


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# bf16 outputs round to 8 bits of mantissa: 1e-2 of max |ref|.
CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# K4's kernel gradient is summed and returned in f32 whatever the inputs.
DK_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-4}


# The bf16 psel kernel's persistent grid (a block a SM) walks 8 x 16 s2d tiles
# at C = 32 and 4 x 16 at C = 64: Hh and Ww that are not multiples of the
# tile, batch 1 with fewer tiles than SMs, and more tiles than the grid has
# blocks.
PSEL_RAGGED = [(1, 7, 37, 64, 64), (1, 13, 37, 32, 32), (2, 101, 99, 32, 32), (3, 66, 70, 64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 8, 32, 32), (1, 6, 20, 64, 64), (1, 5, 3, 32, 32)] + PSEL_RAGGED)
def test_card_psel_matches_plain(cuda_device, shape, dtype):
    x, k, bias = (_t(a).to(cuda_device) for a in _psel_case(shape))
    x = x.to(dtype)
    got = t_psconv.psel_conv3x3(x, k, bias)
    ref = t_psconv.psel_conv3x3_plain(x.float(), k, bias)
    torch.cuda.synchronize()
    _assert_close_rel(got.float().cpu(), ref.cpu(), CARD_TOL[dtype])


# The bf16 dec-conv1 kernel's persistent grid walks 4 x 16 s2d tiles, a block
# a SM at C = 32 and a cluster of four blocks (one output phase each) a tile
# at C = 64: Hh and Ww that are not multiples of the tile, batch 1 with
# fewer tiles than the grid has clusters, Hh = 1, and more tiles than the
# grid has blocks (or clusters).
DEC1_RAGGED = [(1, 7, 37, 64, 128), (1, 13, 37, 32, 64), (1, 1, 21, 64, 128), (1, 1, 40, 32, 64),
               (2, 101, 99, 32, 64), (3, 66, 70, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 6, 8, 32, 64), (1, 5, 20, 64, 128), (2, 8, 1, 32, 64), (1, 1, 1, 32, 64)]
                         + DEC1_RAGGED)
def test_card_dec_conv1_matches_plain(cuda_device, shape, dtype):
    args = [a.to(cuda_device) for a in _dec1_args(shape)]
    got = t_psconv.dec_conv1_fused(args[0].to(dtype), args[1].to(dtype), *args[2:])
    ref = t_psconv.dec_conv1_fused_plain(args[0].to(dtype).float(), args[1].to(dtype).float(), *args[2:])
    torch.cuda.synchronize()
    _assert_close_rel(got.float().cpu(), ref.cpu(), CARD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_pool_bit_equal(cuda_device, dtype):
    x = torch.randn((2, 9, 7, 256), generator=torch.Generator().manual_seed(3))
    x[0, 1, 2, 5] = x[1, 3, 4, 64 + 7] = float("nan")  # in the first and in a later phase group
    x = x.to(cuda_device, dtype)
    got = t_pool.phase_max_pool_kernel(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, t_s2d.phase_max_pool(x), rtol=0, atol=0, equal_nan=True)
    assert got[0, 1, 2, 5].isnan() and got[1, 3, 4, 7].isnan()


@pytest.mark.cuda
def test_card_bf16_conv_rejects_uninstantiated_widths(cuda_device):
    """The bf16 conv kernels exist for Cout = Cin in BF16_WIDTHS (and
    Cp = 2·Cs for dec-conv1); other widths raise instead of launching."""
    x = torch.zeros((1, 4, 4, 4 * 32), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 kernel"):
        t_psconv.psel_conv3x3(x, torch.zeros((3, 3, 32, 16)), torch.zeros(16))
    x16 = torch.zeros((1, 4, 4, 4 * 16), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 kernel"):
        t_psconv.psel_conv3x3(x16, torch.zeros((3, 3, 16, 16)), torch.zeros(16))
    xp = torch.zeros((1, 4, 4, 48), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 kernel"):
        t_psconv.dec_conv1_fused(x, xp, torch.zeros((3, 3, 32, 32)), torch.zeros((3, 3, 48, 128)),
                                 torch.zeros((3, 3, 128)))


# (B, Hh, Ww, C): the train path's two widths, an odd grid and a grid one
# s2d pixel wide.
PSCONV_SHAPES = [(2, 8, 8, 32), (1, 6, 20, 64), (1, 5, 3, 32), (2, 4, 1, 32), (1, 7, 37, 64), (2, 101, 99, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PSCONV_SHAPES)
def test_card_psconv_fwd_and_dgrad_match_plain(cuda_device, shape, dtype):
    x, k, _ = (_t(a).to(cuda_device) for a in _psel_case((*shape, shape[-1])))
    x = x.to(dtype)
    before = (t_psconv.psconv_fwd.launches, t_psconv.psconv_dgrad.launches)
    y = t_psconv.psconv_fwd(x, k)
    dx = t_psconv.psconv_dgrad(x, k)  # x stands in for a cotangent of the same shape
    torch.cuda.synchronize()
    assert (t_psconv.psconv_fwd.launches, t_psconv.psconv_dgrad.launches) == (before[0] + 1, before[1] + 1)
    _assert_close_rel(y.float().cpu(), t_psconv.psconv_train_plain(x.float(), k).cpu(), CARD_TOL[dtype])
    _assert_close_rel(dx.float().cpu(), t_psconv.psconv_dgrad_plain(x.float(), k).cpu(), CARD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PSCONV_SHAPES)
def test_card_psconv_train_grads_match_plain(cuda_device, shape, dtype):
    """The autograd Function's dx and dK for a seeded cotangent against the
    plain version under ordinary autograd, in f32 on the same input values.
    dK is summed and returned in f32 for bf16 inputs too: DK_TOL is a
    quarter of the 2^-9 a bf16 rounding of the result would cost."""
    x, k, _ = (_t(a).to(cuda_device) for a in _psel_case((*shape, shape[-1])))
    x = x.to(dtype)
    g = torch.randn(x.shape, generator=torch.Generator(device=cuda_device).manual_seed(5), device=cuda_device)
    g = g.to(dtype)
    grads = []
    for fn, xin, gin in ((t_psconv.psconv_train, x, g), (t_psconv.psconv_train_plain, x.float(), g.float())):
        xi, ki = xin.clone().requires_grad_(), k.clone().requires_grad_()
        fn(xi, ki).backward(gin)
        grads.append((xi.grad, ki.grad))
    torch.cuda.synchronize()
    (dx, dk), (dx_ref, dk_ref) = grads
    assert dx.dtype == dtype and dk.dtype == torch.float32
    _assert_close_rel(dx.float().cpu(), dx_ref.cpu(), CARD_TOL[dtype])
    _assert_close_rel(dk.cpu(), dk_ref.cpu(), DK_TOL[dtype])


@pytest.mark.cuda
def test_card_inference_kernels_refuse_autograd(cuda_device):
    """psel, dec-conv1 and the pool have no backward: where autograd
    records they raise instead of returning an output without grad_fn."""
    x = torch.zeros((1, 4, 4, 4 * 32), device=cuda_device)
    k = torch.zeros((3, 3, 32, 32), device=cuda_device, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        t_psconv.psel_conv3x3(x, k, torch.zeros(32, device=cuda_device))
    with pytest.raises(ValueError, match="no backward"):
        t_pool.phase_max_pool_kernel(x.clone().requires_grad_())
    with torch.no_grad():
        t_psconv.psel_conv3x3(x, k, torch.zeros(32, device=cuda_device))


@pytest.mark.cuda
def test_card_bf16_unet_init16_forward_matches_cpu(cuda_device):
    """bf16 MinGraphUNet at init_features 16: level 0 (C=16) has no bf16
    tile, so it runs the plain form; level 1 (C=32) runs the kernels. The
    outputs agree with the CPU f32 model within the bf16 tolerance of the
    slice test (5e-2 of max |CPU|)."""
    from mingraph_unet_tpu_torch.models.pipeline import MinGraphUNet

    cfg = dict(init_features=16, depth=2, detection_pre_pool=4)
    card = MinGraphUNet(dtype=torch.bfloat16, device=cuda_device, **cfg)
    cpu = MinGraphUNet(device="cpu", **cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    x = torch.randn((2, 64, 64, 3), generator=torch.Generator().manual_seed(6))
    counters = (t_psconv.psel_conv3x3, t_psconv.dec_conv1_fused, t_pool.phase_max_pool_kernel)
    before = [c.launches for c in counters]
    out = card(x.to(cuda_device))
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 1, 2]
    ref = cpu(x)
    for key in ("logits", "pred_bboxes", "pred_confidence", "l_partition"):
        assert torch.isfinite(out[key]).all(), key
        _assert_close_rel(out[key].float().cpu(), ref[key], 5e-2)


def _luma_case(kind, shape, seed=9):
    rng = np.random.default_rng(seed)
    if kind == "constant":
        y = np.full(shape, 77)
    elif kind == "two_valued":
        y = np.where(rng.uniform(size=shape) < 0.3, 12, 200)
    else:
        y = rng.normal(110, 40, shape)
    return _t(np.clip(y, 0, 255).astype(np.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["noise", "constant", "two_valued"])
@pytest.mark.parametrize("shape", [(8, 512, 512), (3, 37, 53), (2, 1, 17)])
def test_card_histeq_bit_equal(cuda_device, shape, kind):
    """K6 against its plain version: the pipeline's shape, an odd shape
    (ragged 16-byte vectors) and a tiny one; a constant image takes
    cdf_min = N and the clamped denominator."""
    y = _luma_case(kind, shape).to(cuda_device)
    before = t_histeq.equalize_channel.launches
    got = t_histeq.equalize_channel(y)
    torch.cuda.synchronize()
    assert t_histeq.equalize_channel.launches == before + 1
    assert got.dtype == torch.uint8 and got.shape == y.shape
    torch.testing.assert_close(got, t_histeq.equalize_channel_plain(y), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 512, 512), (1, 1024, 1024), (1, 4096, 4096)])
def test_card_histeq_bit_equal_at_cluster_sizes(cuda_device, shape):
    """K6 at the serving batch (eight clusters of 8 blocks), the large
    scene (one cluster, 64 KB slices in shared memory) and the largest
    image it takes (slices counted and mapped from device memory)."""
    y = _luma_case("noise", shape).to(cuda_device)
    got = t_histeq.equalize_channel(y)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, t_histeq.equalize_channel_plain(y), rtol=0, atol=0)


@pytest.mark.cuda
def test_card_histeq_is_one_device_operation(cuda_device):
    """One call is one kernel launch on the card: no memset, no scratch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    y = _luma_case("noise", (8, 512, 512)).to(cuda_device)
    out = torch.empty_like(y)
    t_histeq.equalize_channel(y)
    torch.cuda.synchronize()
    calls = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            out = t_histeq.equalize_channel(y)
        torch.cuda.synchronize()
    ops = {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.count}
    assert sum(ops.values()) == calls and all("histeq" in k for k in ops), ops
    torch.testing.assert_close(out, t_histeq.equalize_channel_plain(y), rtol=0, atol=0)


@pytest.mark.cuda
def test_card_histeq_refuses_what_it_does_not_take(cuda_device):
    y = torch.zeros((2, 4, 4), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="uint8"):
        t_histeq.equalize_channel(y.float())
    with pytest.raises(ValueError, match="aligned"):
        t_histeq.equalize_channel(torch.zeros(40, dtype=torch.uint8, device=cuda_device)[1:33].view(2, 4, 4))
    with pytest.raises(ValueError, match="pixels per image"):
        t_histeq.equalize_channel(torch.zeros((1, 4097, 4096), dtype=torch.uint8, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((8, 128, 128, 256), torch.bfloat16),   # the serving level-1 handoff
    ((4, 320, 320, 128), torch.bfloat16),   # the large scene's f_u[0]
    ((2, 9, 7, 256), torch.float32),
    ((3, 5, 7, 64), torch.float32),
    ((1, 1, 3, 32), torch.bfloat16),        # one 16-byte vector per phase group
])
def test_card_d2s_bit_equal(cuda_device, shape, dtype):
    """K5 against its plain version: a permutation, bit for bit."""
    y = torch.randn(shape, generator=torch.Generator().manual_seed(4)).to(cuda_device, dtype)
    before = t_pool.depth_to_space_kernel.launches
    got = t_pool.depth_to_space_kernel(y)
    torch.cuda.synchronize()
    assert t_pool.depth_to_space_kernel.launches == before + 1
    assert got.dtype == dtype and got.is_contiguous()
    torch.testing.assert_close(got, t_s2d.depth_to_space(y), rtol=0, atol=0)


@pytest.mark.cuda
def test_card_d2s_rejects_what_it_cannot_take(cuda_device):
    with pytest.raises(ValueError, match="16-byte"):
        t_pool.depth_to_space_kernel(torch.zeros((1, 2, 2, 16), device=cuda_device, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="unsupported dtype"):
        t_pool.depth_to_space_kernel(torch.zeros((1, 2, 2, 64), device=cuda_device, dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        t_pool.depth_to_space_kernel(torch.zeros((1, 2, 4, 64), device=cuda_device).transpose(1, 2))
    with pytest.raises(ValueError, match="no backward"):
        t_pool.depth_to_space_kernel(torch.zeros((1, 2, 2, 64), device=cuda_device, requires_grad=True))


@pytest.mark.cuda
@pytest.mark.parametrize("equal_scores", [False, True])
def test_card_dense_decode_equals_cpu(cuda_device, equal_scores):
    """decode_dense_detections on the card equals the plain decode on the
    CPU over the same raw outputs, bit for bit (the sigmoid is taken in
    f64 and rounded once)."""
    from mingraph_unet_tpu_torch.models.detection import decode_dense_detections

    g = torch.Generator().manual_seed(8)
    logits = torch.zeros((2, 64, 64)) if equal_scores else torch.randn((2, 64, 64), generator=g) * 3
    boxes = torch.rand((2, 64, 64, 4), generator=g)
    cpu = decode_dense_detections(logits, boxes, (1024, 1024), 16, top_k=32)
    card = decode_dense_detections(logits.to(cuda_device), boxes.to(cuda_device), (1024, 1024), 16, top_k=32)
    torch.cuda.synchronize()
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)
    assert cpu[2].any()


# (B, Hh, Ww, Cin, Cout, groups) for K7: tensor-core widths (one group, the
# decoder's two), the RGB input (Cin 3), Cin 5, groups (2, 4), odd Ww and an
# Hh that is not a multiple of the 4-row tile.
WCONV_CARD_CASES = [(2, 8, 16, 32, 32, ()), (1, 6, 20, 128, 64, (64, 64)), (1, 5, 18, 32, 16, (16, 16)),
                    (2, 7, 5, 3, 32, ()), (1, 5, 7, 5, 4, ()), (2, 9, 8, 6, 4, (2, 4)),
                    # odd Cout: 4*Cout not a multiple of 8, so the epilogue's element-wise stores
                    (1, 5, 9, 5, 3, ()), (1, 6, 7, 6, 5, (2, 4)),
                    # the bf16 kernel's tiles (8 x 16 s2d pixels at 4*Cout = 256, 16 x 16 below):
                    # ragged edges, more tiles than SMs, 4*Cout above 256 (two column blocks)
                    (1, 17, 33, 64, 64, ()), (8, 70, 70, 32, 32, ()), (1, 5, 9, 16, 70, ())]


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", WCONV_CARD_CASES)
def test_card_wconv_matches_plain(cuda_device, case, dtype, relu):
    """K7 against its plain version in f32 on the same input values."""
    b, hh, ww, cin, cout, groups = case
    g = torch.Generator().manual_seed(hh * ww + cin)
    x = torch.randn((b, hh, ww, 4 * cin), generator=g).to(cuda_device, dtype)
    k = torch.randn((3, 3, cin, cout), generator=g) * (1.0 / (9 * cin)) ** 0.5
    w2 = t_wconv.wconv3x3_weights(k).to(cuda_device)
    bias = torch.randn(cout, generator=g).to(cuda_device)
    # Every bf16 width, the odd ones included, runs on tensor cores (wgmma); f32 in SIMT.
    assert t_wconv.wconv_uses_mma(dtype) == (dtype == torch.bfloat16)
    before = t_wconv.wconv3x3_s2d.launches
    got = t_wconv.wconv3x3_s2d(x, w2, bias, groups=groups, relu=relu)
    torch.cuda.synchronize()
    assert t_wconv.wconv3x3_s2d.launches == before + 1 and got.dtype == dtype
    ref = t_wconv.wconv3x3_s2d_plain(x.float(), w2.to(dtype), bias, groups, relu)
    _assert_close_rel(got.float().cpu(), ref.cpu(), CARD_TOL[dtype])


@pytest.mark.cuda
def test_card_wconv_refuses_what_it_does_not_take(cuda_device):
    w2, bias = torch.zeros((16 * 32, 4 * 32)), torch.zeros(32)
    x = torch.zeros((1, 4, 4, 128), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported dtype"):
        t_wconv.wconv3x3_s2d(x.half(), w2, bias)
    with pytest.raises(ValueError, match="contiguous"):
        t_wconv.wconv3x3_s2d(torch.zeros((1, 4, 8, 128), device=cuda_device).transpose(1, 2)[:, :4], w2, bias)
    with pytest.raises(ValueError, match="aligned"):
        misaligned = torch.zeros(2049, device=cuda_device, dtype=torch.bfloat16)[1:].view(1, 4, 4, 128)
        t_wconv.wconv3x3_s2d(misaligned, w2, bias)
    with pytest.raises(ValueError, match="groups"):
        t_wconv.wconv3x3_s2d(x, w2, bias, groups=(8, 8, 8, 4))
    with pytest.raises(ValueError, match="no backward"):
        t_wconv.wconv3x3_s2d(x.float().requires_grad_(), w2, bias)


# (B, H, W, Cin, C, every b1 > 0) for K8: Cin 1 and 3 (rows that are not
# 16-byte multiples), odd H and W, every tile size (C up to 32, 64, 128,
# 256, 512), and all-positive b1, so an h border left at relu(b1) shows.
CONV_BLOCK_CARD_CASES = [(1, 8, 8, 1, 1, False), (2, 9, 13, 3, 32, True), (1, 7, 5, 3, 8, True),
                         (1, 11, 19, 16, 64, False), (1, 6, 10, 64, 128, True), (1, 5, 7, 128, 256, False),
                         (2, 4, 6, 256, 512, True), (1, 3, 3, 40, 24, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CONV_BLOCK_CARD_CASES)
def test_card_conv_block_matches_plain(cuda_device, case, dtype):
    """K8 against its plain version (cuDNN in f32, TF32 off) on the same
    input values."""
    b, h, w, cin, c, positive_b1 = case
    g = torch.Generator().manual_seed(h * w + c)
    x = torch.randn((b, h, w, cin), generator=g).to(cuda_device, dtype)
    w1 = torch.randn((3, 3, cin, c), generator=g) * (2.0 / (9 * cin)) ** 0.5
    w2 = torch.randn((3, 3, c, c), generator=g) * (2.0 / (9 * c)) ** 0.5
    s1, s2 = torch.rand(c, generator=g) + 0.5, torch.rand(c, generator=g) + 0.5
    b1 = torch.rand(c, generator=g) + 0.5 if positive_b1 else torch.randn(c, generator=g) * 0.1
    b2 = torch.randn(c, generator=g) * 0.1
    args = [t.to(cuda_device) for t in (w1, s1, b1, w2, s2, b2)]
    before = t_cb.fused_conv_block.launches
    got = t_cb.fused_conv_block(x, *args)
    torch.cuda.synchronize()
    assert t_cb.fused_conv_block.launches == before + 1 and got.dtype == dtype
    ref = t_cb.fused_conv_block_plain(x.float(), *args)
    _assert_close_rel(got.float().cpu(), ref.cpu(), CARD_TOL[dtype])


# The five standard-layout ConvBlocks of the serving U-Net (init 32, depth
# 4, 512² b8): enc block2, enc block3, the bottleneck, dec block0, dec
# block1, as (B, H, W, Cin, C).
CONV_BLOCK_SITES = [(8, 128, 128, 64, 128), (8, 64, 64, 128, 256), (8, 32, 32, 256, 512), (8, 64, 64, 512, 256),
                    (8, 128, 128, 256, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", CONV_BLOCK_SITES)
def test_card_conv_block_standard_sites(cuda_device, site, dtype):
    """K8 at the serving U-Net's five standard sites against its plain
    version (cuDNN in f32, TF32 off) on the same input values."""
    b, h, w, cin, c = site
    g = torch.Generator(device=cuda_device).manual_seed(cin + c)
    x = torch.randn((b, h, w, cin), generator=g, device=cuda_device).to(dtype)
    w1 = torch.randn((3, 3, cin, c), generator=g, device=cuda_device) * (2.0 / (9 * cin)) ** 0.5
    w2 = torch.randn((3, 3, c, c), generator=g, device=cuda_device) * (2.0 / (9 * c)) ** 0.5
    s1, s2 = (torch.rand(c, generator=g, device=cuda_device) + 0.5 for _ in range(2))
    b1, b2 = (torch.randn(c, generator=g, device=cuda_device) * 0.1 for _ in range(2))
    got = t_cb.fused_conv_block(x, w1, s1, b1, w2, s2, b2)
    torch.cuda.synchronize()
    ref = t_cb.fused_conv_block_plain(x.float(), w1, s1, b1, w2, s2, b2)
    err = (got.float() - ref).abs().max().item() / ref.abs().max().item()
    assert err <= CARD_TOL[dtype], f"max error {err:.3g} of max |ref| > {CARD_TOL[dtype]}"


@pytest.mark.cuda
def test_card_conv_block_refuses_what_it_does_not_take(cuda_device):
    def args(cin, c):
        v = torch.ones(c, device=cuda_device)
        w1, w2 = torch.zeros((3, 3, cin, c), device=cuda_device), torch.zeros((3, 3, c, c), device=cuda_device)
        return w1, v, v, w2, v, v

    x = torch.zeros((1, 4, 4, 8), device=cuda_device)
    with pytest.raises(ValueError, match="unsupported dtype"):
        t_cb.fused_conv_block(x.half(), *args(8, 8))
    with pytest.raises(ValueError, match="contiguous"):
        t_cb.fused_conv_block(torch.zeros((1, 4, 8, 8), device=cuda_device).transpose(1, 2)[:, :4], *args(8, 8))
    with pytest.raises(ValueError, match="no backward"):
        t_cb.fused_conv_block(x.clone().requires_grad_(), *args(8, 8))


# Widths the JAX kernels run and the first CUDA versions refused: K7 with
# more than four groups (tensor-core and SIMT), f32 at Cin 256 (the
# init_features=64 U-Net's dec-L1 conv1) and 512, bf16 at Cin 512 (a halo
# staged in two chunks); K8 above 512 channels (the init_features=64
# bottleneck, 512 -> 1024, and C = 600, a tile of 512 and one of 88).
WCONV_WIDE_CASES = [(1, 5, 9, 80, 32, (16, 16, 16, 16, 16), torch.bfloat16),
                    (1, 5, 9, 20, 8, (2, 3, 4, 5, 6), torch.float32),
                    (1, 4, 6, 256, 64, (128, 128), torch.float32),
                    (1, 3, 5, 512, 32, (), torch.float32),
                    (1, 4, 17, 512, 64, (256, 256), torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WCONV_WIDE_CASES)
def test_card_wconv_wide_widths(cuda_device, case):
    b, hh, ww, cin, cout, groups, dtype = case
    g = torch.Generator().manual_seed(cin + cout)
    x = torch.randn((b, hh, ww, 4 * cin), generator=g).to(cuda_device, dtype)
    k = torch.randn((3, 3, cin, cout), generator=g) * (1.0 / (9 * cin)) ** 0.5
    w2 = t_wconv.wconv3x3_weights(k).to(cuda_device)
    bias = torch.randn(cout, generator=g).to(cuda_device)
    got = t_wconv.wconv3x3_s2d(x, w2, bias, groups=groups)
    torch.cuda.synchronize()
    ref = t_wconv.wconv3x3_s2d_plain(x.float(), w2.to(dtype), bias, groups)
    _assert_close_rel(got.float().cpu(), ref.cpu(), CARD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(1, 4, 6, 512, 1024), (2, 5, 3, 40, 600)])
def test_card_conv_block_wide(cuda_device, case, dtype):
    b, h, w, cin, c = case
    g = torch.Generator().manual_seed(c)
    x = torch.randn((b, h, w, cin), generator=g).to(cuda_device, dtype)
    w1 = torch.randn((3, 3, cin, c), generator=g) * (2.0 / (9 * cin)) ** 0.5
    w2 = torch.randn((3, 3, c, c), generator=g) * (2.0 / (9 * c)) ** 0.5
    s1, s2 = torch.rand(c, generator=g) + 0.5, torch.rand(c, generator=g) + 0.5
    b1, b2 = torch.randn(c, generator=g) * 0.1, torch.randn(c, generator=g) * 0.1
    args = [t.to(cuda_device) for t in (w1, s1, b1, w2, s2, b2)]
    got = t_cb.fused_conv_block(x, *args)
    torch.cuda.synchronize()
    ref = t_cb.fused_conv_block_plain(x.float(), *args)
    _assert_close_rel(got.float().cpu(), ref.cpu(), CARD_TOL[dtype])


def _shards(t, n, cuts=None):
    """(shard, top row, bottom row) of each of ``n`` H-shards of ``t`` (the
    exchange done by hand), None at the borders; ``cuts`` the row bounds."""
    h = t.shape[1]
    cuts = cuts or [i * h // n for i in range(n + 1)]
    out = []
    for a, e in zip(cuts[:-1], cuts[1:]):
        top = t[:, a - 1 : a].contiguous() if a > 0 else None
        bottom = t[:, e : e + 1].contiguous() if e < h else None
        out.append((t[:, a:e].contiguous(), top, bottom, a))
    return out


# (B, Hh, Ww, C, row cuts) for K9 and K2's halo form: four equal shards, and
# uneven ones (heights 1, 3, 5) that are not multiples of the 4-row tile;
# shards exactly one tile high over a ragged width (the bf16 psel tile is 4
# rows at C = 64, 8 at C = 32); and shards of many tiles, more than the
# persistent grid holds, cut at heights 1, 4, 33 and 32.
HALO_CASES = [(2, 16, 20, 32, None), (1, 9, 18, 64, [0, 1, 4, 9]), (2, 16, 37, 64, [0, 4, 8, 12, 16]),
              (2, 32, 37, 32, [0, 8, 16, 24, 32]), (2, 70, 100, 32, [0, 1, 5, 38, 70])]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", HALO_CASES)
def test_card_psel_halo_stitches_to_k1_bit_for_bit(cuda_device, case, dtype):
    b, hh, ww, c, cuts = case
    x, k, bias = (_t(a) for a in _psel_case((b, hh, ww, c, c)))
    x = x.to(cuda_device, dtype)
    whole = t_psconv.psel_conv3x3(x, k, bias)
    before = t_psconv.psel_conv3x3_halo.launches
    parts = _shards(x, 4, cuts)
    got = torch.cat([t_psconv.psel_conv3x3_halo(s, top, bot, k, bias) for s, top, bot, _ in parts], dim=1)
    torch.cuda.synchronize()
    assert t_psconv.psel_conv3x3_halo.launches == before + len(parts)
    assert torch.equal(got, whole)
    ref = t_psconv.psel_conv3x3_plain(x.float(), k.to(cuda_device), bias.to(cuda_device))
    _assert_close_rel(got.float().cpu(), ref.cpu(), CARD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", HALO_CASES + [(2, 22, 37, 64, [0, 3, 10, 13, 22]), (1, 6, 40, 32, [0, 2, 3, 6])])
def test_card_dec_conv1_halo_stitches_to_k2_bit_for_bit(cuda_device, case, dtype):
    b, hh, ww, c, cuts = case
    x_skip, x_prev, k_skip, k_prev, t9 = _dec1_args((b, hh, ww, c, 2 * c))
    x_skip, x_prev = x_skip.to(cuda_device, dtype), x_prev.to(cuda_device, dtype)
    k_skip, k_prev, t9 = (t.to(cuda_device) for t in (k_skip, k_prev, t9))
    whole = t_psconv.dec_conv1_fused(x_skip, x_prev, k_skip, k_prev, t9)
    before = t_psconv.dec_conv1_halo.launches
    parts = []
    for (s, st, sb, row0), (p, pt, pb, _) in zip(_shards(x_skip, 4, cuts), _shards(x_prev, 4, cuts)):
        parts.append(t_psconv.dec_conv1_halo(s, st, sb, p, pt, pb, k_skip, k_prev, t9, row0, hh))
    got = torch.cat(parts, dim=1)
    torch.cuda.synchronize()
    assert t_psconv.dec_conv1_halo.launches == before + len(parts)
    assert torch.equal(got, whole)


@pytest.mark.cuda
def test_card_halo_kernels_refuse_what_they_do_not_take(cuda_device):
    x, k, bias = (_t(a) for a in _psel_case((1, 8, 16, 32, 32)))
    x = x.to(cuda_device)
    with pytest.raises(ValueError, match="top must be"):
        t_psconv.psel_conv3x3_halo(x, x[:, :2].contiguous(), None, k, bias)
    with pytest.raises(ValueError, match="bottom must be"):
        t_psconv.psel_conv3x3_halo(x, None, x[:, :1].bfloat16().contiguous(), k, bias)
    with pytest.raises(ValueError, match="no backward"):
        t_psconv.psel_conv3x3_halo(x, x[:, :1].clone().requires_grad_(), None, k, bias)
    args = [t.to(cuda_device) for t in _dec1_args((1, 8, 16, 32, 64))]
    with pytest.raises(ValueError, match="outside the grid"):
        t_psconv.dec_conv1_halo(args[0], None, None, args[1], None, None, *args[2:], 4, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", HALO_CASES)
def test_card_psconv_train_halo_stitches_to_k4_bit_for_bit(cuda_device, case, dtype):
    """K4 on shards (the training conv of the spatial-parallel U-Net):
    forward and dx (from the cotangent's rows), through the wrappers and
    through the autograd Function with the rows by hand, stitched equal to
    K4 on the whole tensor bit for bit; the shards' kernel gradients sum to
    the whole one."""
    b, hh, ww, c, cuts = case
    x, k, _ = (_t(a) for a in _psel_case((b, hh, ww, c, c)))
    cot = _t(np.random.default_rng(4).standard_normal(x.shape).astype(np.float32))
    x, cot, k = x.to(cuda_device, dtype), cot.to(cuda_device, dtype), k.to(cuda_device)
    y_whole, dx_whole = t_psconv.psconv_fwd(x, k), t_psconv.psconv_dgrad(cot, k)
    dk_whole = t_psconv.psconv_wgrad(x, cot, k)
    before = (t_psconv.psconv_fwd_halo.launches, t_psconv.psconv_dgrad_halo.launches)
    xs, gs = _shards(x, 4, cuts), _shards(cot, 4, cuts)
    y = torch.cat([t_psconv.psconv_fwd_halo(s, top, bot, k) for s, top, bot, _ in xs], dim=1)
    dx = torch.cat([t_psconv.psconv_dgrad_halo(s, top, bot, k) for s, top, bot, _ in gs], dim=1)
    torch.cuda.synchronize()
    assert (t_psconv.psconv_fwd_halo.launches, t_psconv.psconv_dgrad_halo.launches) == (before[0] + len(xs),
                                                                                         before[1] + len(gs))
    assert torch.equal(y, y_whole) and torch.equal(dx, dx_whole)
    fy, fdx, fdk = [], [], 0
    for (s, top, bot, _), (g, gt, gb, _) in zip(xs, gs):
        si, ki = s.clone().requires_grad_(), k.clone().requires_grad_()
        out = t_psconv.psconv_train_halo(si, top, bot, ki, lambda t, r=(gt, gb): r)
        out.backward(g)
        fy.append(out.detach())
        fdx.append(si.grad)
        fdk = fdk + ki.grad
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(fy, 1), y_whole) and torch.equal(torch.cat(fdx, 1), dx_whole)
    _assert_close_rel(fdk.cpu(), dk_whole.cpu(), DK_TOL[dtype])


# ---------------------------------------------------------------------------
# Annotated training and the evaluations (small widths, bf16 and f32).
# ---------------------------------------------------------------------------


def _small_cfg(size=64, bf16=True):
    from mingraph_unet_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig()
    cfg.preprocessing.resize_dim = (size, size)
    cfg.model.unet.init_features, cfg.model.unet.depth = 32, 2
    cfg.model.gat.hidden_dim, cfg.model.gat.output_dim, cfg.model.gat.num_heads = 16, 8, 2
    cfg.model.graph_construction.patch_size = 8
    cfg.model.fusion_detection.use_dense_detection = True
    cfg.model.fusion_detection.max_instances = 4
    cfg.training.bf16 = bf16
    return cfg


def _instances(b=2, o=4, size=64, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    inst = np.zeros((b, o, size, size), np.uint8)
    for i in range(b):
        for k in range(o - i):
            cy, cx = rng.uniform(0.2 * size, 0.8 * size, 2)
            inst[i, k] = (yy - cy) ** 2 + ((xx - cx) * 1.3) ** 2 < (rng.uniform(0.06, 0.12) * size) ** 2
    mask = inst.any(1).astype(np.uint8)
    img = np.where(mask[..., None] == 1, np.array([230, 140, 30]), np.array([40, 110, 35]))
    img = np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)
    return _t(img), _t(mask), _t(inst)


@pytest.mark.cuda
def test_card_annotated_e2e_step_runs_no_connected_components(cuda_device, monkeypatch):
    """The annotated e2e step on the card (bf16, the dense head on): K4 4 + 4
    and hist-eq 1, no connected components, every term finite."""
    from mingraph_unet_tpu_torch.ops import cc
    from mingraph_unet_tpu_torch.train import common, end_to_end

    def no_cc(*args, **kwargs):
        raise AssertionError("an annotated step ran connected components")

    monkeypatch.setattr(cc, "label_components_stencil", no_cc)
    monkeypatch.setattr(cc, "label_components", no_cc)
    cfg = _small_cfg()
    model = end_to_end.build_mingraph_unet(cfg, cuda_device)
    opt, sched = common.make_optimizer(model.parameters(), cfg.training, 1)
    step = end_to_end.make_e2e_train_step(model, opt, cfg)
    imgs, masks, inst = (t.to(cuda_device) for t in _instances())
    for k in (t_psconv.psconv_fwd, t_psconv.psconv_dgrad, t_histeq.equalize_channel):
        k.launches = 0
    aux = step(common.TrainState(model, opt, sched), imgs, masks, torch.Generator(device=cuda_device).manual_seed(0),
               instances=inst)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(v)) for v in aux.values()) and float(aux["l_dense_box"]) > 0.0
    assert (t_psconv.psconv_fwd.launches, t_psconv.psconv_dgrad.launches, t_histeq.equalize_channel.launches) == (
        4, 4, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["unet", "mingraph-unet", "mingraph-unet-refined", "dense"])
def test_card_detectors_match_their_cpu_halves(cuda_device, form):
    """Each detector's device function on the card: its CC instancing (or
    the dense decode) equals the CPU's over the card's own logits (dense
    outputs), boxes and areas bit for bit."""
    from mingraph_unet_tpu_torch.experiments import segmentation_performance as sp
    from mingraph_unet_tpu_torch.experiments import yield_estimation_performance as yp
    from mingraph_unet_tpu_torch.models.detection import decode_dense_detections
    from mingraph_unet_tpu_torch.train.end_to_end import build_mingraph_unet

    cfg = _small_cfg()
    weights = build_mingraph_unet(cfg, "cpu").state_dict()
    if form == "unet":
        weights = {k[5:]: v for k, v in weights.items() if k.startswith("unet.")}
    model = sp.build_eval_model(cfg, "unet" if form == "unet" else "mingraph-unet", weights, cuda_device)
    imgs = _instances()[0].to(cuda_device)
    if form == "dense":
        out = sp.eval_forward(model, cfg, imgs)
        args = dict(image_hw=(64, 64), cell_size=8, top_k=16)
        card = decode_dense_detections(out["dense_objectness_logits"], out["dense_boxes"], **args)
        cpu = decode_dense_detections(out["dense_objectness_logits"].cpu(), out["dense_boxes"].cpu(), **args)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))
        assert all(torch.equal(a, b) for a, b in zip(yp.dense_head_detect(model, cfg, imgs, top_k=16), card))
        return
    logits = sp.segmentation_logits(model, cfg, imgs, form)
    card, cpu = yp.instances_from_logits(logits), yp.instances_from_logits(logits.cpu())
    assert torch.equal(card[0].cpu(), cpu[0]) and torch.equal(card[1].cpu(), cpu[1])
    _assert_close_rel(card[2].cpu().numpy(), cpu[2].numpy(), 1e-5)


@pytest.mark.cuda
def test_card_region_blend_matches_cpu(cuda_device):
    from mingraph_unet_tpu_torch.experiments.segmentation_performance import region_blend_logits

    rng = np.random.default_rng(2)
    logits, labels = _t(rng.standard_normal((2, 64, 64, 2)).astype(np.float32)), _t(rng.integers(0, 3, (2, 8, 8)))
    for tau in (None, 0.05):
        got = region_blend_logits(logits.to(cuda_device), labels.to(cuda_device), 8, 3, 0.5, tau)
        _assert_close_rel(got.cpu().numpy(), region_blend_logits(logits, labels, 8, 3, 0.5, tau).numpy(), 1e-5)


@pytest.mark.cuda
def test_card_unbatched_histeq_runs_k6_once(cuda_device):
    """``equalize_histogram_rgb`` and ``equalize_histogram_gray`` on the card
    are K6 on a batch of one, bit-equal to the CPU."""
    from mingraph_unet_tpu_torch.ops import filters

    rng = np.random.default_rng(4)
    rgb = _t(rng.integers(0, 256, (96, 80, 3)).astype(np.uint8))
    gray = _luma_case("noise", (70, 90))
    for fn, x in ((filters.equalize_histogram_rgb, rgb), (filters.equalize_histogram_gray, gray)):
        before = t_histeq.equalize_channel.launches
        got = fn(x.to(cuda_device))
        torch.cuda.synchronize()
        assert t_histeq.equalize_channel.launches == before + 1
        torch.testing.assert_close(got.cpu(), fn(x), rtol=0, atol=0)


@pytest.mark.cuda
def test_card_setup_host_and_trace_attribution(cuda_device, tmp_path):
    """``setup_host()`` gives the card with every library built;
    ``parse_device_trace`` finds K1, launched through ctypes, once a step
    and from its wrapper's module."""
    from mingraph_unet_tpu_torch.ops.kernels import build
    from mingraph_unet_tpu_torch.utils.env import setup_host
    from mingraph_unet_tpu_torch.utils.profiling import attribute_stages, parse_device_trace, trace_if

    assert setup_host().type == "cuda"
    assert all(build._target(name).exists() for name in build.SOURCES)
    x, k, bias = (_t(a).to(cuda_device) for a in _psel_case((2, 16, 16, 64, 64)))
    x = x.to(torch.bfloat16)
    t_psconv.psel_conv3x3(x, k, bias)
    torch.cuda.synchronize()
    with trace_if(str(tmp_path)):
        for _ in range(3):
            t_psconv.psel_conv3x3(x, k, bias)
        torch.cuda.synchronize()
    rows = [r for r in parse_device_trace(str(tmp_path), 3) if "psel_wgmma_kernel" in r["op"]]
    assert len(rows) == 1 and rows[0]["launches_per_step"] == 1.0 and rows[0]["us_per_step"] > 0
    assert "mingraph_unet_tpu_torch/ops/kernels/psconv.py" in rows[0]["source"]
    assert attribute_stages(rows, [("kernels", ("ops/kernels/",))]) == {"kernels": round(rows[0]["us_per_step"] / 1e3, 3)}
