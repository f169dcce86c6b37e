"""The port's kernel modules (mingraph_unet_tpu_torch/ops/kernels) against
the JAX package's Pallas kernels in interpret mode, on the CPU, where each
wrapper runs its plain PyTorch version; and the wrappers' device rules.

tests/test_torch_card.py holds each hand-written kernel against its plain
version on the card.

Tolerances: f32 results agree to 2e-4 of max |ref| (PARITY.md M5: the two
sides sum the same products in another order); the pool selects one of its
inputs and must be bit-equal.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingraph_unet_tpu.ops import s2d as jax_s2d
from mingraph_unet_tpu.ops.pallas import pool as jax_pool
from mingraph_unet_tpu.ops.pallas import psconv as jax_psconv
from mingraph_unet_tpu_torch.ops import s2d as t_s2d
from mingraph_unet_tpu_torch.ops.conv import conv2d_nhwc
from mingraph_unet_tpu_torch.ops.kernels import conv3x3 as t_c3
from mingraph_unet_tpu_torch.ops.kernels import conv_block as t_cb
from mingraph_unet_tpu_torch.ops.kernels import histeq as t_histeq
from mingraph_unet_tpu_torch.ops.kernels import pool as t_pool
from mingraph_unet_tpu_torch.ops.kernels import psconv as t_psconv
from mingraph_unet_tpu_torch.ops.kernels import wconv as t_wconv

REL_TOL = 2e-4


def _assert_close_rel(got, ref, rel=REL_TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-6)
    err = np.abs(got - ref).max() / scale
    assert err <= rel, f"max error {err:.3g} of max |ref| > {rel}"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (B, Hh, Ww, C, Cout): the path's 128- and 256-lane widths, and a small odd case.
PSEL_SHAPES = [(2, 8, 8, 32, 32), (1, 6, 8, 64, 64), (1, 5, 3, 16, 8)]


def _psel_case(shape, seed=0):
    b, hh, ww, c, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, hh, ww, 4 * c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, cout)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    return x, k, bias


@pytest.mark.parametrize("shape", PSEL_SHAPES)
def test_psel_plain_matches_pallas(shape):
    x, k, bias = _psel_case(shape)
    with jax.default_matmul_precision("highest"):
        ref = jax_psconv.conv3x3_s2d_psel(
            jnp.asarray(x), jax_psconv.psconv_weights(jnp.asarray(k)),
            jax_s2d.s2d_vector(jnp.asarray(bias)), relu=True, interpret=True,
        )
    got = t_psconv.psel_conv3x3(_t(x), _t(k), _t(bias))
    _assert_close_rel(got.numpy(), ref)


# (B, Hh, Ww, skip_c = up_c = Cout, Cprev); width 1 makes every column both
# first and last (the bias-table corner case).
DEC1_SHAPES = [(2, 6, 8, 32, 64), (1, 4, 6, 64, 128), (2, 8, 1, 32, 64)]


def _dec1_case(shape, seed=1):
    b, hh, ww, c, cprev = shape
    rng = np.random.default_rng(seed)
    x_skip = rng.standard_normal((b, hh, ww, 4 * c)).astype(np.float32)
    x_prev = rng.standard_normal((b, hh, ww, cprev)).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, 2 * c, c)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    kt = (rng.standard_normal((2, 2, cprev, c)) * 0.2).astype(np.float32)
    bias_up = rng.standard_normal(c).astype(np.float32)
    return x_skip, x_prev, kernel, bias, kt, bias_up


def _t_dec1_args(x_skip, x_prev, kernel, bias, kt, bias_up):
    c = kernel.shape[-1]
    wt = t_s2d.s2d_convt2x2_kernel(_t(kt))
    k_skip, k_prev = t_psconv.dec_conv1_weights(_t(kernel), c, wt)
    t9 = t_psconv.dec_conv1_bias_table(_t(kernel), c, _t(bias_up), _t(bias))
    return _t(x_skip), _t(x_prev), k_skip, k_prev, t9


@pytest.mark.parametrize("shape", DEC1_SHAPES)
def test_dec_conv1_plain_matches_pallas(shape):
    x_skip, x_prev, kernel, bias, kt, bias_up = _dec1_case(shape)
    c = kernel.shape[-1]
    with jax.default_matmul_precision("highest"):
        wt = jax_s2d.s2d_convt2x2_kernel(jnp.asarray(kt))
        km, kp, kc = jax_psconv.dec_conv1_weights(jnp.asarray(kernel), c, wt)
        t9 = jax_psconv.dec_conv1_bias_table(jnp.asarray(kernel), c, jnp.asarray(bias_up), jnp.asarray(bias))
        ref = jax_psconv.dec_conv1_fused(
            jnp.asarray(x_skip), jnp.asarray(x_prev), km, kp, kc, t9, interpret=True
        )
    got = t_psconv.dec_conv1_fused(*_t_dec1_args(x_skip, x_prev, kernel, bias, kt, bias_up))
    _assert_close_rel(got.numpy(), ref)


def test_dec_conv1_bias_table_matches_jax():
    _, _, kernel, bias, kt, bias_up = _dec1_case((1, 4, 4, 32, 64))
    ref = jax_psconv.dec_conv1_bias_table(jnp.asarray(kernel), 32, jnp.asarray(bias_up), jnp.asarray(bias))
    got = t_psconv.dec_conv1_bias_table(_t(kernel), 32, _t(bias_up), _t(bias))
    _assert_close_rel(got.numpy(), ref, rel=1e-5)


@pytest.mark.parametrize("shape,dtype", [
    ((3, 16, 24, 128), np.float32),   # level-0 lanes (32 channels)
    ((2, 8, 8, 256), np.float32),     # level-1 lanes (64 channels)
    ((1, 5, 3, 32), np.float32),      # odd grid, 8 channels
    ((2, 8, 8, 256), "bfloat16"),
])
def test_pool_plain_matches_pallas_bit_equal(shape, dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        xj = jnp.asarray(x, jnp.bfloat16)
        xt = _t(x).to(torch.bfloat16)
    else:
        xj, xt = jnp.asarray(x), _t(x)
    ref = jax_pool.phase_max_pool_pallas(xj, interpret=True)
    got = t_pool.phase_max_pool_kernel(xt)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("k,n", [(32, 24), (9 * 32, 32), (9 * 64, 64)])
def test_wgmma_b_layout(k, n):
    """The bf16 psel kernel's weights: B[16s + 8h + kk, 8j + r] at
    [s, j, h, r, kk], so each 8 × 8 core matrix (8 columns, 8 values of k)
    is one contiguous 128-byte line, the two k halves of a slab 128 bytes
    apart and its 8-column groups 256 bytes apart (wgmma's K-major B layout
    without swizzle)."""
    w = torch.arange(k * n, dtype=torch.float32).reshape(k, n)
    packed = t_psconv.wgmma_b_layout(w)
    assert packed.shape == (k // 16, n // 8, 2, 8, 8) and packed.is_contiguous()
    flat = packed.flatten()
    for kk, nn in itertools.product(range(k), range(n)):
        s, r = divmod(kk, 16)
        byte = s * 16 * n * 2 + ((nn // 8) * 2 + r // 8) * 128 + (nn % 8) * 16 + (r % 8) * 2
        assert flat[byte // 2] == w[kk, nn]


@pytest.mark.parametrize("adjoint", [False, True], ids=["direct", "adjoint"])
@pytest.mark.parametrize("c", [32, 64])
def test_psel_b_image_index_is_the_packed_layout(c, adjoint):
    """The map by which the bf16 psel kernel lays out the raw HWIO kernel
    in shared memory (its prologue, ``csrc/psel_conv.cu::lay_weights``):
    every element of the B image comes from one weight, each weight goes to
    one element, and the image equals ``wgmma_b_layout`` of the kernel (of
    its adjoint, flipped and in/out transposed, for the dgrad) as (9C, C)."""
    index = t_psconv.psel_b_image_index(c, adjoint)
    assert index.shape == (9 * c * c,) and np.array_equal(np.sort(index), np.arange(9 * c * c))
    w = torch.from_numpy(np.random.default_rng(c).standard_normal((3, 3, c, c)).astype(np.float32))
    src = w.flip(0, 1).transpose(2, 3) if adjoint else w
    packed = t_psconv.wgmma_b_layout(src.reshape(9 * c, c)).flatten()
    assert torch.equal(w.flatten()[torch.from_numpy(index)], packed)


@pytest.mark.parametrize("adjoint", [False, True], ids=["direct", "adjoint"])
@pytest.mark.parametrize("c", [32, 64])
def test_psel_split_b_image_index_is_the_packed_layout(c, adjoint):
    """The map of the f32 psel kernel's hi and lo images
    (``csrc/psel_conv.cu::lay_tap_split``): a permutation of the raw
    kernel, equal to ``wgmma_b_layout`` of (9C, C) B whose rows, within
    each 16-row slab, hold the channels in the order the lanes' A fragments
    take them (``SPLIT_SLAB_ROWS``: fragment columns 2t, 2t + 1, 2t + 8,
    2t + 9 from channels 4t … 4t + 3)."""
    rows = t_psconv.SPLIT_SLAB_ROWS
    assert sorted(rows) == list(range(16))
    for t in range(4):
        assert [rows[2 * t], rows[2 * t + 1], rows[8 + 2 * t], rows[9 + 2 * t]] == list(range(4 * t, 4 * t + 4))
    index = t_psconv.psel_b_image_index(c, adjoint, split=True)
    assert index.shape == (9 * c * c,) and np.array_equal(np.sort(index), np.arange(9 * c * c))
    w = torch.from_numpy(np.random.default_rng(c).standard_normal((3, 3, c, c)).astype(np.float32))
    b = (w.flip(0, 1).transpose(2, 3) if adjoint else w).reshape(9 * c, c)
    order = torch.from_numpy(np.arange(9 * c) // 16 * 16 + rows[np.arange(9 * c) % 16])
    assert torch.equal(w.flatten()[torch.from_numpy(index)], t_psconv.wgmma_b_layout(b[order]).flatten())


F32_TOL = 1e-4  # chip_smoke.py's tolerance for an f32 kernel against its plain version


def _split(t):
    """An f32 tensor as the f32 psel kernel splits it: (hi, lo) with hi =
    bf16(t), lo = bf16(t - hi), both exact in f64."""
    hi = t.to(torch.bfloat16)
    return hi.double(), (t - hi.float()).to(torch.bfloat16).double()


def _split_conv(x, k, conv):
    """``conv(x, k)`` of f32 x and k as the card's f32 psel kernel forms it:
    three bf16 products a term, hi·hi + hi·lo + lo·hi (each exact), summed
    here in f64; the kernel sums them in f32."""
    (xh, xl), (kh, kl) = _split(x), _split(k)
    return conv(xh, kh) + conv(xh, kl) + conv(xl, kh)


@pytest.mark.parametrize("c", [32, 64])
def test_psel_split_products_match_pallas_f32(c):
    """The f32 psel kernel's arithmetic (the bf16 hi/lo split, three
    products) against the JAX package's Pallas ``conv3x3_s2d_psel`` in f32
    (interpret mode) for K1 (bias, ReLU), and against JAX's
    ``psconv_train`` dgrad and the port's own ``psconv_train`` dgrad (K4),
    within ``F32_TOL`` of max |ref|, on seeded inputs at C = Cout = c."""
    x, k, bias = _psel_case((2, 6, 8, c, c), seed=c)
    g = np.random.default_rng(c + 1).standard_normal(x.shape).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jax_psconv.conv3x3_s2d_psel(
            jnp.asarray(x), jax_psconv.psconv_weights(jnp.asarray(k)),
            jax_s2d.s2d_vector(jnp.asarray(bias)), relu=True, interpret=True,
        )
        _, vjp = jax.vjp(lambda xx: jax_psconv.psconv_train(xx, jnp.asarray(k), interpret=True), jnp.asarray(x))
        (dx_ref,) = vjp(jnp.asarray(g))
    y = torch.relu(_split_conv(_t(x), _t(k), t_psconv.psconv_train_plain) + t_s2d.s2d_vector(_t(bias)).double())
    _assert_close_rel(y.numpy(), ref, F32_TOL)
    dx = _split_conv(_t(g), _t(k), t_psconv.psconv_dgrad_plain)
    _assert_close_rel(dx.numpy(), dx_ref, F32_TOL)
    xi = _t(x).requires_grad_()
    t_psconv.psconv_train(xi, _t(k)).backward(_t(g))
    _assert_close_rel(dx.numpy(), xi.grad.numpy(), F32_TOL)


class _Recorder:
    """Stands in for the psel library: records each C call's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("xdtype,kdtype", [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                                           (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("adjoint", [False, True], ids=["fwd", "dgrad"])
def test_psel_launch_passes_the_raw_kernel_and_the_adjoint_flag(monkeypatch, xdtype, kdtype, adjoint):
    """One weight route for both dtypes: the psel launch hands the C entry
    the parameter as it lies (its own storage: no flip, no cast, no copy)
    with ``adjoint`` set for the dgrad, f32 x included (the kernel lays out
    the adjoint itself); ``_psel_weights`` passes the kernel through."""
    x = torch.zeros((1, 4, 4, 4 * 32), dtype=xdtype)
    k = torch.randn((3, 3, 32, 32)).to(kdtype)
    w, w_f32 = t_psconv._psel_weights(k, x)
    assert w.data_ptr() == k.data_ptr() and w_f32 == (kdtype == torch.float32)
    lib = _Recorder()
    monkeypatch.setattr(t_psconv, "_psel_check", lambda *a: None)
    monkeypatch.setattr(t_psconv, "library", lambda name: lib)
    monkeypatch.setattr(t_psconv, "stream_ptr", lambda t: 0)
    t_psconv._psel_launch("psel", x, k, None, relu=False, adjoint=adjoint)
    ((name, args),) = lib.calls
    assert name == "mgu_psel_conv3x3" and args[1] == k.data_ptr()
    assert args[9:13] == (int(xdtype == torch.bfloat16), 0, int(kdtype == torch.float32), int(adjoint))


def test_cpu_wrappers_run_plain_versions_and_count_nothing():
    counters = (t_psconv.psel_conv3x3, t_psconv.dec_conv1_fused, t_pool.phase_max_pool_kernel,
                t_wconv.wconv3x3_s2d, t_cb.fused_conv_block)
    before = [f.launches for f in counters]
    x, k, bias = _psel_case((1, 4, 4, 16, 16))
    y = t_psconv.psel_conv3x3(_t(x), _t(k), _t(bias))
    torch.testing.assert_close(y, t_psconv.psel_conv3x3_plain(_t(x), _t(k), _t(bias)), rtol=0, atol=0)
    t_pool.phase_max_pool_kernel(y)
    t_psconv.dec_conv1_fused(*_t_dec1_args(*_dec1_case((1, 4, 4, 16, 32))))
    w2 = t_wconv.wconv3x3_weights(_t(k))
    torch.testing.assert_close(t_wconv.wconv3x3_s2d(_t(x), w2, _t(bias)),
                               t_wconv.wconv3x3_s2d_plain(_t(x), w2, _t(bias)), rtol=0, atol=0)
    xf, s = _t(x[..., :16]), torch.ones(16)
    torch.testing.assert_close(t_cb.fused_conv_block(xf, _t(k), s, _t(bias), _t(k), s, _t(bias)),
                               t_cb.fused_conv_block_plain(xf, _t(k), s, _t(bias), _t(k), s, _t(bias)),
                               rtol=0, atol=0)
    assert [f.launches for f in counters] == before


# The seven names the benchmark wraps to count kernel work, and the other
# kernel wrappers an op may call: none may run on a plain path.
_KERNEL_NAMES = {t_psconv: ("psel_conv3x3", "dec_conv1_fused", "psconv_fwd", "psconv_dgrad", "psel_conv3x3_halo",
                            "dec_conv1_halo", "psconv_train", "psconv_train_halo"),
                 t_pool: ("phase_max_pool_kernel", "depth_to_space_kernel"),
                 t_histeq: ("equalize_channel",),
                 t_c3: ("conv3x3_fwd", "conv3x3_dgrad", "conv3x3_train")}


def _plain_cases():
    """(op call, plain call, inputs to differentiate) for each U-Net op at a
    width (or, for the standard block's conv, a dtype) its kernel has no
    instantiation for: f32 psel at C = 16, dec-conv1 at Cs = 16, the pool
    and the relayout at 6 f32 channels a phase (24 bytes), K10 in bf16."""
    g = torch.Generator().manual_seed(3)
    rnd = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    x, k, b = rnd(1, 4, 5, 64), rnd(3, 3, 16, 16), rnd(16)
    top, bot = rnd(1, 1, 5, 64), rnd(1, 1, 5, 64)
    skip, prev, ks, kp, t9 = rnd(1, 4, 5, 64), rnd(1, 4, 5, 32), rnd(3, 3, 16, 16), rnd(3, 3, 32, 64), rnd(3, 3, 64)
    y6 = rnd(1, 4, 5, 24)
    xb, kb, bb = rnd(1, 6, 7, 8).bfloat16(), rnd(3, 3, 8, 8), rnd(8)
    no_rows = lambda t: pytest.fail("the kernel's exchange was called")  # noqa: E731
    return {
        "conv2_s2d": (lambda: t_psconv.conv2_s2d(x, k, b), lambda: t_psconv.psel_conv3x3_plain(x, k, b), ()),
        "conv2_s2d_halo": (lambda: t_psconv.conv2_s2d_halo(x, top, bot, k, b),
                           lambda: t_psconv.psel_conv3x3_halo_plain(x, top, bot, k, b), ()),
        "conv2_s2d_train": (lambda: t_psconv.conv2_s2d_train(x, k), lambda: t_psconv.psconv_train_plain(x, k), (x, k)),
        "conv2_s2d_train_shard": (lambda: t_psconv.conv2_s2d_train_shard(x, k, no_rows, lambda t: (top, bot)),
                                  lambda: t_psconv.psconv_halo_plain(x, top, bot, k), (x, k)),
        "dec_conv1": (lambda: t_psconv.dec_conv1(skip, prev, ks, kp, t9),
                      lambda: t_psconv.dec_conv1_fused_plain(skip, prev, ks, kp, t9), ()),
        "dec_conv1_shard": (lambda: t_psconv.dec_conv1_shard(skip, None, None, prev, None, None, ks, kp, t9, 4, 12),
                            lambda: t_psconv.dec_conv1_halo_plain(skip, None, None, prev, None, None, ks, kp, t9, 4,
                                                                  12), ()),
        "encoder_pool": (lambda: t_pool.encoder_pool(y6, False), lambda: t_s2d.phase_max_pool(y6), ()),
        "decoder_d2s": (lambda: t_pool.decoder_d2s(y6, False), lambda: t_s2d.depth_to_space(y6), ()),
        "conv3x3_same": (lambda: t_c3.conv3x3_same(xb, kb, bb), lambda: conv2d_nhwc(xb, kb, bb, padding=1), ()),
    }


@pytest.mark.parametrize("op", sorted(_plain_cases()))
def test_ops_run_the_plain_version_at_widths_without_a_kernel(monkeypatch, op):
    """Each op of the U-Net, on a CPU tensor whose device check reads
    'card', at a width without an instantiation: the plain version's result
    (and gradients) bit for bit, with no kernel wrapper called, so no plain
    path passes through a name the benchmark counts as kernel work."""
    call, plain, wrt = _plain_cases()[op]
    for t in wrt:
        t.requires_grad_(True)
    ref = plain()
    ref_grads = torch.autograd.grad(ref.sum(), wrt) if wrt else ()
    for mod, names in _KERNEL_NAMES.items():
        for name in names:
            monkeypatch.setattr(mod, name, lambda *a, name=name: pytest.fail(f"{name} called on a plain path"))
    for mod in (t_psconv, t_pool, t_c3):
        monkeypatch.setattr(mod, "_on_card", lambda t: True)
    got = call()
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    for a, b in zip(torch.autograd.grad(got.sum(), wrt) if wrt else (), ref_grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_non_cpu_tensor_never_runs_the_plain_version():
    """A tensor off the CPU goes to the kernel path, which raises here (a
    meta tensor is no CUDA tensor) instead of falling back."""
    x = torch.empty((1, 4, 4, 64), device="meta")
    k = torch.zeros((3, 3, 16, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_psconv.psel_conv3x3(x, k, torch.zeros(16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_pool.phase_max_pool_kernel(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_psconv.dec_conv1_fused(x, torch.empty((1, 4, 4, 32), device="meta"), k,
                                 torch.zeros((3, 3, 32, 64)), torch.zeros((3, 3, 64)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_wconv.wconv3x3_s2d(x, torch.zeros((256, 64)), torch.zeros(16))
    v = torch.zeros(16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_cb.fused_conv_block(x, torch.zeros((3, 3, 64, 16)), v, v, k, v, v)
