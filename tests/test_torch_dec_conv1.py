"""K2's live-weight form (mingraph_unet_tpu_torch/ops/kernels/psconv.py::
dec_conv1_live_weights) on the CPU: the bf16 kernel (csrc/dec_conv1.cu)
multiplies, for output phase p, only the four live taps of the folded
x_prev weights' column block of p. These tests hold that form to the dense
k_prev it is taken from and, through a plain contraction that runs the
kernel's K loop (the 9 skip taps, then the phase's 4 live x_prev taps), to
the plain version and to the JAX package's Pallas kernel in interpret mode.

Tolerances: the live form is a selection and must hold k_prev's entries
exactly; the contraction sums the same products as the dense plain version
less the zero ones, in f32, within 1e-5 of max |ref|; against JAX within
2e-4 of max |ref| (PARITY.md M5).

The f32 kernel (``dec1_split_kernel``) lays out, per block of its cluster,
hi and lo B images of the live form's columns from the raw weights; its
map (``dec_conv1_image_index``) is held here to the live blocks, and
its hi/lo arithmetic, emulated on the CPU, to the plain version within the
card's f32 tolerance (1e-4 of max |ref|: the dropped lo·lo products are
below 2^-16 of each product) and to JAX within 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mingraph_unet_tpu.ops import s2d as jax_s2d
from mingraph_unet_tpu.ops.pallas import psconv as jax_psconv
from mingraph_unet_tpu_torch.ops import s2d as t_s2d
from mingraph_unet_tpu_torch.ops.kernels import psconv as t_psconv


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_close_rel(got, ref, rel):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6)
    assert err <= rel, f"max error {err:.3g} of max |ref| > {rel}"


def _case(shape, seed=5):
    """Seeded skip (B, Hh, Ww, 4C), x_prev (B, Hh, Ww, Cp), conv1's kernel
    (3, 3, 2C, C) and bias, the ConvTranspose kernel (2, 2, Cp, C) and its
    bias, as numpy."""
    b, hh, ww, c, cp = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hh, ww, 4 * c)).astype(np.float32),
            rng.standard_normal((b, hh, ww, cp)).astype(np.float32),
            (rng.standard_normal((3, 3, 2 * c, c)) * 0.2).astype(np.float32),
            rng.standard_normal(c).astype(np.float32),
            (rng.standard_normal((2, 2, cp, c)) * 0.2).astype(np.float32),
            rng.standard_normal(c).astype(np.float32))


def _weights(kernel, bias, kt, bias_up):
    c = kernel.shape[-1]
    k_skip, k_prev = t_psconv.dec_conv1_weights(_t(kernel), c, t_s2d.s2d_convt2x2_kernel(_t(kt)))
    return k_skip, k_prev, t_psconv.dec_conv1_bias_table(_t(kernel), c, _t(bias_up), _t(bias))


def _live_terms(x_skip, x_prev, k_skip, live):
    """The kernel's products in f32 before the bias: the skip term, then
    for each output phase p = (py, px) its 4 live taps u = 2a + b, each
    reading x_prev at s2d offset (py + a − 1, px + b − 1) (zero outside the
    grid)."""
    _, hh, ww, _ = x_skip.shape
    c = k_skip.shape[-1]
    y = t_s2d.conv3x3_s2d(x_skip, t_s2d.s2d_conv3x3_kernel(k_skip))
    xp = F.pad(x_prev, (0, 0, 1, 1, 1, 1))
    for p in range(4):
        py, px = divmod(p, 2)
        for u in range(4):
            a, b = divmod(u, 2)
            win = xp[:, py + a:py + a + hh, px + b:px + b + ww]
            y[..., p * c:(p + 1) * c] += torch.einsum("nhwi,io->nhwo", win, live[p, u])
    return y


def _live_contraction(x_skip, x_prev, k_skip, live, t9):
    """The kernel's sum in f32 (:func:`_live_terms`), then the bias field
    and the ReLU."""
    _, hh, ww, _ = x_skip.shape
    return torch.relu(_live_terms(x_skip, x_prev, k_skip, live) + t_psconv.bias_table_field(t9, hh, ww)[None])


def _split(t):
    """An f32 tensor as the f32 kernel splits it: (hi, lo), hi = bf16(t),
    lo = bf16(t − hi), both held in f32 (exactly)."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _split_form(x_skip, x_prev, k_skip, live, t9):
    """The f32 kernel's arithmetic (``csrc/dec_conv1.cu::dec1_split_kernel``)
    on the CPU: every operand split into bf16 hi and lo, each product taken
    as hi·hi + hi·lo + lo·hi (a product of two bf16 values is exact in f32),
    summed in f32 over the skip taps and the live x_prev taps; then the bias
    field and the ReLU."""
    _, hh, ww, _ = x_skip.shape
    (sh, sl), (ph, pl), (kh, kl), (lh, ll) = (_split(t) for t in (x_skip, x_prev, k_skip, live))
    y = _live_terms(sh, ph, kh, lh) + _live_terms(sh, ph, kl, ll) + _live_terms(sl, pl, kh, lh)
    return torch.relu(y + t_psconv.bias_table_field(t9, hh, ww)[None])


@pytest.mark.parametrize("c", [16, 32, 64])
def test_live_weights_hold_every_nonzero_of_k_prev(c):
    """Scattering the live form back into a zero (3, 3, Cp, 4C) tensor gives
    k_prev exactly: every non-zero entry of k_prev is in the form, and the
    blocks left out are zero."""
    _, _, kernel, bias, kt, bias_up = _case((1, 1, 1, c, 2 * c))
    _, k_prev, _ = _weights(kernel, bias, kt, bias_up)
    live = t_psconv.dec_conv1_live_weights(k_prev)
    assert live.shape == (4, 4, 2 * c, c)
    back = torch.zeros_like(k_prev)
    for p in range(4):
        py, px = divmod(p, 2)
        for u in range(4):
            a, b = divmod(u, 2)
            back[py + a, px + b, :, p * c:(p + 1) * c] = live[p, u]
    assert torch.equal(back, k_prev)
    assert all(live[p, u].abs().max() > 0 for p in range(4) for u in range(4))


# (B, Hh, Ww, C, Cp): the two U-Net levels' width ratio at small grids; a
# grid one pixel wide (every column first and last) and one high.
LIVE_SHAPES = [(2, 6, 8, 32, 64), (1, 4, 6, 64, 128), (2, 5, 1, 16, 32), (1, 1, 7, 16, 32)]


@pytest.mark.parametrize("shape", LIVE_SHAPES)
def test_live_contraction_matches_plain_and_pallas(shape):
    x_skip, x_prev, kernel, bias, kt, bias_up = _case(shape)
    k_skip, k_prev, t9 = _weights(kernel, bias, kt, bias_up)
    got = _live_contraction(_t(x_skip), _t(x_prev), k_skip, t_psconv.dec_conv1_live_weights(k_prev), t9)
    plain = t_psconv.dec_conv1_fused_plain(_t(x_skip), _t(x_prev), k_skip, k_prev, t9)
    _assert_close_rel(got.numpy(), plain.numpy(), 1e-5)
    c = kernel.shape[-1]
    with jax.default_matmul_precision("highest"):
        km, kp, kc = jax_psconv.dec_conv1_weights(jnp.asarray(kernel), c, jax_s2d.s2d_convt2x2_kernel(jnp.asarray(kt)))
        t9j = jax_psconv.dec_conv1_bias_table(jnp.asarray(kernel), c, jnp.asarray(bias_up), jnp.asarray(bias))
        ref = jax_psconv.dec_conv1_fused(jnp.asarray(x_skip), jnp.asarray(x_prev), km, kp, kc, t9j, interpret=True)
    _assert_close_rel(got.numpy(), ref, 2e-4)


@pytest.mark.parametrize("c", [32, 64])
def test_split_image_index_gathers_the_live_blocks(c):
    """The f32 kernel's weight map: block r of the cluster (C // NB blocks,
    NB = 1024 // C columns each) gathers W_skip's columns r·NB … r·NB + NB
    − 1 and the same columns of the 16 live (phase, tap) blocks of the
    dense k_prev, each laid out as ``wgmma_b_layout`` with every 16-row slab
    in ``SPLIT_SLAB_ROWS`` order; over the cluster every weight of k_skip is
    read once, and the live indices are exactly k_prev's non-zero blocks,
    so every non-zero of k_prev is read and no zero block is."""
    _, _, kernel, bias, kt, bias_up = _case((1, 1, 1, c, 2 * c))
    k_skip, k_prev, _ = _weights(kernel, bias, kt, bias_up)
    k_skip = k_skip.contiguous()
    live = t_psconv.dec_conv1_live_weights(k_prev)
    nb, cp = 1024 // c, 2 * c
    rows = t_psconv.SPLIT_SLAB_ROWS

    def laid(b2d):  # (K, NB) → the kernel's image: each slab's rows in SPLIT_SLAB_ROWS order
        k = b2d.shape[0]
        order = torch.from_numpy(np.arange(k) // 16 * 16 + rows[np.arange(k) % 16])
        return t_psconv.wgmma_b_layout(b2d[order]).flatten()

    skip_all, live_all = [], []
    for r in range(c // nb):
        cols = slice(r * nb, (r + 1) * nb)
        skip_index, live_index = t_psconv.dec_conv1_image_index(c, r)
        assert skip_index.shape == (9 * c * nb,) and live_index.shape == (16 * cp * nb,)
        assert torch.equal(k_skip.flatten()[torch.from_numpy(skip_index)], laid(k_skip[..., cols].reshape(9 * c, nb)))
        assert torch.equal(k_prev.flatten()[torch.from_numpy(live_index)],
                           laid(live[..., cols].reshape(16 * cp, nb)))
        skip_all.append(skip_index)
        live_all.append(live_index)
    skip_all, live_all = np.concatenate(skip_all), np.concatenate(live_all)
    assert np.array_equal(np.sort(skip_all), np.arange(9 * c * c))
    assert len(np.unique(live_all)) == len(live_all) == 16 * cp * c
    mask = torch.zeros(k_prev.numel(), dtype=torch.bool)
    mask[torch.from_numpy(live_all)] = True
    assert bool((k_prev.flatten()[~mask] == 0).all())  # every block left out is zero
    assert bool((k_prev.flatten()[mask] != 0).all())   # and every one read is live


# (B, Hh, Ww, C, Cp): the kernel's two widths at small grids; a grid one
# pixel high.
SPLIT_SHAPES = [(2, 6, 8, 32, 64), (1, 4, 6, 64, 128), (1, 1, 7, 32, 64)]


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_split_form_matches_plain_and_pallas(shape):
    """The f32 kernel's hi/lo arithmetic on the live form, emulated on the
    CPU, against the plain version (the card's f32 tolerance, 1e-4 of max
    |ref|) and JAX's ``dec_conv1_fused`` in f32 (Pallas in interpret mode,
    2e-4: PARITY.md M5)."""
    x_skip, x_prev, kernel, bias, kt, bias_up = _case(shape)
    k_skip, k_prev, t9 = _weights(kernel, bias, kt, bias_up)
    got = _split_form(_t(x_skip), _t(x_prev), k_skip, t_psconv.dec_conv1_live_weights(k_prev), t9)
    plain = t_psconv.dec_conv1_fused_plain(_t(x_skip), _t(x_prev), k_skip, k_prev, t9)
    _assert_close_rel(got.numpy(), plain.numpy(), 1e-4)
    c = kernel.shape[-1]
    with jax.default_matmul_precision("highest"):
        km, kp, kc = jax_psconv.dec_conv1_weights(jnp.asarray(kernel), c, jax_s2d.s2d_convt2x2_kernel(jnp.asarray(kt)))
        t9j = jax_psconv.dec_conv1_bias_table(jnp.asarray(kernel), c, jnp.asarray(bias_up), jnp.asarray(bias))
        ref = jax_psconv.dec_conv1_fused(jnp.asarray(x_skip), jnp.asarray(x_prev), km, kp, kc, t9j, interpret=True)
    _assert_close_rel(got.numpy(), ref, 2e-4)


class _Recorder:
    """Stands in for the dec-conv1 library: records each C call's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("halo", [False, True], ids=["unsharded", "sharded"])
@pytest.mark.parametrize("c,cp,split", [(32, 64, True), (64, 128, True), (48, 96, False), (32, 48, False)])
def test_f32_launch_passes_the_model_weights_as_they_lie(monkeypatch, c, cp, split, halo):
    """An f32 launch at the split kernel's widths hands the C entry k_skip
    (a slice of conv1's kernel), k_prev and t9 as the model makes them (no
    copy: their own storage and strides), so a call is one device
    operation. Other f32 widths have no kernel: the op runs the plain
    version (the device check reading 'card') without calling the wrapper,
    and a direct launch refuses them."""
    _, _, kernel, bias, kt, bias_up = _case((1, 1, 1, c, cp))
    k_skip, k_prev, t9 = _weights(kernel, bias, kt, bias_up)
    assert not (k_skip.is_contiguous() or k_prev.is_contiguous() or t9.is_contiguous())
    x_skip, x_prev = torch.zeros((1, 4, 4, 4 * c)), torch.zeros((1, 4, 4, cp))
    lib = _Recorder()
    for name in ("check_cuda_input", "require_no_grad", "_check_rows"):
        monkeypatch.setattr(t_psconv, name, lambda *a: None)
    monkeypatch.setattr(t_psconv, "library", lambda name: lib)
    monkeypatch.setattr(t_psconv, "stream_ptr", lambda t: 0)
    rows = (None, None, None, None, 0, 4) if halo else None
    if not split:
        monkeypatch.setattr(t_psconv, "_on_card", lambda t: True)
        for name in ("dec_conv1_fused", "dec_conv1_halo"):
            monkeypatch.setattr(t_psconv, name, lambda *a, name=name: pytest.fail(f"{name} called"))
        if halo:
            got = t_psconv.dec_conv1_shard(x_skip, None, None, x_prev, None, None, k_skip, k_prev, t9, 0, 4)
            ref = t_psconv.dec_conv1_halo_plain(x_skip, None, None, x_prev, None, None, k_skip, k_prev, t9, 0, 4)
        else:
            got = t_psconv.dec_conv1(x_skip, x_prev, k_skip, k_prev, t9)
            ref = t_psconv.dec_conv1_fused_plain(x_skip, x_prev, k_skip, k_prev, t9)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
        with pytest.raises(ValueError, match="needs Cout = Cs in"):
            t_psconv._dec_conv1_launch("k2", x_skip, x_prev, k_skip, k_prev, t9, halo=rows)
        assert lib.calls == []
        return
    t_psconv._dec_conv1_launch("k2", x_skip, x_prev, k_skip, k_prev, t9, halo=rows)
    ((name, args),) = lib.calls
    assert name == ("mgu_dec_conv1_halo" if halo else "mgu_dec_conv1")
    ws, wp, tf = args[6:9] if halo else args[2:5]
    assert (ws, wp, tf) == (k_skip.data_ptr(), k_prev.data_ptr(), t9.data_ptr())
    assert args[-10:-2] == (*k_skip.stride()[:3], *k_prev.stride()[:3], *t9.stride()[:2])
    assert args[-2] == 0  # not bf16
