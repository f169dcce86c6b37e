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


def _live_contraction(x_skip, x_prev, k_skip, live, t9):
    """The kernel's sum in f32: the skip term, then for each output phase
    p = (py, px) its 4 live taps u = 2a + b, each reading x_prev at s2d
    offset (py + a − 1, px + b − 1) (zero outside the grid), then the bias
    field and the ReLU."""
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
