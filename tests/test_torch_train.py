"""The port's training slice (mingraph_unet_tpu_torch) against the JAX
package on the CPU, at small widths, on the same numpy inputs with the flax
weights carried over by ``convert.py``.

Tolerances, relative to max |ref| of each compared tensor: f32 values 2e-4
and gradients 1e-3 (PARITY.md M5: the two frameworks sum in other orders;
a gradient sums over more terms). Two exceptions, each stated where it
applies: a conv bias that feeds a train-mode BatchNorm has a gradient that
is zero in exact arithmetic, so it is held to an absolute bound instead;
and Adam turns that rounding noise into updates of up to ``lr``, so after
optimizer steps those biases are held to an absolute ``lr``.
"""

import json
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingraph_unet_tpu.config import PipelineConfig as JaxPipelineConfig
from mingraph_unet_tpu.config import TrainingConfig as JaxTrainingConfig
from mingraph_unet_tpu.data import dataset as jax_dataset
from mingraph_unet_tpu.experiments import metrics as jax_metrics
from mingraph_unet_tpu.models import losses as jax_losses
from mingraph_unet_tpu.models import unet as jax_unet
from mingraph_unet_tpu.ops import image as jax_image
from mingraph_unet_tpu.ops import s2d as jax_s2d
from mingraph_unet_tpu.ops.pallas import psconv as jax_psconv
from mingraph_unet_tpu.train import common as jax_common
from mingraph_unet_tpu.train import segmentation as jax_seg
from mingraph_unet_tpu.utils.bootstrap import make_dummy_run
from mingraph_unet_tpu_torch.config import PipelineConfig
from mingraph_unet_tpu_torch.convert import load_jax_variables, variables_from_jax
from mingraph_unet_tpu_torch.data import dataset as t_dataset
from mingraph_unet_tpu_torch.experiments import metrics as t_metrics
from mingraph_unet_tpu_torch.models import losses as t_losses
from mingraph_unet_tpu_torch.models import unet as t_unet
from mingraph_unet_tpu_torch.ops import image as t_image
from mingraph_unet_tpu_torch.ops import s2d as t_s2d
from mingraph_unet_tpu_torch.ops.kernels import pool as t_pool
from mingraph_unet_tpu_torch.ops.kernels import psconv as t_psconv
from mingraph_unet_tpu_torch.train import common as t_common
from mingraph_unet_tpu_torch.train import segmentation as t_seg
from mingraph_unet_tpu_torch.train.checkpoint import CheckpointManager
from mingraph_unet_tpu_torch.utils.logging import MetricsLogger

VAL_TOL, GRAD_TOL = 2e-4, 1e-3


def _rel_err(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _gen():
    return torch.Generator().manual_seed(0)


def _feeds_bn(name: str) -> bool:
    """A conv bias followed by a train-mode BatchNorm: its gradient is zero
    in exact arithmetic (BN subtracts the batch mean)."""
    return re.search(r"(^|\.)conv[12]\.bias$", name) is not None


def _check_grads(module, jax_grads, scale_of_all=None):
    """Every parameter's gradient against the flax gradient tree: 1e-3 of
    max |ref|, and the biases that feed BN within 1e-3 of the largest
    gradient of the module."""
    ref = variables_from_jax({"params": _np_tree(jax_grads)})
    scale = scale_of_all or max(np.abs(r.numpy()).max() for r in ref.values())
    names = [n for n, _ in module.named_parameters()]
    assert sorted(names) == sorted(ref)
    for n, p in module.named_parameters():
        assert p.grad is not None, n
        if _feeds_bn(n):
            assert np.abs(p.grad.numpy() - ref[n].numpy()).max() <= GRAD_TOL * scale, n
        else:
            assert _rel_err(p.grad, ref[n]) <= GRAD_TOL, n


def _check_stats(module, jax_stats, mean_atol=0.0):
    """Running statistics at 2e-4 of max |ref|; a running mean may also
    differ by ``mean_atol`` (see the train-step test)."""
    ref = variables_from_jax({"batch_stats": _np_tree(jax_stats)})
    bufs = dict(module.named_buffers())
    assert sorted(bufs) == sorted(ref)
    for n, b in bufs.items():
        r = ref[n].numpy()
        atol = mean_atol if n.endswith(".mean") else 0.0
        assert np.abs(b.numpy() - r).max() <= VAL_TOL * np.abs(r).max() + atol, n


# ---------------------------------------------------------------------------
# K4: psconv_train, against the JAX custom_vjp (Pallas in interpret mode)
# ---------------------------------------------------------------------------

# (B, H, W, Cin, Cout): the shapes of TestPsconvTrainVJP.
PSCONV_SHAPES = [(2, 12, 10, 8, 8), (1, 8, 16, 4, 12)]


def _psconv_case(shape, seed=0):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    r = rng.standard_normal((b, h // 2, w // 2, 4 * cout)).astype(np.float32)
    return np.asarray(jax_s2d.space_to_depth(jnp.asarray(x))), k, r


@pytest.mark.parametrize("shape", PSCONV_SHAPES)
@pytest.mark.parametrize("fn", ["psconv_train", "psconv_train_plain"])
def test_psconv_train_value_and_grads_match_jax(shape, fn):
    xs, k, r = _psconv_case(shape)

    def loss(xs, k):
        return jnp.sum(jax_psconv.psconv_train(xs, k, interpret=True) * r)

    with jax.default_matmul_precision("highest"):
        y_ref = jax_psconv.psconv_train(jnp.asarray(xs), jnp.asarray(k), interpret=True)
        gx_ref, gk_ref = jax.grad(loss, (0, 1))(jnp.asarray(xs), jnp.asarray(k))
    tx, tk = _t(xs).requires_grad_(), _t(k).requires_grad_()
    y = getattr(t_psconv, fn)(tx, tk)
    (y * _t(r)).sum().backward()
    assert _rel_err(y, y_ref) <= VAL_TOL
    assert _rel_err(tx.grad, gx_ref) <= GRAD_TOL
    assert _rel_err(tk.grad, gk_ref) <= GRAD_TOL
    assert tk.grad.dtype == torch.float32


def test_psconv_train_gradcheck_f64():
    g = torch.Generator().manual_seed(3)
    x = torch.randn((1, 3, 2, 4 * 3), dtype=torch.float64, generator=g, requires_grad=True)
    k = torch.randn((3, 3, 3, 2), dtype=torch.float64, generator=g, requires_grad=True)
    assert torch.autograd.gradcheck(t_psconv.psconv_train, (x, k))


def test_s2d_kernel_adjoint_is_the_tap_maps_transpose():
    """<s2d_conv3x3_kernel(k), W> = <k, adjoint(W)> in f64, and the adjoint
    is the gradient autograd takes through the tap map."""
    g = torch.Generator().manual_seed(5)
    k = torch.randn((3, 3, 3, 5), dtype=torch.float64, generator=g, requires_grad=True)
    w = torch.randn((3, 3, 12, 20), dtype=torch.float64, generator=g)
    adj = t_s2d.s2d_conv3x3_kernel_adjoint(w)
    assert adj.shape == k.shape
    lhs = (t_s2d.s2d_conv3x3_kernel(k) * w).sum()
    assert float(lhs) == pytest.approx(float((k * adj).sum()), rel=1e-12)
    lhs.backward()
    assert _rel_err(k.grad, adj.detach().numpy()) <= 1e-12


def test_psconv_wgrad_sums_bf16_products_in_f32():
    """The kernel gradient of bf16 inputs is summed and returned in f32, as
    JAX's preferred_element_type=f32: within 1e-5 of max |ref| of the f64
    gradient of the same bf16 values. A result rounded to bf16 is off by up
    to 2^-9 of an entry (about 1e-3 of max |ref| near the top entries)."""
    xs, k, r = _psconv_case((2, 16, 12, 16, 16), seed=4)
    x16, g16 = _t(xs).to(torch.bfloat16), _t(r).to(torch.bfloat16)
    dk = t_psconv.psconv_wgrad(x16, g16, _t(k))
    assert dk.dtype == torch.float32
    tk = _t(k).double().requires_grad_()
    t_psconv.psconv_train_plain(x16.double(), tk).backward(g16.double())
    assert _rel_err(dk, tk.grad.numpy()) <= 1e-5


def test_unet_train_gradient_is_deterministic():
    """Two backward passes of the same U-Net step give the same gradients
    bit for bit (every reduction sums in a fixed order)."""
    x = torch.randn((2, 16, 16, 3), generator=_gen())
    labels = torch.randint(0, 2, (2, 16, 16), generator=_gen())
    grads = []
    for _ in range(3):
        model = t_unet.UNet(_gen(), init_features=16, depth=2).train()
        logits = model(x)["logits"]
        (t_losses.cross_entropy_loss(logits, labels) + t_losses.dice_loss(logits, labels)).backward()
        grads.append([p.grad for p in model.parameters()])
    for other in grads[1:]:
        assert all(torch.equal(a, b) for a, b in zip(grads[0], other))


def test_psconv_train_takes_a_strided_cotangent():
    """The Function's backward gets an expanded cotangent from ``sum()``
    and a transposed one from a permute; both must give the plain grads."""
    xs, k, _ = _psconv_case((1, 4, 6, 4, 4))
    for reduce in (lambda y: y.sum(), lambda y: (y.permute(0, 2, 1, 3) * 2.0).sum()):
        grads = []
        for fn in (t_psconv.psconv_train, t_psconv.psconv_train_plain):
            tx, tk = _t(xs).requires_grad_(), _t(k).requires_grad_()
            reduce(fn(tx, tk)).backward()
            grads.append((tx.grad, tk.grad))
        for a, b in zip(*grads):
            assert _rel_err(a, b.numpy()) <= GRAD_TOL


# ---------------------------------------------------------------------------
# Dispatch: a kernel where an instantiation exists, the plain form elsewhere
# ---------------------------------------------------------------------------


def test_fit_rules():
    """One width rule a tile for both dtypes: psel Cout = Cin in {32, 64},
    dec-conv1 Cout = Cs in {32, 64} and Cp = 2·Cs; K3 and K5 16-byte
    vectors of a phase group."""
    bf, f32 = torch.bfloat16, torch.float32
    for dt in (bf, f32):
        assert t_psconv._psel_fits(dt, 32, 32) and t_psconv._psel_fits(dt, 64, 64)
        assert not t_psconv._psel_fits(dt, 16, 16) and not t_psconv._psel_fits(dt, 128, 128)
        assert not t_psconv._psel_fits(dt, 32, 64) and not t_psconv._psel_fits(dt, 16, 48)
        assert t_psconv._dec_conv1_fits(dt, 32, 64, 32) and t_psconv._dec_conv1_fits(dt, 64, 128, 64)
        assert not t_psconv._dec_conv1_fits(dt, 16, 32, 16) and not t_psconv._dec_conv1_fits(dt, 32, 48, 32)
    assert not t_psconv._psel_fits(torch.float16, 32, 32)
    assert not t_psconv._dec_conv1_fits(torch.float64, 32, 64, 32)
    assert t_pool._fits(bf, 8) and not t_pool._fits(bf, 4)
    assert t_pool._fits(f32, 4) and not t_pool._fits(f32, 6)


@pytest.mark.parametrize("dtype,init,expect", [
    # bf16 at init 16: level 0 (C=16) has no bf16 instantiation, level 1 (C=32) does.
    (torch.bfloat16, 16, {"psel": [32, 32], "psel_plain": [16, 16], "dec1": [32], "dec1_plain": [16],
                          "pool": [16, 32]}),
    # f32 at init 8: neither level (C=8, 16) has an instantiation; the pool fits both.
    (torch.float32, 8, {"psel_plain": [8, 8, 16, 16], "dec1_plain": [8, 16], "pool": [8, 16]}),
    # f32 at init 16: the same sites as bf16.
    (torch.float32, 16, {"psel": [32, 32], "psel_plain": [16, 16], "dec1": [32], "dec1_plain": [16],
                         "pool": [16, 32]}),
])
def test_unet_dispatch_by_width(monkeypatch, dtype, init, expect):
    """Which s2d sites call a kernel wrapper, decided by the ops from dtype
    and widths (the device check reading 'card') before any launch; in
    train mode K1–K3 are never called and conv2 goes to psconv_train
    exactly where psel fits."""
    calls = {k: [] for k in ("psel", "psel_plain", "dec1", "dec1_plain", "pool", "psconv", "psconv_plain")}

    def spy(key, fn, width):
        def f(*args):
            calls[key].append(width(*args))
            return fn(*args)
        return f

    c_of_k = lambda x, k, *rest: k.shape[-1]  # noqa: E731
    # Each spy computes with the plain version (what a wrapper runs on the
    # CPU), so a wrapper's own call of its plain twin is not counted twice.
    c_of_s = lambda s, *r: s.shape[-1] // 4  # noqa: E731
    psel_plain, dec1_plain, psconv_plain = (t_psconv.psel_conv3x3_plain, t_psconv.dec_conv1_fused_plain,
                                            t_psconv.psconv_train_plain)
    monkeypatch.setattr(t_psconv, "psel_conv3x3", spy("psel", psel_plain, c_of_k))
    monkeypatch.setattr(t_psconv, "psel_conv3x3_plain", spy("psel_plain", psel_plain, c_of_k))
    monkeypatch.setattr(t_psconv, "dec_conv1_fused", spy("dec1", dec1_plain, c_of_s))
    monkeypatch.setattr(t_psconv, "dec_conv1_fused_plain", spy("dec1_plain", dec1_plain, c_of_s))
    monkeypatch.setattr(t_pool, "phase_max_pool_kernel", spy("pool", t_pool.phase_max_pool_kernel, c_of_s))
    monkeypatch.setattr(t_psconv, "psconv_train", spy("psconv", psconv_plain, c_of_k))
    monkeypatch.setattr(t_psconv, "psconv_train_plain", spy("psconv_plain", psconv_plain, c_of_k))
    monkeypatch.setattr(t_psconv, "_on_card", lambda x: True)
    monkeypatch.setattr(t_pool, "_on_card", lambda y: True)
    model = t_unet.UNet(_gen(), init_features=init, depth=2, dtype=dtype).eval()
    x = torch.randn((1, 16, 16, 3), generator=_gen())
    with torch.no_grad():
        model(x)
    got = {k: sorted(v) for k, v in calls.items() if v}
    assert got == {k: sorted(v) for k, v in expect.items()}
    for v in calls.values():
        v.clear()
    model.train()
    model(x)["logits"].sum().backward()
    want = {"psconv": expect.get("psel"), "psconv_plain": expect.get("psel_plain")}
    assert {k: sorted(v) for k, v in calls.items() if v} == {k: v for k, v in want.items() if v}


# ---------------------------------------------------------------------------
# Train mode: ConvBlock, U-Net, losses
# ---------------------------------------------------------------------------


def _flax_train(module, variables, args, r):
    """Output, parameter grads of sum(out · r) and the updated batch_stats
    of a flax module in train mode."""
    def loss(params):
        out, upd = module.apply({"params": params, "batch_stats": variables["batch_stats"]}, *args, train=True,
                                mutable=["batch_stats"])
        return jnp.sum(out * r), (out, upd["batch_stats"])

    with jax.default_matmul_precision("highest"):
        (_, (out, stats)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    return out, grads, stats


def _perturb_stats(tree, seed=1):
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        if str(path[-1].key) == "mean":
            return jnp.asarray(rng.standard_normal(leaf.shape) * 0.2, jnp.float32)
        return jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(f, tree)


@pytest.mark.parametrize("kind", ["standard", "s2d_encoder", "s2d_decoder"])
def test_convblock_train_matches_flax(kind):
    rng = np.random.default_rng(5)
    cin, feat = 8, 16
    if kind == "s2d_decoder":
        x_prev = rng.standard_normal((2, 4, 5, 2 * feat)).astype(np.float32)
        skip = rng.standard_normal((2, 4, 5, 4 * feat)).astype(np.float32)
        jm = jax_unet.DecoderBlock(out_features=feat, up_features=feat, s2d=True)
        args = (jnp.asarray(x_prev), jnp.asarray(skip))
        tm = t_unet.DecoderBlock(2 * feat, feat, feat, feat, _gen())
        run = lambda: tm.forward_s2d(_t(x_prev), _t(skip))  # noqa: E731
        out_shape = (2, 4, 5, 4 * feat)
    else:
        x = rng.standard_normal((2, 8, 10, cin)).astype(np.float32)
        s2d = kind == "s2d_encoder"
        jm = jax_unet.ConvBlock(feat, True, jnp.float32, s2d, (), s2d)
        args = (jnp.asarray(x),)
        tm = t_unet.ConvBlock(cin, feat, _gen())
        run = (lambda: tm.forward_s2d(_t(x))) if s2d else (lambda: tm(_t(x)))
        out_shape = (2, 4, 5, 4 * feat) if s2d else (2, 8, 10, feat)
    v = jm.init(jax.random.key(0), *args)
    v = {"params": v["params"], "batch_stats": _perturb_stats(v["batch_stats"])}
    r = rng.standard_normal(out_shape).astype(np.float32)
    out_ref, grads, stats = _flax_train(jm, v, args, r)
    load_jax_variables(tm, _np_tree(v))
    tm.train()
    out = run()
    (out * _t(r)).sum().backward()
    assert _rel_err(out, out_ref) <= VAL_TOL
    _check_grads(tm, grads)
    _check_stats(tm, stats)


def test_losses_match_jax():
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((2, 6, 7, 3)) * 2).astype(np.float32)
    labels = rng.integers(0, 3, (2, 6, 7))
    for name in ("cross_entropy_loss", "dice_loss"):
        ref = getattr(jax_losses, name)(jnp.asarray(logits), jnp.asarray(labels))
        assert _rel_err(getattr(t_losses, name)(_t(logits), _t(labels)), ref) <= VAL_TOL


def _seg_loss_jax(logits, labels):
    return jax_losses.cross_entropy_loss(logits, labels) + jax_losses.dice_loss(logits, labels)


def test_unet_train_loss_and_grads_match_jax():
    """Depth 2 in train mode, as the JAX trainer builds it (level 0 in s2d,
    level 1 standard: JAX training keeps level 1 off the s2d form) against
    the port, whose structural level 1 runs in s2d: the same function."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 2, (2, 16, 16))
    jm = jax_unet.UNet(init_features=16, depth=2, s2d_level0=True)
    v = jm.init(jax.random.key(1), jnp.asarray(x))
    v = {"params": v["params"], "batch_stats": _perturb_stats(v["batch_stats"], 2)}

    def loss(params):
        (logits, _, _), upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jnp.asarray(x),
                                       train=True, mutable=["batch_stats"])
        return _seg_loss_jax(logits, jnp.asarray(labels)), upd["batch_stats"]

    with jax.default_matmul_precision("highest"):
        (ref, stats), grads = jax.value_and_grad(loss, has_aux=True)(v["params"])
    tm = t_unet.UNet(_gen(), init_features=16, depth=2)
    load_jax_variables(tm, _np_tree(v))
    tm.train()
    out = tm(_t(x))
    assert set(out["skip_s2d"]) == {0, 1}
    got = t_losses.cross_entropy_loss(out["logits"], _t(labels)) + t_losses.dice_loss(out["logits"], _t(labels))
    got.backward()
    assert _rel_err(got, ref) <= VAL_TOL
    _check_grads(tm, grads)
    _check_stats(tm, stats)


# ---------------------------------------------------------------------------
# Train steps: the port's make_train_step against the JAX trainer's
# ---------------------------------------------------------------------------


def _small_cfg(jax_side: bool, optimizer="adam"):
    cfg = (JaxPipelineConfig if jax_side else PipelineConfig)()
    cfg.model.unet.init_features = 16
    cfg.model.unet.depth = 2
    cfg.training.optimizer = optimizer
    cfg.training.lr_step_size = 1  # the rate drops after two steps at two steps per epoch
    cfg.training.lr_gamma = 0.5
    return cfg


RELU_MARGIN = 2e-6


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_three_train_steps_match_jax(optimizer, monkeypatch):
    # The trajectories are compared elementwise, which is well-posed only
    # away from ReLU's kink: an input within f32 rounding (~1e-7 of its
    # tensor's scale) of zero may fall on either side in the two frameworks
    # and switch a gradient path on or off. The data (seed 13) keep every
    # ReLU input of the port at least RELU_MARGIN of max |input| from zero,
    # and the test checks that they do.
    margins = []
    relu = torch.relu

    def relu_with_margin(x):
        a = x.detach().abs()
        margins.append(float(a.min() / a.max()))
        return relu(x)

    monkeypatch.setattr(torch, "relu", relu_with_margin)
    rng = np.random.default_rng(13)
    imgs = rng.integers(0, 256, (3, 2, 16, 16, 3)).astype(np.uint8)
    masks = rng.integers(0, 2, (3, 2, 16, 16)).astype(np.uint8)
    jcfg, cfg = _small_cfg(True, optimizer), _small_cfg(False, optimizer)
    jm = jax_seg.build_unet(jcfg)
    tx, _ = jax_common.make_optimizer(jcfg.training, steps_per_epoch=2)
    variables = jm.init(jax.random.key(2), jnp.zeros((2, 16, 16, 3)))
    jstate = jax_common.TrainState.create(variables, tx)
    jstep = jax.jit(jax_seg.make_train_step(jm, tx, jcfg, augment=False))

    model = t_seg.build_unet(cfg, device="cpu")
    load_jax_variables(model, _np_tree(variables))
    opt, sched = t_common.make_optimizer(model.parameters(), cfg.training, steps_per_epoch=2)
    state = t_common.TrainState(model, opt, sched)
    step = t_seg.make_train_step(cfg, augment=False)
    gen = _gen()
    for i in range(3):
        with jax.default_matmul_precision("highest"):
            jstate, jm_metrics = jstep(jstate, jnp.asarray(imgs[i]), jnp.asarray(masks[i]), jax.random.key(i))
        metrics = step(state, _t(imgs[i]), _t(masks[i]), gen)
        for k in ("loss", "ce", "dice"):
            assert _rel_err(metrics[k], np.asarray(jm_metrics[k])) <= VAL_TOL, (i, k)
    assert len(margins) == 3 * 10 and min(margins) >= RELU_MARGIN
    assert state.step == int(jstate.step) == 3
    assert opt.param_groups[0]["lr"] == pytest.approx(cfg.training.learning_rate * 0.5)
    # Parameters move by lr·(update) from the same start: the updates are
    # compared, at the gradient tolerance of their largest element plus
    # one f32 rounding of the parameter on each side (a BN scale near 1
    # holds an update of 1e-4 to 1e-3 of itself).
    ref = variables_from_jax({"params": _np_tree(jstate.params)})
    start = variables_from_jax({"params": _np_tree(variables["params"])})
    lr = cfg.training.learning_rate
    for n, p in model.named_parameters():
        upd, upd_ref = p.detach().numpy() - start[n].numpy(), ref[n].numpy() - start[n].numpy()
        diff = np.abs(upd - upd_ref)
        tol = GRAD_TOL * np.abs(upd_ref).max() + 2 * np.spacing(np.abs(ref[n].numpy())).max()
        if _feeds_bn(n):
            # Zero gradient in exact arithmetic: Adam turns its rounding
            # noise into updates of up to lr a step.
            assert diff.max() <= 3 * lr, n
        elif optimizer == "adam":
            # Adam moves an element by about lr·sign(g) whatever |g|, so an
            # element whose gradient is at rounding level may differ by up
            # to lr a step: at most 0.1% of a leaf's elements.
            far = diff > tol
            assert far.mean() <= 1e-3 and diff.max() <= 3 * lr, n
        else:
            assert diff.max() <= tol, n
    # A running mean includes its conv's bias (0.1 of it a step), so under
    # Adam it inherits that bias's noise: 0.1·(lr + 2·lr) after three steps.
    _check_stats(model, jstate.batch_stats, mean_atol=0.3 * lr if optimizer == "adam" else 0.0)


def test_steplr_schedule_matches_jax():
    cfg = JaxTrainingConfig(learning_rate=0.1, lr_step_size=2, lr_gamma=0.5)
    sched = jax_common.make_lr_schedule(cfg, steps_per_epoch=10)
    p = torch.nn.Parameter(torch.zeros(1))
    opt, tsched = t_common.make_optimizer([p], t_common.TrainingConfig(learning_rate=0.1, lr_step_size=2,
                                                                       lr_gamma=0.5), steps_per_epoch=10)
    for step in range(45):
        assert opt.param_groups[0]["lr"] == pytest.approx(float(sched(step))), step
        opt.step()
        tsched.step()


def test_multistep_is_the_steps_in_order():
    calls = []

    def step(state, imgs, masks, gen):
        calls.append(float(imgs.sum()))
        return {"loss": imgs.sum() * 2}

    imgs = torch.arange(6.0).reshape(3, 2)
    out = t_common.make_multistep(step, 3)(None, imgs, imgs, None)
    assert calls == [1.0, 5.0, 9.0] and float(out["loss"]) == pytest.approx(10.0)
    with pytest.raises(ValueError, match="expects 3 batches"):
        t_common.make_multistep(step, 3)(None, imgs[:2], imgs[:2], None)


# ---------------------------------------------------------------------------
# Augmentation: the same draws through both frameworks
# ---------------------------------------------------------------------------


def _jax_draws(key, b, h, w, flip_prob, degrees, crop_prob):
    """The per-image parameters device_preprocess_batch draws from ``key``
    (its split schedule), as an AugmentDraw."""
    flips, angles, crops = [], [], []
    for k in jax.random.split(key, b):
        k_flip, k_rot, k_crop = jax.random.split(k, 3)
        flips.append(bool(jax.random.bernoulli(k_flip, flip_prob)))
        angles.append(float(-jax.random.uniform(k_rot, (), minval=-degrees, maxval=degrees) * jnp.pi / 180.0))
        k_apply, k_area, k_ratio, k_y, k_x = jax.random.split(k_crop, 5)
        area = jax.random.uniform(k_area, (), minval=0.8, maxval=1.0)
        aspect = jnp.exp(jax.random.uniform(k_ratio, (), minval=jnp.log(0.75), maxval=jnp.log(4.0 / 3.0)))
        ch = jnp.clip(jnp.sqrt(area / aspect) * h, 1.0, h)
        cw = jnp.clip(jnp.sqrt(area * aspect) * w, 1.0, w)
        y0 = jax.random.uniform(k_y, (), minval=0.0, maxval=1.0) * (h - ch)
        x0 = jax.random.uniform(k_x, (), minval=0.0, maxval=1.0) * (w - cw)
        apply = bool(jax.random.bernoulli(k_apply, crop_prob))
        crops.append([float(y0), float(x0), float(ch), float(cw)] if apply else [0.0, 0.0, float(h), float(w)])
    return t_image.AugmentDraw(torch.tensor(flips), torch.tensor(angles, dtype=torch.float32),
                               torch.tensor(crops, dtype=torch.float32) if crop_prob > 0 else None)


@pytest.mark.parametrize("num_classes,crop_prob", [(2, 0.5), (2, 0.0), (3, 0.5)])
def test_device_preprocess_matches_jax_with_the_same_draws(num_classes, crop_prob):
    """The packed binary-mask path (num_classes 2: the mask rides the linear
    warp and is rounded, labels above 1 become 0) and the nearest path.
    Images within 1e-5 of their scale; masks equal."""
    b, h, w = 4, 24, 20
    rng = np.random.default_rng(9)
    imgs = rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8)
    masks = np.zeros((b, h, w), np.int32)
    masks[:, 5:17, 4:15] = 1
    masks[:, 8:12, 6:9] = 2  # a label above 1
    key = jax.random.key(11)
    with jax.default_matmul_precision("highest"):
        ref_i, ref_m = jax_dataset.device_preprocess_batch(
            key, jnp.asarray(imgs), jnp.asarray(masks), jax_image.IMAGENET_MEAN, jax_image.IMAGENET_STD,
            augment=True, flip_prob=0.5, rotation_degrees=15.0, crop_prob=crop_prob, num_classes=num_classes)
    draw = _jax_draws(key, b, h, w, 0.5, 15.0, crop_prob)
    assert draw.flip.any() and not draw.flip.all()
    got_i, got_m = t_dataset.device_preprocess_batch(_t(imgs), _t(masks), t_image.IMAGENET_MEAN,
                                                     t_image.IMAGENET_STD, draw, num_classes=num_classes)
    assert _rel_err(got_i, ref_i) <= 1e-5
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    assert got_m.dtype == torch.int32


def test_draws_are_seeded_and_in_range():
    d1 = t_image.draw_augment(torch.Generator().manual_seed(4), 64, 30, 40, 0.5, 10.0, 0.5)
    d2 = t_image.draw_augment(torch.Generator().manual_seed(4), 64, 30, 40, 0.5, 10.0, 0.5)
    for a, b in zip(d1, d2):
        assert torch.equal(a, b)
    assert 0 < int(d1.flip.sum()) < 64
    assert float(d1.angle.abs().max()) <= math.radians(10.0)
    y0, x0, ch, cw = d1.crop.unbind(1)
    assert bool(((y0 >= 0) & (y0 + ch <= 30 + 1e-4) & (x0 >= 0) & (x0 + cw <= 40 + 1e-4)).all())
    whole = (ch == 30) & (cw == 40)
    assert 0 < int(whole.sum()) < 64
    assert t_image.draw_augment(torch.Generator(), 2, 8, 8).crop is None


# ---------------------------------------------------------------------------
# Host side: config, loader, metrics, checkpoints, logging
# ---------------------------------------------------------------------------


def test_config_matches_jax():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg_dir = os.path.join(repo, "configs")
    from_files = PipelineConfig.from_config_dir(cfg_dir)
    assert from_files.to_dict() == JaxPipelineConfig.from_config_dir(cfg_dir).to_dict()
    assert PipelineConfig().to_dict() == JaxPipelineConfig().to_dict()
    # chip_smoke.py trains the defaults' U-Net, as the card's machine may lack PyYAML.
    assert PipelineConfig().model.unet == from_files.model.unet


def test_batch_loader_matches_jax(tmp_path):
    make_dummy_run(str(tmp_path), num_images=5, image_size=(24, 20), batch_size=2)
    img_dir, mask_dir = tmp_path / "data/train/images", tmp_path / "data/train/masks"
    # The cv2 paths of both loaders (the native C++ paths, whose bilinear
    # resize is within 1 of cv2's, are held to each other in test_torch_data.py).
    jds = jax_dataset.MangoDataset(str(img_dir), str(mask_dir), image_size=(16, 24), use_native=False)
    tds = t_dataset.MangoDataset(str(img_dir), str(mask_dir), image_size=(16, 24), use_native=False)
    for drop_last in (True, False):
        jl = jax_dataset.BatchLoader(jds, 2, shuffle=True, drop_last=drop_last, seed=3)
        tl = t_dataset.BatchLoader(tds, 2, shuffle=True, drop_last=drop_last, seed=3)
        assert len(tl) == len(jl)
        for epoch in (0, 1):
            jb, tb = list(jl.epoch(epoch)), list(tl.prefetch_epoch(epoch))
            assert len(jb) == len(tb)
            for (ji, jmask), (ti, tmask) in zip(jb, tb):
                np.testing.assert_array_equal(ti, ji)
                np.testing.assert_array_equal(tmask, jmask)
                assert ti.dtype == np.uint8 and tmask.dtype == np.int32


def test_segmentation_metrics_match_jax():
    rng = np.random.default_rng(10)
    t, p = rng.integers(0, 3, 500), rng.integers(0, 3, 500)
    ref = jax_metrics.segmentation_metrics(t, p, 3)
    got = t_metrics.segmentation_metrics(t, p, 3)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]), rtol=0, atol=0)


def test_checkpoint_retention_and_restore(tmp_path):
    best = CheckpointManager(str(tmp_path / "best"), max_to_keep=2, best_metric="loss", best_mode="min")
    for step, loss in [(1, 0.9), (2, 0.2), (3, 0.7), (4, 0.5)]:
        best.save(step, {"w": torch.full((2,), loss)}, metrics={"loss": loss})
    assert best.best_step == 2 and best.all_steps() == [2, 4] and best.latest_step == 4
    assert sorted(os.listdir(tmp_path / "best")) == ["checkpoints.json", "step_2.pt", "step_4.pt"]
    reopened = CheckpointManager(str(tmp_path / "best"), max_to_keep=2, best_metric="loss")
    assert reopened.all_steps() == [2, 4]
    assert torch.equal(reopened.restore(2)["w"], torch.full((2,), 0.2))
    with pytest.raises(ValueError, match="needs the metric"):
        best.save(5, {"w": torch.zeros(1)})
    newest = CheckpointManager(str(tmp_path / "newest"), max_to_keep=3)
    assert newest.restore_latest() is None
    for step in range(1, 6):
        newest.save(step, {"step": step})
    assert newest.all_steps() == [3, 4, 5] and newest.restore_latest()["step"] == 5


def test_metrics_logger_writes_jsonl(tmp_path):
    with MetricsLogger(str(tmp_path), "run", log_interval=2, echo=False) as log:
        log.log(1, {"loss": torch.tensor(0.5), "epoch": 0})
        log.log(2, {"loss": 0.25})
        path = log.path
    rows = [json.loads(line) for line in open(path)]
    assert [(r["step"], r["loss"]) for r in rows] == [(1, 0.5), (2, 0.25)]


# ---------------------------------------------------------------------------
# The trainer, mirroring tests/test_training.py::TestSegmentationTrainer
# ---------------------------------------------------------------------------


def test_trainer_loss_decreases_and_resumes(tmp_path):
    cfg_dir = make_dummy_run(str(tmp_path), num_images=4, image_size=(32, 32), batch_size=2,
                             num_epochs=2, patch_size=8, init_features=4, depth=2)
    state, history = t_seg.train_unet_segmentation(cfg_dir, max_epochs=2, device="cpu")
    assert len(history["epoch_loss"]) == 2 and state.step == 4
    state2, history2 = t_seg.train_unet_segmentation(cfg_dir, max_epochs=4, device="cpu")
    assert state2.step == 8 and len(history2["epoch_loss"]) == 2


def test_trainer_reduces_loss_on_learnable_task(tmp_path):
    cfg_dir = make_dummy_run(str(tmp_path), num_images=8, image_size=(32, 32), batch_size=4,
                             num_epochs=8, patch_size=8, init_features=8, depth=2, seed=1)
    _, history = t_seg.train_unet_segmentation(cfg_dir, max_epochs=8, device="cpu")
    assert history["epoch_loss"][-1] < history["epoch_loss"][0] * 0.9


def test_trainer_refuses_multi_device(tmp_path):
    """Data and spatial parallelism need the caller's process group
    (without one the mesh has a single rank)."""
    cfg_dir = make_dummy_run(str(tmp_path), num_images=2, image_size=(16, 16), batch_size=2)
    path = os.path.join(cfg_dir, "training.yaml")
    text = open(path).read()
    open(path, "w").write(text.replace("data_parallel: 1", "data_parallel: 2"))
    with pytest.raises(ValueError, match="needs 2 ranks, only 1 available"):
        t_seg.train_unet_segmentation(cfg_dir, device="cpu")
    open(path, "w").write(text.replace("spatial_parallel: 1", "spatial_parallel: 2"))
    with pytest.raises(ValueError, match="needs 2 ranks, only 1 available"):
        t_seg.train_unet_segmentation(cfg_dir, device="cpu")


def test_evaluate_unet_matches_jax(tmp_path):
    make_dummy_run(str(tmp_path), num_images=3, image_size=(32, 32))
    img_dir, mask_dir = str(tmp_path / "data/train/images"), str(tmp_path / "data/train/masks")
    jcfg, cfg = _small_cfg(True), _small_cfg(False)
    jcfg.preprocessing.resize_dim = cfg.preprocessing.resize_dim = (32, 32)
    jm = jax_seg.build_unet(jcfg)
    variables = jm.init(jax.random.key(4), jnp.zeros((1, 32, 32, 3)))
    variables = {"params": variables["params"], "batch_stats": _perturb_stats(variables["batch_stats"], 3)}
    jstate = jax_common.TrainState.create(variables, jax_common.make_optimizer(jcfg.training, 1)[0])
    ref = jax_seg.evaluate_unet(jm, jstate, jax_dataset.MangoDataset(img_dir, mask_dir, (32, 32)), jcfg, 2)
    model = load_jax_variables(t_seg.build_unet(cfg, device="cpu"), _np_tree(variables))
    got = t_seg.evaluate_unet(model, t_dataset.MangoDataset(img_dir, mask_dir, (32, 32)), cfg, 2)
    np.testing.assert_array_equal(got["confusion_matrix"], ref["confusion_matrix"])
    assert model.training
