"""The end-to-end training slice of mingraph_unet_tpu_torch against the JAX
package on the CPU: MinGraphUNet in train mode (pooled and reference-exact
detection paths) and three ``make_e2e_train_step`` steps against the JAX
trainer's (the host side of the trainer is ``test_torch_e2e_trainer.py``).

Configuration: ``tests/test_parallel.py``'s small e2e model (U-Net init 4–8,
depth 2, GAT 8/4/2 heads, patch 8) at 32² batch 2, f32, under
``jax.default_matmul_precision("highest")``. Dropout cannot match JAX's
random bits, so it is patched to the identity on both sides (flax
``nn.Dropout.__call__`` and the port's ``layers.dropout``).

Tolerances, relative to max |ref|: values 2e-4, gradients 1e-3 (PARITY.md
M5), with ``tests/test_torch_train.py``'s two exceptions: a leaf whose
gradient is zero in exact arithmetic (``_zero_in_exact_arithmetic``) is
held to an absolute bound, and Adam turns rounding-level gradients into
updates of up to ``lr``. Elementwise comparison of trajectories is
well-posed only away from the discrete decisions: ReLU and leaky-ReLU
signs, max-pool winners, the MinCut argmax and the CC threshold at 0.5.
The data keep every one of them clear of its kink, and the tests check it
(``decisions``).
"""

import dataclasses
import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingraph_unet_tpu.config import PipelineConfig as JaxPipelineConfig
from mingraph_unet_tpu.models.pipeline import MinGraphUNet as JaxMinGraphUNet
from mingraph_unet_tpu.train import common as jax_common
from mingraph_unet_tpu.train import end_to_end as jax_e2e
from mingraph_unet_tpu_torch.config import PipelineConfig
from mingraph_unet_tpu_torch.convert import load_jax_variables, variables_from_jax
from mingraph_unet_tpu_torch.models import gat as t_gat
from mingraph_unet_tpu_torch.models import layers as t_layers
from mingraph_unet_tpu_torch.models import losses as t_losses
from mingraph_unet_tpu_torch.models.pipeline import MinGraphUNet
from mingraph_unet_tpu_torch.ops import filters as t_filters
from mingraph_unet_tpu_torch.ops import s2d as t_s2d
from mingraph_unet_tpu_torch.train import common as t_common
from mingraph_unet_tpu_torch.train import end_to_end as t_e2e

VAL_TOL, GRAD_TOL = 2e-4, 1e-3
S, B = 32, 2
# Least distance of a decision from its kink, relative to the largest
# magnitude in its tensor (ReLU, leaky ReLU, pool) or absolute
# (probabilities). One f32 rounding of that largest value is 6e-8 of it;
# 5e-7 leaves room for the few roundings by which the frameworks' sums
# differ. The seeds were picked so that every decision of every case and
# step clears its margin.
MARGINS = {"relu": 5e-7, "leaky": 1e-6, "pool": 1e-6, "argmax": 1e-4, "cc": 1e-5}


def _rel_err(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _zero_in_exact_arithmetic(name: str) -> bool:
    """A leaf whose gradient is zero in exact arithmetic, so that both
    frameworks' gradients are rounding noise: a U-Net conv bias, which
    feeds a train-mode BatchNorm directly (BN subtracts the batch mean),
    and the region GAT's attention vectors at two regions (each node
    attends its single neighbour with weight 1 whatever the scores). The
    detection head's conv biases are not among them: a ReLU sits between
    each and its BN."""
    return re.match(r"unet\.(encoder|decoder)\..*\.conv[12]\.bias$", name) is not None or name.startswith(
        ("region_gat.layer0.heads.a_src", "region_gat.layer0.heads.a_dst"))


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, inputs, deterministic=None, rng=None: inputs)
    monkeypatch.setattr(t_layers, "dropout", lambda x, p, gen: x)


@pytest.fixture
def decisions(monkeypatch):
    """Records, for every discrete decision the port makes, its least
    distance from the kink (see MARGINS)."""
    got = {k: [] for k in MARGINS}

    def rel_min(x, nonzero=False):
        a = x.detach().abs()
        scale = float(a.max())
        if nonzero:
            a = a[a > 0]
        return float(a.min()) / max(scale, 1e-30) if a.numel() else 1.0

    relu, leaky, pool = torch.relu, t_gat.leaky_relu, t_s2d.phase_max_pool
    shape_loss = t_losses.elliptical_shape_loss_soft_instances

    def relu_r(x):
        got["relu"].append(rel_min(x))
        return relu(x)

    def leaky_r(x, alpha):
        # An exact 0 (an empty region's score) is 0 in both frameworks.
        got["leaky"].append(rel_min(x, nonzero=True))
        return leaky(x, alpha)

    def pool_r(y, r=2):
        b, hh, ww, cc = y.shape
        v = y.detach().reshape(b, hh, ww, r * r, cc // (r * r)).sort(dim=3, descending=True).values
        gap = v[..., 0, :] - v[..., 1, :]
        gap = gap[gap > 0]  # exact ties (zeros after a ReLU) split alike in both
        got["pool"].append(float(gap.min()) / float(y.detach().abs().max()) if gap.numel() else 1.0)
        return pool(y, r)

    def shape_loss_r(probs, **kw):
        d = (probs[..., 1].detach() - 0.5).abs()
        d = d[d > 0]  # exactly 0.5 (equal logits) is below the threshold in both
        got["cc"].append(float(d.min()) if d.numel() else 1.0)
        return shape_loss(probs, **kw)

    monkeypatch.setattr(torch, "relu", relu_r)
    monkeypatch.setattr(t_gat, "leaky_relu", leaky_r)
    monkeypatch.setattr(t_s2d, "phase_max_pool", pool_r)
    monkeypatch.setattr(t_losses, "elliptical_shape_loss_soft_instances", shape_loss_r)
    return got


def _argmax_margin_hook(store):
    def hook(module, inputs, out):
        top2 = out[1].detach().topk(2, dim=-1).values
        store.append(float((top2[..., 0] - top2[..., 1]).min()))
    return hook


def _check_margins(got, expect_kinds):
    for kind in expect_kinds:
        assert got[kind], f"no {kind} decisions recorded"
        assert min(got[kind]) >= MARGINS[kind], (kind, min(got[kind]))


# ---------------------------------------------------------------------------
# MinGraphUNet in train mode
# ---------------------------------------------------------------------------

MODEL = dict(init_features=8, depth=2, patch_size=8, unet_patch_feature_dim=4, gat_hidden_dim=8, gat_output_dim=4,
             gat_num_heads=2)
COMPARED = ("logits", "pred_bboxes", "pred_confidence", "l_partition", "soft_assignments", "gat_feats",
            "f_unet_patches", "region_embeddings", "region_counts")


def _images(seed, b=B, s=S):
    """Normalized NHWC images: a disc on a background, with noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:s, :s]
    cy, cx = s * rng.uniform(0.3, 0.7, (2, b, 1, 1))
    disc = ((yy - cy) ** 2 + (xx - cx) ** 2 < (0.3 * s) ** 2)[..., None]
    img = np.where(disc, rng.uniform(0, 1, (b, 1, 1, 3)), rng.uniform(0, 1, (b, 1, 1, 3)))
    img = np.clip(img + 0.05 * rng.standard_normal((b, s, s, 3)), 0, 1)
    return ((img - np.array([0.485, 0.456, 0.406])) / np.array([0.229, 0.224, 0.225])).astype(np.float32)


@pytest.mark.parametrize("pre_pool", [S // 8, None, 2], ids=["pooled", "full_res", "full_res_head_pool"])
def test_mingraph_unet_train_mode_matches_flax(pre_pool, no_dropout, decisions):
    """Outputs, parameter gradients of Σ sum(out·r) and the updated batch
    statistics against flax ``apply(train=True, mutable=["batch_stats"])``."""
    x = _images(7)
    jm = JaxMinGraphUNet(dtype=jnp.float32, detection_pre_pool=pre_pool, **MODEL)
    v = jax.jit(jm.init)(jax.random.key(4), jnp.asarray(x))
    rng = np.random.default_rng(2)
    out_shapes = jax.eval_shape(lambda: jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"],
                                                 rngs={"dropout": jax.random.key(0)})[0])
    r = {k: rng.standard_normal(out_shapes[k].shape).astype(np.float32) for k in COMPARED if k != "region_counts"}

    def loss(params):
        out, upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jnp.asarray(x), train=True,
                            mutable=["batch_stats"], rngs={"dropout": jax.random.key(0)})
        return sum(jnp.sum(out[k] * r[k]) for k in r), (out, upd["batch_stats"])

    with jax.default_matmul_precision("highest"):
        (_, (ref, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
    model = load_jax_variables(MinGraphUNet(device="cpu", detection_pre_pool=pre_pool, **MODEL), _np_tree(v))
    model.train()
    margins = []
    model.mincut.register_forward_hook(_argmax_margin_hook(margins))
    out = model(_t(x), gen=torch.Generator().manual_seed(0), full_res_outputs=True)
    sum((out[k] * _t(r[k])).sum() for k in r).backward()
    _check_margins(dict(decisions, argmax=margins), ("relu", "leaky", "pool", "argmax"))

    for k in COMPARED:
        assert _rel_err(out[k], ref[k]) <= VAL_TOL, k
    np.testing.assert_array_equal(out["hard_patch_labels"].numpy(), np.asarray(ref["hard_patch_labels"]))
    assert ("fused" in out) == (pre_pool != S // 8) == ("fused" in ref)
    if "fused" in ref:
        assert _rel_err(out["fused"], ref["fused"]) <= VAL_TOL
    ref_g = variables_from_jax({"params": _np_tree(grads)})
    top = max(np.abs(g.numpy()).max() for g in ref_g.values())
    for n, p in model.named_parameters():
        if _zero_in_exact_arithmetic(n):
            assert np.abs(p.grad.numpy() - ref_g[n].numpy()).max() <= GRAD_TOL * top, n
        else:
            assert _rel_err(p.grad, ref_g[n]) <= GRAD_TOL, n
    ref_s = variables_from_jax({"batch_stats": _np_tree(stats)})
    bufs = dict(model.named_buffers())
    assert sorted(bufs) == sorted(ref_s) and "detection_head.bn2.var" in bufs
    for n, buf in bufs.items():
        assert np.abs(buf.numpy() - ref_s[n].numpy()).max() <= VAL_TOL * np.abs(ref_s[n].numpy()).max(), n


def test_train_mode_needs_a_generator_and_eval_has_no_graph():
    model = MinGraphUNet(device="cpu", detection_pre_pool=None, **MODEL)
    x = _t(_images(1))
    assert not model.training and not model(x)["pred_bboxes"].requires_grad
    model.train()
    with pytest.raises(ValueError, match="pass gen"):
        model(x)
    out = model(x, gen=torch.Generator().manual_seed(0))
    assert out["pred_bboxes"].requires_grad and out["l_partition"].requires_grad


def test_dropout_draws_from_the_generator():
    """In train mode the GATs and the head drop with the step's generator:
    the same seed gives the same outputs, another seed others; in eval
    the outputs do not depend on it."""
    model = MinGraphUNet(device="cpu", **MODEL).train()
    x = _t(_images(2))
    outs = [model(x, gen=torch.Generator().manual_seed(s))["pred_bboxes"].detach() for s in (5, 5, 6)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


def test_histeq_runs_once_per_forward(monkeypatch):
    """The hist-eq feature goes through the K6 wrapper once per forward, in
    eval (serving) and in train mode."""
    calls = []
    real = t_filters.equalize_channel

    def spy(y):
        calls.append(tuple(y.shape))
        assert y.dtype == torch.uint8
        return real(y)

    monkeypatch.setattr(t_filters, "equalize_channel", spy)
    model = MinGraphUNet(device="cpu", detection_pre_pool=S // 8, **MODEL)
    model(_t(_images(3)))
    model.train()(_t(_images(3)), gen=torch.Generator())
    assert calls == [(B, S, S), (B, S, S)]


# ---------------------------------------------------------------------------
# make_e2e_train_step against the JAX trainer
# ---------------------------------------------------------------------------


def _small_cfg(jax_side, optimizer="adam", balance="none", psup=0.0, warmup=False):
    cfg = (JaxPipelineConfig if jax_side else PipelineConfig)()
    cfg.preprocessing.resize_dim = (S, S)
    cfg.model.unet.init_features, cfg.model.unet.depth = 4, 2
    cfg.model.gat.hidden_dim, cfg.model.gat.output_dim, cfg.model.gat.num_heads = 8, 4, 2
    cfg.model.graph_construction.patch_size, cfg.model.graph_construction.unet_patch_feature_dim = 8, 4
    cfg.training.optimizer = optimizer
    cfg.training.loss_balance = balance
    cfg.training.lr_step_size, cfg.training.lr_gamma = 1, 0.5  # the rate halves after two steps
    cfg.model.losses.l_partition_sup_weight = psup
    if warmup:  # the trainer's warm-up phase: every graph term's weight 0
        cfg.model.losses = dataclasses.replace(cfg.model.losses, l_shape_weight=0.0, l_feature_weight=0.0,
                                               l_partition_weight=0.0, l_smooth_weight=0.0,
                                               l_partition_sup_weight=0.0)
    return cfg


def _orchard_batches(seed, steps=3):
    """uint8 orchard-like images (green ground, orange discs, noise) and
    their disc masks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:S, :S]
    out = []
    for _ in range(steps):
        mask = np.zeros((B, S, S), np.uint8)
        for i in range(B):
            for _ in range(2):
                cy, cx = rng.uniform(0.2 * S, 0.8 * S, 2)
                r = rng.uniform(0.1 * S, 0.2 * S)
                mask[i] |= ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r).astype(np.uint8)
        img = np.where(mask[..., None] == 1, np.array([230, 140, 30]), np.array([40, 110, 35]))
        img = img + rng.normal(0, 25, (B, S, S, 3))
        out.append((np.clip(img, 0, 255).astype(np.uint8), mask))
    return out


def fast_compile(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` at XLA's CPU optimization level
    1: the default level's backend passes take most of a small model's
    compile time (12 s of a train step's, 9 s of an init's) and change
    nothing here (an init's weights bit-equal, a train step's terms within
    f32 rounding over three steps; level 0 miscompiles the train step, NaN
    from its second call)."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 1})


def _start_variables(jm, jcfg):
    """The JAX model's init, with the final 1×1 conv scaled so that the
    foreground probability crosses 0.5 in blobs (the shape loss then has
    instances) and clear of it elsewhere."""
    args = (jax.random.key(0), jnp.zeros((B, S, S, 3)))
    v = fast_compile(jm.init, *args)(*args)
    params = jax.tree_util.tree_map(lambda a: a, v["params"])
    fc = params["unet"]["decoder"]["final_conv"]
    fc["kernel"] = fc["kernel"] * 4.0
    fc["bias"] = fc["bias"] + jnp.asarray([-0.5, 0.5])
    return jax_e2e._augment_variables({"params": params, "batch_stats": v["batch_stats"]}, jcfg.training)


E2E_CASES = {
    "adam": dict(optimizer="adam"),
    "sgd_uncertainty_psup": dict(optimizer="sgd", balance="uncertainty", psup=0.5),
    "adam_uncertainty_psup": dict(optimizer="adam", balance="uncertainty", psup=0.5),
    "adam_warmup_phase": dict(optimizer="adam", warmup=True),
}


def three_e2e_steps_vs_jax(jcfg, cfg, decisions, train_detection=True, zero_exact=_zero_in_exact_arithmetic,
                           batch_seed=46, start=_start_variables):
    """Three ``make_e2e_train_step`` steps of the port against the JAX
    trainer's from the same start (``_start_variables``) on
    ``_orchard_batches(batch_seed)``: every term of every step at VAL_TOL,
    the updates after three steps at GRAD_TOL as ``tests/test_torch_train.py``
    compares them (``zero_exact``: the leaves whose gradient is zero in
    exact arithmetic), the BN statistics, the learning-rate schedule, and
    every discrete decision clear of its kink. ``start(jm, jcfg)`` gives the
    starting variables. Returns the port's terms of each step."""
    jm = jax_e2e.build_mingraph_unet(jcfg, dtype=jnp.float32)
    tx, _ = jax_common.make_optimizer(jcfg.training, steps_per_epoch=2)
    variables = start(jm, jcfg)
    jstate = jax_common.TrainState.create(variables, tx)
    batches = _orchard_batches(batch_seed)
    with jax.default_matmul_precision("highest"):
        jstep = fast_compile(jax_e2e.make_e2e_train_step(jm, tx, jcfg, augment=False, train_detection=train_detection),
                             jstate, jnp.asarray(batches[0][0]), jnp.asarray(batches[0][1]), jax.random.key(0))

    model = t_e2e.build_mingraph_unet(cfg, device="cpu")
    load_jax_variables(model, _np_tree(variables))
    opt, sched = t_common.make_optimizer(model.parameters(), cfg.training, steps_per_epoch=2)
    state = t_common.TrainState(model, opt, sched)
    step = t_e2e.make_e2e_train_step(model, opt, cfg, augment=False, train_detection=train_detection)
    argmax = []
    if model.use_partition:
        model.mincut.register_forward_hook(_argmax_margin_hook(argmax))
    gen = torch.Generator().manual_seed(0)
    terms = []
    for i, (imgs, masks) in enumerate(batches):
        jstate, ref = jstep(jstate, jnp.asarray(imgs), jnp.asarray(masks), jax.random.key(i))
        got = step(state, _t(imgs), _t(masks), gen)
        assert sorted(got) == sorted(ref), i
        for k in ref:
            assert _rel_err(got[k], np.asarray(ref[k])) <= VAL_TOL, (i, k)
        assert float(ref["l_shape"]) > 0.0, "the shape loss must see instances"
        terms.append(got)
    kinds = ["relu", "pool", "cc"] + (["leaky"] if model.use_patch_gat or model.use_partition else []) + (
        ["argmax"] if model.use_partition else [])
    _check_margins(dict(decisions, argmax=argmax), kinds)
    assert state.step == int(jstate.step) == 3
    assert opt.param_groups[0]["lr"] == pytest.approx(cfg.training.learning_rate * 0.5)

    # Updates from the same start, as tests/test_torch_train.py compares them.
    lr = cfg.training.learning_rate
    adam = cfg.training.optimizer == "adam"
    ref_p = variables_from_jax({"params": _np_tree(jstate.params)})
    start = variables_from_jax({"params": _np_tree(variables["params"])})
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(ref_p)
    assert ("loss_balance.log_vars" in ref_p) == (cfg.training.loss_balance == "uncertainty")
    for n, p in model.named_parameters():
        upd, upd_ref = p.detach().numpy() - start[n].numpy(), ref_p[n].numpy() - start[n].numpy()
        diff = np.abs(upd - upd_ref)
        tol = GRAD_TOL * np.abs(upd_ref).max() + 2 * np.spacing(np.abs(ref_p[n].numpy())).max()
        if zero_exact(n):
            assert diff.max() <= 3 * lr, n
        elif adam:
            # Adam moves an element by about lr·sign(g) whatever |g|: an
            # element whose gradient is at rounding level may differ by up
            # to lr a step. At most one element, or 0.1%, of a leaf.
            far = diff > tol
            assert far.sum() <= max(1, 1e-3 * far.size) and diff.max() <= 3 * lr, n
        else:
            assert diff.max() <= tol, n
    if cfg.model.losses.l_partition_sup_weight and cfg.training.loss_balance == "uncertainty":
        assert np.abs(ref_p["loss_balance.log_vars"].numpy()).min() > 0.0  # every slot in use
    ref_s = variables_from_jax({"batch_stats": _np_tree(jstate.batch_stats)})
    # A running mean takes 0.1 of its conv's bias each step, and under Adam
    # such a bias may differ by up to 3·lr (above): 0.1·(0.9·3 + 3)·lr after
    # the steps that see a moved bias.
    mean_atol = 0.6 * lr if adam else 0.0
    bufs = dict(model.named_buffers())
    assert sorted(bufs) == sorted(ref_s)
    for n, buf in bufs.items():
        r = ref_s[n].numpy()
        atol = mean_atol if n.endswith(".mean") else 0.0
        assert np.abs(buf.numpy() - r).max() <= VAL_TOL * np.abs(r).max() + atol, n
    return terms


def test_fast_compile_matches_the_default_level(no_dropout):
    """``fast_compile``, which builds every JAX reference of the parity
    tests, against ``jax.jit`` at XLA's default level on the same inputs:
    the init bit for bit, the eval forward at VAL_TOL, and three e2e train
    steps (SGD, the uncertainty balancer, L_partition_sup): every term of
    every step and the BN statistics at VAL_TOL, the updates at GRAD_TOL
    (the leaves whose gradient is zero in exact arithmetic to 3·lr)."""
    jcfg = _small_cfg(True, **E2E_CASES["sgd_uncertainty_psup"])
    jm = jax_e2e.build_mingraph_unet(jcfg, dtype=jnp.float32)
    args = (jax.random.key(0), jnp.zeros((B, S, S, 3)))
    fast, default = _np_tree(fast_compile(jm.init, *args)(*args)), _np_tree(jax.jit(jm.init)(*args))
    assert jax.tree_util.tree_structure(fast) == jax.tree_util.tree_structure(default)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(fast),
                                                    jax.tree_util.tree_leaves(default)))

    variables = _start_variables(jm, jcfg)
    batches = _orchard_batches(46)
    x = jnp.asarray(batches[0][0], jnp.float32) / 255.0
    tx, _ = jax_common.make_optimizer(jcfg.training, steps_per_epoch=2)
    fn = jax_e2e.make_e2e_train_step(jm, tx, jcfg, augment=False)
    first = (jax_common.TrainState.create(variables, tx), jnp.asarray(batches[0][0]), jnp.asarray(batches[0][1]),
             jax.random.key(0))
    runs = {}
    with jax.default_matmul_precision("highest"):
        for name, compiled, apply in (("fast", fast_compile(fn, *first), fast_compile(jm.apply, variables, x)),
                                      ("default", jax.jit(fn), jax.jit(jm.apply))):
            state, terms = jax_common.TrainState.create(variables, tx), []
            for i, (imgs, masks) in enumerate(batches):
                state, aux = compiled(state, jnp.asarray(imgs), jnp.asarray(masks), jax.random.key(i))
                terms.append(_np_tree(aux))
            runs[name] = (_np_tree(apply(variables, x)), terms, state)
    (out_f, terms_f, state_f), (out_d, terms_d, state_d) = runs["fast"], runs["default"]
    for a, b in zip(jax.tree_util.tree_leaves(out_f), jax.tree_util.tree_leaves(out_d)):
        assert _rel_err(a, b) <= VAL_TOL
    for i, (got, ref) in enumerate(zip(terms_f, terms_d)):
        assert sorted(got) == sorted(ref), i
        for k in ref:
            assert _rel_err(got[k], ref[k]) <= VAL_TOL, (i, k)
    lr = jcfg.training.learning_rate
    start = variables_from_jax({"params": _np_tree(variables["params"])})
    got_p = variables_from_jax({"params": _np_tree(state_f.params)})
    ref_p = variables_from_jax({"params": _np_tree(state_d.params)})
    assert sorted(got_p) == sorted(ref_p)
    for n in ref_p:
        upd, upd_ref = got_p[n].numpy() - start[n].numpy(), ref_p[n].numpy() - start[n].numpy()
        diff = np.abs(upd - upd_ref).max()
        if _zero_in_exact_arithmetic(n):
            assert diff <= 3 * lr, n
        else:
            assert diff <= GRAD_TOL * np.abs(upd_ref).max() + 2 * np.spacing(np.abs(ref_p[n].numpy())).max(), n
    got_s = variables_from_jax({"batch_stats": _np_tree(state_f.batch_stats)})
    ref_s = variables_from_jax({"batch_stats": _np_tree(state_d.batch_stats)})
    assert sorted(got_s) == sorted(ref_s)
    for n, r in ref_s.items():
        assert _rel_err(got_s[n], r.numpy()) <= VAL_TOL, n


@pytest.mark.parametrize("case", sorted(E2E_CASES))
def test_three_e2e_train_steps_match_jax(case, no_dropout, decisions):
    kw = E2E_CASES[case]
    terms = three_e2e_steps_vs_jax(_small_cfg(True, **kw), _small_cfg(False, **kw), decisions)
    if kw.get("warmup"):
        for got in terms:
            assert float(got["total"]) == pytest.approx(
                float(got["l_unet_seg"] + got["l_bbox"] + got["l_conf"]), rel=1e-6)
