"""The model options of mingraph_unet_tpu_torch beyond the serving default,
against the JAX package on the CPU: the U-Net without BatchNorm (eval
forward, segmentation train steps), the rematerialized U-Net (train steps,
and its BN running statistics bit-equal to a plain step's), the Sobel
feature at kernel sizes 3, 5 and 7, the lattice's COO edge list and dense
adjacency, and the dense MinCut backend with the MLP segment predictor.

Tolerances as ``tests/test_torch_train.py``: values 2e-4 and gradients
1e-3 of max |ref| (PARITY.md M5); a conv bias that feeds a train-mode
BatchNorm has a zero gradient in exact arithmetic and is held to an
absolute bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingraph_unet_tpu.models import gat as jax_gat
from mingraph_unet_tpu.models import mincut as jax_mincut
from mingraph_unet_tpu.models import unet as jax_unet
from mingraph_unet_tpu.models.pipeline import MinGraphUNet as JaxMinGraphUNet
from mingraph_unet_tpu.ops import filters as jax_filters
from mingraph_unet_tpu.ops import lattice as jax_lattice
from mingraph_unet_tpu.train import common as jax_common
from mingraph_unet_tpu.train import segmentation as jax_seg
from mingraph_unet_tpu_torch.convert import load_jax_variables, variables_from_jax
from mingraph_unet_tpu_torch.models import gat as t_gat
from mingraph_unet_tpu_torch.models import mincut as t_mincut
from mingraph_unet_tpu_torch.models import unet as t_unet
from mingraph_unet_tpu_torch.models.pipeline import MinGraphUNet
from mingraph_unet_tpu_torch.ops import filters as t_filters
from mingraph_unet_tpu_torch.ops import lattice as t_lattice
from mingraph_unet_tpu_torch.train import common as t_common
from mingraph_unet_tpu_torch.train import segmentation as t_seg
from test_torch_e2e import fast_compile
from test_torch_train import _feeds_bn, _rel_err, _small_cfg, _t, _np_tree

VAL_TOL, GRAD_TOL = 2e-4, 1e-3


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# The U-Net without BatchNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth,shape", [(2, (2, 32, 32, 3)), (3, (1, 24, 40, 3))], ids=["depth2", "depth3"])
def test_bnless_unet_eval_matches_flax(depth, shape):
    """The BN-less U-Net's eval forward (the raw weights at every site: the
    s2d levels' windowed conv, K1's and K2's functions, the standard
    levels) against flax's, and its tree loads strictly (no bn leaves)."""
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    jm = jax_unet.UNet(init_features=8, depth=depth, use_batchnorm=False, s2d_level0=True, s2d_level1=True)
    v = fast_compile(jm.init, jax.random.key(1), jnp.asarray(x))(jax.random.key(1), jnp.asarray(x))
    assert "batch_stats" not in v
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(fast_compile(jm.apply, v, jnp.asarray(x))(v, jnp.asarray(x))[0])
    tm = load_jax_variables(t_unet.UNet(_gen(), init_features=8, depth=depth, use_batchnorm=False), _np_tree(v))
    assert not any(".bn" in k for k in tm.state_dict())
    assert t_unet.UNet(_gen(), init_features=8, depth=depth, use_batchnorm=False).s2d_levels(*shape[1:3])
    with torch.no_grad():
        out = tm.eval()(_t(x))
    assert _rel_err(out["logits"], ref) <= VAL_TOL
    # remat changes nothing in eval.
    rm = t_unet.UNet(_gen(), init_features=8, depth=depth, use_batchnorm=False, remat=True)
    rm.load_state_dict(tm.state_dict())
    with torch.no_grad():
        assert torch.equal(rm.eval()(_t(x))["logits"], out["logits"])


RELU_MARGIN = 2e-6
# Case → (U-Net options, data seed); each seed keeps every ReLU input of the
# case RELU_MARGIN clear of zero (the test checks it).
SEG_CASES = {"no_batchnorm": (dict(use_batchnorm=False), 4), "remat": (dict(remat=True), 13)}


@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_three_segmentation_steps_match_jax(case, monkeypatch):
    """Three ``make_train_step`` steps (Adam) against the JAX trainer's, as
    ``tests/test_torch_train.py::test_three_train_steps_match_jax``: the
    losses, the updates and the BN statistics, every ReLU input clear of
    its kink."""
    margins = []
    relu = torch.relu

    def relu_with_margin(x):
        a = x.detach().abs()
        margins.append(float(a.min() / a.max()))
        return relu(x)

    monkeypatch.setattr(torch, "relu", relu_with_margin)
    options, seed = SEG_CASES[case]
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (3, 2, 16, 16, 3)).astype(np.uint8)
    masks = rng.integers(0, 2, (3, 2, 16, 16)).astype(np.uint8)
    jcfg, cfg = _small_cfg(True), _small_cfg(False)
    for c in (jcfg, cfg):
        for k, val in options.items():
            setattr(c.model.unet, k, val)
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
    # 10 ReLUs a step at depth 2; remat runs each block's twice.
    assert len(margins) == 3 * 10 * (2 if case == "remat" else 1) and min(margins) >= RELU_MARGIN
    assert state.step == int(jstate.step) == 3
    ref = variables_from_jax({"params": _np_tree(jstate.params)})
    start = variables_from_jax({"params": _np_tree(variables["params"])})
    lr = cfg.training.learning_rate
    bn = cfg.model.unet.use_batchnorm
    for n, p in model.named_parameters():
        upd, upd_ref = p.detach().numpy() - start[n].numpy(), ref[n].numpy() - start[n].numpy()
        diff = np.abs(upd - upd_ref)
        tol = GRAD_TOL * np.abs(upd_ref).max() + 2 * np.spacing(np.abs(ref[n].numpy())).max()
        if bn and _feeds_bn(n):
            assert diff.max() <= 3 * lr, n  # a zero gradient's rounding noise, through Adam
        else:
            far = diff > tol  # Adam: an element with a rounding-level gradient moves by up to lr
            assert far.mean() <= 1e-3 and diff.max() <= 3 * lr, n
    ref_s = variables_from_jax({"batch_stats": _np_tree(jstate.batch_stats)}) if bn else {}
    bufs = dict(model.named_buffers())
    assert sorted(bufs) == sorted(ref_s)
    for n, b in bufs.items():
        r = ref_s[n].numpy()
        atol = 0.3 * lr if n.endswith(".mean") else 0.0
        assert np.abs(b.numpy() - r).max() <= VAL_TOL * np.abs(r).max() + atol, n


def _step_pair(kind):
    """The same train step (SGD, f32, CPU) on two models from the same
    weights, one plain and one rematerialized, each with its step."""
    from test_torch_e2e import _orchard_batches, _small_cfg as e2e_cfg
    from mingraph_unet_tpu_torch.train import end_to_end as t_e2e

    out = []
    for remat in (False, True):
        if kind == "seg":
            cfg = _small_cfg(False, "sgd")
            cfg.model.unet.remat = remat
            model = t_seg.build_unet(cfg, device="cpu")
            step = t_seg.make_train_step(cfg, augment=True)
            imgs, masks = _orchard_batches(3, steps=1)[0]
        else:
            cfg = e2e_cfg(False, optimizer="sgd")
            cfg.model.unet.remat = remat
            cfg.model.fusion_detection.use_dense_detection = True
            model = t_e2e.build_mingraph_unet(cfg, device="cpu")
            opt, sched = t_common.make_optimizer(model.parameters(), cfg.training, 1)
            step = t_e2e.make_e2e_train_step(model, opt, cfg, augment=True)
            imgs, masks = _orchard_batches(3, steps=1)[0]
        if out:
            model.load_state_dict(out[0][0].state_dict())
        if kind == "seg":
            opt, sched = t_common.make_optimizer(model.parameters(), cfg.training, 1)
        out.append((model, step, t_common.TrainState(model, opt, sched), imgs, masks))
    return out


@pytest.mark.parametrize("kind", ["seg", "e2e"])
def test_remat_step_equals_the_plain_step(kind, monkeypatch):
    """A remat train step recomputes every ConvBlock in the backward (each
    block's forward runs twice) and leaves the BN running statistics
    bit-equal to the plain step's (each updated once, in the forward); its
    loss terms are equal and its gradients and updated parameters agree to
    f32 rounding."""
    runs = {"_forward": 0, "_forward_s2d_train": 0}
    for name in runs:
        real = getattr(t_unet.ConvBlock, name)

        def spy(self, *args, _real=real, _name=name):
            runs[_name] += 1
            return _real(self, *args)

        monkeypatch.setattr(t_unet.ConvBlock, name, spy)
    results = []
    for model, step, state, imgs, masks in _step_pair(kind):
        before = dict(runs)
        aux = step(state, _t(imgs), _t(masks), _gen(4))
        results.append((model, aux, {k: runs[k] - before[k] for k in runs}))
    (plain, aux_p, n_p), (remat, aux_r, n_r) = results
    blocks = sum(isinstance(m, t_unet.ConvBlock) for m in plain.modules())
    assert sum(n_p.values()) == blocks and sum(n_r.values()) == 2 * blocks
    for k in aux_p:
        assert torch.equal(aux_p[k], aux_r[k]), k
    bufs_r = dict(remat.named_buffers())
    assert bufs_r
    for n, b in plain.named_buffers():
        assert torch.equal(b, bufs_r[n]), n
    params_r = dict(remat.named_parameters())
    top = max(float(p.grad.abs().max()) for p in plain.parameters())
    for n, p in plain.named_parameters():
        q = params_r[n]
        assert float((p.grad - q.grad).abs().max()) <= 1e-6 * top, n
        assert float((p - q).detach().abs().max()) <= 1e-6 * max(float(p.detach().abs().max()), 1.0), n


# ---------------------------------------------------------------------------
# The MinGraphUNet serving forward with the options
# ---------------------------------------------------------------------------

FWD_CASES = {"no_batchnorm": dict(use_batchnorm=False), "sobel5": dict(sobel_kernel_size=5),
             "sobel7": dict(sobel_kernel_size=7)}


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_serving_forward_with_options_matches_jax(case):
    """``MinGraphUNet`` eval on the pooled serving path (s2d levels 0 and 1)
    with a BN-less U-Net or a larger Sobel kernel, against JAX's, f32."""
    from test_torch_pipeline import _images

    kw = dict(init_features=8, depth=2, detection_pre_pool=4, **FWD_CASES[case])
    x = _images(6)
    jm = JaxMinGraphUNet(dtype=jnp.float32, unet_s2d_level1=True, **kw)
    v = fast_compile(jm.init, jax.random.key(7), jnp.asarray(x))(jax.random.key(7), jnp.asarray(x))
    with jax.default_matmul_precision("highest"):
        ref = fast_compile(jm.apply, v, jnp.asarray(x))(v, jnp.asarray(x))
    model = load_jax_variables(MinGraphUNet(device="cpu", **kw), _np_tree(v))
    out = model(_t(x))
    for k in ("logits", "patch_feats", "pred_bboxes", "pred_confidence", "l_partition", "gat_feats"):
        assert _rel_err(out[k], np.asarray(ref[k])) <= VAL_TOL, k


# ---------------------------------------------------------------------------
# Sobel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ksize", [3, 5, 7])
def test_sobel_matches_jax(ksize):
    """``sobel_kernels`` bit for bit; ``sobel_magnitude`` (batched and one
    HWC image) and ``sobel_patch_mean`` within 2e-4 of max |ref|."""
    kx, ky = t_filters.sobel_kernels(ksize)
    jkx, jky = jax_filters.sobel_kernels(ksize)
    np.testing.assert_array_equal(kx, jkx)
    np.testing.assert_array_equal(ky, jky)
    rgb = np.random.default_rng(ksize).uniform(0, 255, (2, 24, 40, 3)).astype(np.float32)
    rgb[1, :, :20] = 0.0  # a flat region
    ref = np.asarray(jax_filters.sobel_magnitude(jnp.asarray(rgb), ksize))
    assert _rel_err(t_filters.sobel_magnitude(_t(rgb), ksize), ref) <= VAL_TOL
    ref1 = np.asarray(jax_filters.sobel_magnitude(jnp.asarray(rgb[0].astype(np.uint8)), ksize))
    assert _rel_err(t_filters.sobel_magnitude(_t(rgb[0].astype(np.uint8)), ksize), ref1) <= VAL_TOL
    ref_p = np.asarray(jax_filters.sobel_patch_mean(jnp.asarray(rgb), 8, ksize))
    assert _rel_err(t_filters.sobel_patch_mean(_t(rgb), 8, ksize), ref_p) <= VAL_TOL


def test_sobel_refuses_even_sizes():
    for k in (1, 2, 4):
        with pytest.raises(ValueError, match="odd"):
            t_filters.sobel_kernels(k)
    with pytest.raises(ValueError, match="odd"):
        MinGraphUNet(device="cpu", init_features=4, depth=1, sobel_kernel_size=4)


# ---------------------------------------------------------------------------
# Lattice edge list, dense adjacency, the dense MinCut backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", [(1, 1), (1, 4), (3, 5)])
def test_lattice_edge_index_and_adjacency_match_jax(grid):
    ei = t_lattice.lattice_edge_index(*grid)
    ref = jax_lattice.lattice_edge_index(*grid)
    assert ei.dtype == np.int32
    np.testing.assert_array_equal(ei, ref)
    n = grid[0] * grid[1]
    dup = np.concatenate([ei, ei[:, :1]], axis=1) if ei.shape[1] else ei
    adj = t_gat.adjacency_from_edge_index(dup, n)
    np.testing.assert_array_equal(adj.numpy(), np.asarray(jax_gat.adjacency_from_edge_index(dup, n)))
    assert adj.dtype == torch.float32 and float(adj.sum()) == ei.shape[1]


def test_dense_ncut_matches_jax():
    """``edge_weights_dense`` and ``normalized_cut_loss_dense`` on a batch
    of graphs with a batched adjacency: values and the gradients in the
    features and the assignments."""
    rng = np.random.default_rng(21)
    f = rng.standard_normal((2, 9, 5)).astype(np.float32) * 0.5
    soft = rng.random((2, 9, 3)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    adj = (rng.random((2, 9, 9)) < 0.4).astype(np.float32)
    adj[1] = 0.0
    adj[1, 0, 1] = 1.0  # one edge: a segment with assoc 0 is left out
    w_ref = np.asarray(jax_mincut.edge_weights_dense(jnp.asarray(f), jnp.asarray(adj), 0.8))
    assert _rel_err(t_mincut.edge_weights_dense(_t(f), _t(adj), 0.8), w_ref) <= VAL_TOL

    def jloss(ff, ss):
        return jnp.sum(jax_mincut.normalized_cut_loss_dense(ff, jnp.asarray(adj), ss, 0.8) * jnp.asarray([1.0, 2.0]))

    with jax.default_matmul_precision("highest"):
        ref, (gf, gs) = jax.value_and_grad(jloss, (0, 1))(jnp.asarray(f), jnp.asarray(soft))
    ft, st = _t(f).requires_grad_(), _t(soft).requires_grad_()
    loss = (t_mincut.normalized_cut_loss_dense(ft, _t(adj), st, 0.8) * torch.tensor([1.0, 2.0])).sum()
    loss.backward()
    assert _rel_err(loss, np.asarray(ref)) <= VAL_TOL
    assert _rel_err(ft.grad, np.asarray(gf)) <= GRAD_TOL and _rel_err(st.grad, np.asarray(gs)) <= GRAD_TOL


def test_dense_and_lattice_losses_agree_on_the_lattice():
    """On the lattice's own adjacency the dense loss is the lattice loss."""
    rng = np.random.default_rng(11)
    feats = rng.random((2, 4, 5, 3)).astype(np.float32)
    soft = rng.random((2, 4, 5, 2)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    adj = t_gat.adjacency_from_edge_index(t_lattice.lattice_edge_index(4, 5), 20)
    lat = t_mincut.normalized_cut_loss_lattice(_t(feats), _t(soft))
    dense = t_mincut.normalized_cut_loss_dense(_t(feats).reshape(2, 20, 3), adj, _t(soft).reshape(2, 20, 2))
    torch.testing.assert_close(lat, dense, rtol=1e-5, atol=0)


@pytest.mark.parametrize("use_gnn", [False, True], ids=["mlp", "gat"])
def test_dense_mincut_refinement_matches_jax(use_gnn):
    """``MinCutRefinement(backend="dense")`` with the MLP predictor (hidden
    2·D) or a 2-head GAT, against flax: the loss, the assignments and the
    parameter gradients of ⟨soft, r⟩ + loss; without an adjacency it
    raises, as in JAX."""
    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, 6, 8)).astype(np.float32)
    adj = np.asarray(jax_gat.fully_connected_adjacency(6))
    r = rng.standard_normal((2, 6, 3)).astype(np.float32)
    kw = dict(num_segments=3, backend="dense", predictor_use_gnn=use_gnn, predictor_heads=2)
    jm = jax_mincut.MinCutRefinement(**kw)
    v = jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(adj))

    def jfn(params):
        loss, soft = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(adj))
        return jnp.sum(soft * r) + jnp.sum(loss), (loss, soft)

    with jax.default_matmul_precision("highest"):
        (_, (loss, soft)), grads = jax.value_and_grad(jfn, has_aux=True)(v["params"])
    tm = t_mincut.MinCutRefinement(8, 3, _gen(), predictor_heads=2, backend="dense", predictor_use_gnn=use_gnn)
    load_jax_variables(tm, _np_tree(v))
    assert ("segment_predictor.fc1.kernel" in tm.state_dict()) == (not use_gnn)
    if not use_gnn:
        assert tuple(tm.segment_predictor.fc1.kernel.shape) == (8, 16)
    t_loss, t_soft = tm(_t(x), _t(adj))
    ((t_soft * _t(r)).sum() + t_loss.sum()).backward()
    assert _rel_err(t_loss, np.asarray(loss)) <= VAL_TOL and _rel_err(t_soft, np.asarray(soft)) <= VAL_TOL
    ref_g = variables_from_jax({"params": _np_tree(grads)})
    for n, p in tm.named_parameters():
        assert _rel_err(p.grad, ref_g[n]) <= GRAD_TOL, n
    with pytest.raises(ValueError, match="adjacency"):
        tm(_t(x))


def test_lattice_mincut_with_the_mlp_predictor_matches_jax():
    x = np.random.default_rng(16).standard_normal((2, 3, 4, 8)).astype(np.float32)
    jm = jax_mincut.MinCutRefinement(num_segments=2, predictor_use_gnn=False, predictor_hidden=5)
    v = jm.init(jax.random.key(1), jnp.asarray(x))
    with jax.default_matmul_precision("highest"):
        loss, soft = jm.apply(v, jnp.asarray(x))
    tm = load_jax_variables(t_mincut.MinCutRefinement(8, 2, _gen(), predictor_hidden=5, predictor_use_gnn=False),
                            _np_tree(v))
    with torch.no_grad():
        t_loss, t_soft = tm(_t(x))
    assert _rel_err(t_loss, np.asarray(loss)) <= VAL_TOL and _rel_err(t_soft, np.asarray(soft)) <= VAL_TOL
