"""Every end-to-end model configuration the JAX trainer trains, trained by
the port's ``make_e2e_train_step`` against it on the CPU: the dense
detection head (its loss on connected-component ground truth, fast and
exact instancing, with and without the single-box head trained), class
scores, each ablation variant of ``experiments/ablation_study.py``,
``use_fusion=False``, the U-Net without BatchNorm or rematerialized, and
the 5×5 Sobel feature.

Each case is three steps of ``tests/test_torch_e2e.py``'s small
configuration from the same start (``three_e2e_steps_vs_jax``: every term
at 2e-4, the updates at 1e-3 of their largest value, dropout the identity
on both sides, every discrete decision clear of its kink).
"""

import re

import jax
import numpy as np
import pytest
import torch

from mingraph_unet_tpu.experiments.ablation_study import VARIANT_TOGGLES
from mingraph_unet_tpu_torch.models import detection as t_det
from mingraph_unet_tpu_torch.train import common as t_common
from mingraph_unet_tpu_torch.train import end_to_end as t_e2e
from test_torch_e2e import (_orchard_batches, _small_cfg, _start_variables, _t,  # noqa: F401
                            _zero_in_exact_arithmetic, decisions, no_dropout, three_e2e_steps_vs_jax)


def _set(section, **kw):
    """A config change: ``kw`` set on the config section at ``section``."""
    def change(cfg):
        obj = cfg
        for name in section.split("."):
            obj = getattr(obj, name)
        for k, v in kw.items():
            setattr(obj, k, v)
    return change


DENSE = _set("model.fusion_detection", use_dense_detection=True)
# Case → (config changes, train_detection).
CASES = {
    "dense_fast": ([DENSE], True),
    "dense_exact": ([DENSE, _set("training", instancing="exact")], True),
    "dense_no_box_head": ([DENSE], False),
    "class_scores": ([_set("dataset", num_detection_classes=2)], True),
    "no_fusion": ([_set("model.ablation", use_fusion=False)], True),
    "no_batchnorm": ([_set("model.unet", use_batchnorm=False)], True),
    "remat": ([_set("model.unet", remat=True)], True),
    "sobel5": ([_set("preprocessing", sobel_kernel_size=5)], True),
    # No partition: L_partition 0, L_partition_sup against the constant
    # one-hot assignments, the balancer's slots unchanged.
    "no_partition_psup_balanced": ([_set("model.ablation", use_partition=False, use_region_gat=False),
                                    _set("model.losses", l_partition_sup_weight=0.5),
                                    _set("training", loss_balance="uncertainty")], True),
}
# The batch seed of a case whose decisions seed 34 does not keep clear of
# their kinks (the test checks every decision's margin).
SEEDS = {"dense_fast": 82, "dense_exact": 82, "dense_no_box_head": 125, "sobel5": 36}
CASES.update({f"ablation_{v}": ([_set("model.ablation", **t)], True) for v, t in VARIANT_TOGGLES.items()
              if v != "combined"})


def _biased_unet(jm, jcfg):
    """``_start_variables`` with the U-Net's conv biases drawn away from 0
    (±0.02 to ±0.1): without BatchNorm a conv whose inputs are all zero
    would otherwise put an exact 0 before its ReLU."""
    variables = _start_variables(jm, jcfg)
    rng = np.random.default_rng(8)

    def bias(path, leaf):
        keys = [str(getattr(k, "key", "")) for k in path]
        if keys[:2] == ["params", "unet"] and keys[-1] == "bias" and re.match(r"conv[12]$", keys[-2]):
            return np.asarray(rng.choice([-1.0, 1.0], leaf.shape) * rng.uniform(0.02, 0.1, leaf.shape),
                              np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(bias, variables)


def _cfgs(case):
    """Both sides' configs of ``case``, with SGD: its update is linear in
    the gradient, so every leaf is held at the gradient tolerance (Adam,
    which turns rounding-level gradients into updates of up to lr, is held
    by ``tests/test_torch_e2e.py``)."""
    changes, _ = CASES[case]
    cfgs = _small_cfg(True, optimizer="sgd"), _small_cfg(False, optimizer="sgd")
    for cfg in cfgs:
        for change in changes:
            change(cfg)
    return cfgs


def _zero_exact(cfg):
    """The leaves whose gradient is zero in exact arithmetic: without
    BatchNorm the U-Net's conv biases are not among them."""
    if cfg.model.unet.use_batchnorm:
        return _zero_in_exact_arithmetic
    return lambda n: _zero_in_exact_arithmetic(n) and not re.match(r"unet\.", n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_e2e_steps_match_jax(case, no_dropout, decisions):
    jcfg, cfg = _cfgs(case)
    bn = cfg.model.unet.use_batchnorm
    terms = three_e2e_steps_vs_jax(jcfg, cfg, decisions, train_detection=CASES[case][1], zero_exact=_zero_exact(cfg),
                                   batch_seed=SEEDS.get(case, 34), start=_start_variables if bn else _biased_unet)
    dense = cfg.model.fusion_detection.use_dense_detection
    for got in terms:
        assert ("l_dense_obj" in got) == ("l_dense_box" in got) == dense
        assert ("l_bbox" in got) == CASES[case][1]
        if dense:
            assert float(got["l_dense_obj"]) > 0.0 and float(got["l_dense_box"]) > 0.0
        if not cfg.model.ablation.use_partition:
            assert float(got["l_partition"]) == 0.0


@pytest.mark.parametrize("exact", [False, True], ids=["fast", "exact"])
def test_dense_ground_truth_is_the_masks_components(exact):
    """The dense loss's ground truth: one instance per 4-connected
    component of at least 10 pixels, the largest first, under either
    instancing."""
    masks = torch.zeros((2, 32, 32), dtype=torch.long)
    masks[0, 2:8, 2:8] = 1       # 36 pixels
    masks[0, 20:23, 20:23] = 1   # 9 pixels: too small
    masks[0, 12:14, 0:30] = 1    # 60 pixels
    masks[1, 5:10, 25:32] = 1    # 35 pixels, at the border
    inst = t_e2e._gt_instances(masks, 16, exact)
    assert inst.shape == (2, 16, 32, 32) and inst.dtype == torch.float32
    areas = inst.sum((-2, -1))
    assert areas[0, :3].tolist() == [60.0, 36.0, 0.0] and areas[1, :2].tolist() == [35.0, 0.0]
    assert torch.equal(inst[0, 0].bool(), masks[0].bool() & (torch.arange(32)[:, None] >= 12)
                       & (torch.arange(32)[:, None] < 14))


def test_dense_loss_in_one_process_is_the_local_loss(monkeypatch):
    """Outside ``data_parallel``, ``dense_detection_loss`` (the BCE through
    ``batch_mean``, the L1 over ``global_count`` instances) is the local
    loss bit for bit: the BCE's mean over every cell, the L1 over the
    batch's instances."""
    g = torch.Generator().manual_seed(3)
    logits, boxes = torch.randn((2, 4, 4), generator=g), torch.rand((2, 4, 4, 4), generator=g)
    inst = t_e2e._gt_instances(torch.from_numpy(_orchard_batches(5, steps=1)[0][1]).long(), 8, False)
    out = {"objectness_logits": logits, "boxes": boxes}
    got = t_det.dense_detection_loss(out, inst, 8)
    monkeypatch.setattr(t_det, "batch_mean", lambda x: x.mean())
    monkeypatch.setattr(t_det, "global_count", lambda n: n)
    local = t_det.dense_detection_loss(out, inst, 8)
    assert inst.sum() > 0 and float(got[1]) > 0.0
    assert torch.equal(got[0], local[0]) and torch.equal(got[1], local[1])


def test_class_scores_train_by_weight_decay_only():
    """No loss reaches the class branch (as in JAX): its gradient is zero
    and a step moves it by the optimizer's weight decay alone."""
    cfg = _small_cfg(False)
    cfg.dataset.num_detection_classes = 2
    cfg.training.optimizer, cfg.training.weight_decay = "sgd", 0.1
    model = t_e2e.build_mingraph_unet(cfg, device="cpu")
    opt, sched = t_common.make_optimizer(model.parameters(), cfg.training, 1)
    step = t_e2e.make_e2e_train_step(model, opt, cfg, augment=False)
    names = [n for n, _ in model.named_parameters() if "class" in n]
    assert names
    before = {n: p.detach().clone() for n, p in model.named_parameters() if n in names}
    imgs, masks = _orchard_batches(1, steps=1)[0]
    aux = step(t_common.TrainState(model, opt, sched), _t(imgs), _t(masks), torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v)) for v in aux.values())
    for n, p in model.named_parameters():
        if n in names:
            assert not bool(p.grad.ne(0).any()), n
            assert not torch.equal(p.detach(), before[n]) or not bool(before[n].ne(0).any()), n
