"""The end-to-end trainer's host side in mingraph_unet_tpu_torch:
``convert.py`` on a JAX end-to-end train state, what ``build_mingraph_unet``
refuses and follows from the config, the train step's guards, and
``train_end_to_end`` (warm-up phase, uncertainty balancer, resume,
multi-step windows) on a ``make_dummy_run`` dataset on the CPU. The small
configuration and data are ``test_torch_e2e.py``'s.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingraph_unet_tpu.train import common as jax_common
from mingraph_unet_tpu.train import end_to_end as jax_e2e
from mingraph_unet_tpu.utils.bootstrap import make_dummy_run
from mingraph_unet_tpu_torch.config import PipelineConfig
from mingraph_unet_tpu_torch.convert import load_jax_variables, variables_from_jax
from mingraph_unet_tpu_torch.train import common as t_common
from mingraph_unet_tpu_torch.train import end_to_end as t_e2e
from test_torch_e2e import B, S, _np_tree, _orchard_batches, _small_cfg, _t

def test_e2e_step_refuses_a_foreign_state():
    cfg = _small_cfg(False)
    model = t_e2e.build_mingraph_unet(cfg, device="cpu")
    opt, sched = t_common.make_optimizer(model.parameters(), cfg.training, 1)
    step = t_e2e.make_e2e_train_step(model, opt, cfg)
    other = t_common.TrainState(model, *t_common.make_optimizer(model.parameters(), cfg.training, 1))
    imgs, masks = _orchard_batches(1, steps=1)[0]
    with pytest.raises(ValueError, match="state must hold"):
        step(other, _t(imgs), _t(masks), torch.Generator())
    cfg.training.loss_balance = "uncertainty"
    with pytest.raises(ValueError, match="LossBalance"):
        t_e2e.make_e2e_train_step(model, opt, cfg)


# ---------------------------------------------------------------------------
# convert.py on a JAX end-to-end train state
# ---------------------------------------------------------------------------


def test_convert_loads_a_jax_e2e_train_state():
    jcfg, cfg = _small_cfg(True, balance="uncertainty"), _small_cfg(False, balance="uncertainty")
    jm = jax_e2e.build_mingraph_unet(jcfg, dtype=jnp.float32)
    tx, _ = jax_common.make_optimizer(jcfg.training, 1)
    variables = jax_e2e._augment_variables(jax.jit(jm.init)(jax.random.key(5), jnp.zeros((B, S, S, 3))),
                                           jcfg.training)
    jstate = jax_common.TrainState.create(variables, tx)
    tree = _np_tree({"params": jstate.params, "batch_stats": jstate.batch_stats})
    model = load_jax_variables(t_e2e.build_mingraph_unet(cfg, device="cpu"), tree)
    sd = model.state_dict()
    flat = variables_from_jax(tree)
    assert sorted(sd) == sorted(flat)
    assert {"loss_balance.log_vars", "detection_head.bn1.mean", "detection_head.bn2.var"} <= set(sd)
    for k, v in flat.items():
        assert torch.equal(sd[k], v), k
    with pytest.raises(ValueError, match="missing"):  # strict: a tree without the balancer
        load_jax_variables(model, _np_tree({"params": {k: v for k, v in jstate.params.items() if k != "loss_balance"},
                                            "batch_stats": jstate.batch_stats}))


# ---------------------------------------------------------------------------
# build_mingraph_unet and the trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("change,match", [
    (lambda c: setattr(c.dataset, "annotations_file", "ann.json"), "ROADMAP A5"),
])
def test_build_refuses_what_is_not_ported(change, match):
    """COCO instance annotations stop the build."""
    cfg = _small_cfg(False)
    change(cfg)
    with pytest.raises(NotImplementedError, match=match):
        t_e2e.build_mingraph_unet(cfg, device="cpu")


@pytest.mark.parametrize("change", [
    lambda c: setattr(c.model.fusion_detection, "use_dense_detection", True),
    lambda c: setattr(c.dataset, "num_detection_classes", 2),
    lambda c: setattr(c.model.ablation, "use_region_gat", False),
    lambda c: setattr(c.preprocessing, "sobel_kernel_size", 5),
], ids=["dense_head", "class_scores", "no_region_gat", "sobel5"])
def test_build_trains_what_it_once_refused(change):
    """The dense head, class scores, an ablation switch and the 5×5 Sobel
    build a model whose end-to-end step runs: one step, every term finite
    (``tests/test_torch_e2e_variants.py`` holds each against JAX)."""
    cfg = _small_cfg(False)
    change(cfg)
    model = t_e2e.build_mingraph_unet(cfg, device="cpu")
    opt, sched = t_common.make_optimizer(model.parameters(), cfg.training, 1)
    step = t_e2e.make_e2e_train_step(model, opt, cfg)
    imgs, masks = _orchard_batches(1, steps=1)[0]
    aux = step(t_common.TrainState(model, opt, sched), _t(imgs), _t(masks), torch.Generator().manual_seed(0))
    assert aux and all(bool(torch.isfinite(v)) for v in aux.values())
    assert ("l_dense_obj" in aux) == cfg.model.fusion_detection.use_dense_detection
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())


def test_build_follows_the_config():
    cfg = _small_cfg(False)
    cfg.training.bf16 = True
    model = t_e2e.build_mingraph_unet(cfg, device="cpu")
    assert model.training and model.dtype == torch.bfloat16 and not hasattr(model, "loss_balance")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.patch_gat.layer0.dropout_rate == cfg.model.gat.dropout
    assert model.mincut.segment_predictor.gnn_predictor.layer0.dropout_rate == cfg.model.gat.dropout


def _rewrite_yaml(path, **updates):
    import yaml

    data = yaml.safe_load(open(path))
    data.update(updates)
    yaml.safe_dump(data, open(path, "w"))
    return data


def test_trainer_warmup_balance_and_resume(tmp_path):
    """One warm-up epoch and one joint epoch with the uncertainty balancer,
    mirroring tests/test_training.py's warm-up and balance tests; then a
    resume, as its ``test_resume_with_balance``."""
    cfg_dir = make_dummy_run(str(tmp_path), num_images=4, image_size=(32, 32), batch_size=2, num_epochs=2,
                             patch_size=8, init_features=4, depth=2)
    tc = _rewrite_yaml(os.path.join(cfg_dir, "training.yaml"), graph_warmup_epochs=1, loss_balance="uncertainty",
                       log_interval=1, save_epoch_interval=1)
    state, history = t_e2e.train_end_to_end(cfg_dir, max_epochs=2, device="cpu")
    assert state.step == 4 and len(history["epoch_loss"]) == 2 and np.isfinite(history["epoch_loss"]).all()
    lw = PipelineConfig.from_config_dir(cfg_dir).model.losses
    (log_file,) = [f for f in os.listdir(tc["log_dir"]) if f.endswith(".jsonl")]
    rows = [json.loads(line) for line in open(os.path.join(tc["log_dir"], log_file))]
    assert [r["epoch"] for r in rows] == [0, 0, 1, 1]
    for row in rows:
        expect = row["l_unet_seg"] + row["l_bbox"] + row["l_conf"]
        if row["epoch"] == 1:
            for name, w in (("l_shape", lw.l_shape_weight), ("l_feature", lw.l_feature_weight),
                            ("l_partition", lw.l_partition_weight), ("l_smooth", lw.l_smooth_weight)):
                s = row[f"bal_s_{name}"]
                expect += np.exp(-s) * w * row[name] + 0.5 * s
        else:
            assert not any(k.startswith("bal_s_") for k in row)
        assert abs(row["total"] - expect) < 1e-4, row
    log_vars = state.model.loss_balance.log_vars.detach().numpy()
    assert np.abs(log_vars[:4]).min() > 0.0 and log_vars[4] == 0.0  # the inactive slot stays

    state2, history2 = t_e2e.train_end_to_end(cfg_dir, max_epochs=3, device="cpu")
    assert state2.step == 6 and len(history2["epoch_loss"]) == 1
    assert "loss_balance.log_vars" in state2.model.state_dict()


def test_trainer_refuses_multi_device(tmp_path):
    """Data and spatial parallelism need the caller's process group
    (without one the mesh has a single rank)."""
    cfg_dir = make_dummy_run(str(tmp_path), num_images=2, image_size=(16, 16), batch_size=2)
    _rewrite_yaml(os.path.join(cfg_dir, "training.yaml"), data_parallel=2)
    with pytest.raises(ValueError, match="needs 2 ranks, only 1 available"):
        t_e2e.train_end_to_end(cfg_dir, device="cpu")
    _rewrite_yaml(os.path.join(cfg_dir, "training.yaml"), data_parallel=1, spatial_parallel=2)
    with pytest.raises(ValueError, match="needs 2 ranks, only 1 available"):
        t_e2e.train_end_to_end(cfg_dir, device="cpu")


def test_trainer_scan_window_runs_the_steps_in_order(tmp_path):
    cfg_dir = make_dummy_run(str(tmp_path), num_images=6, image_size=(32, 32), batch_size=2, num_epochs=1,
                             patch_size=8, init_features=4, depth=2)
    _rewrite_yaml(os.path.join(cfg_dir, "training.yaml"), scan_window=2)
    state, history = t_e2e.train_end_to_end(cfg_dir, max_epochs=1, device="cpu")
    assert state.step == 3 and np.isfinite(history["epoch_loss"][0])
