"""End-to-end MinGraph-UNet trainer. Counterpart of
``mingraph_unet_tpu/train/end_to_end.py``.

One train step: synced augmentation and normalization of the uint8 batch
on the device, ``MinGraphUNet`` in train mode (K4 at the U-Net's s2d
conv2s, hist-eq through K6, dropout from the step's generator), and

``L_total = CE + λ1·L_shape + λ2·L_feature + λ3·L_partition + λ4·L_smooth
[+ λ5·L_partition_sup] + L_bbox + L_conf [+ L_dense_obj + L_dense_box]``

with the JAX trainer's terms: L_feature between the pooled-decoder
projection and the GAT patch features with patch labels ``y_p`` from the
ground-truth mask (foreground fraction > 0.5); L_shape per predicted
instance (connected components of the thresholded foreground probability,
no gradient through the instancing); L_smooth the TV of the foreground
probability; the detection head against the mask's union box; with the
dense head (``use_dense_detection``, whether or not detection is trained, as
in JAX) ``models/detection.py::dense_detection_loss`` against ground-truth
instances cut from the augmented mask by connected components, without
gradient (``instancing="fast"``: the stencil CC and the dense top-K;
``"exact"``: hook-and-jump CC and the exact top-K; ``max_instances`` slots,
10 pixels at least). A term whose weight is 0 is left out.

With COCO instance annotations (``dataset.annotations_file``: the batches
carry (B, O, H, W) instance masks, augmented with their images) L_shape is
the ellipse prior on the augmented ground-truth instances and the dense
head trains against them: the step then runs no connected components at
all. ``loss_balance="uncertainty"`` replaces each
active graph term by ``exp(−s)·λ·L + s/2`` with a learnable ``s`` in the
model's ``loss_balance.log_vars`` (the flax tree's
``params/loss_balance/log_vars``), trained by the same optimizer.

The trainer adds the two-phase schedule (``graph_warmup_epochs`` epochs with
the graph terms' weights at 0, then all of them), step-indexed checkpoints
with exact resume and JSONL metrics, as ``train/segmentation.py``. Entry
points run on the CUDA card unless ``device="cpu"`` is passed.

Data parallelism as in ``train/segmentation.py``: each rank takes its rows
of the global batch and the step is the global batch's. BN (the U-Net's
and the head's) takes the global statistics; L_shape divides by the valid
objects of all ranks, L_bbox by their positive images; the balancer sees
the global terms and counts its ``s/2`` once; the augmentation and the
dropout masks are drawn for the whole batch (``parallel/data.py``).

Spatial parallelism (``spatial_parallel`` > 1) as in
``train/segmentation.py``: only the U-Net runs H-sharded
(``parallel/spatial.py::spatial_sharded_unet``, BN over batch × spatial);
its logits and level 0's skip and ``f_u[0]`` (in the s2d form the
one-process step pools from) are gathered over the spatial group, and
everything after them (hist-eq, Sobel, the graph branch, fusion, both
heads, instancing, every loss) runs on the whole images, alike on every
rank of the group, its BN over the batch group only. Each rank
backpropagates 1/S of its total; the gradients are summed over every rank.
The gathered full-resolution tensors and the heads are held whole on every
spatial rank; so are the instance masks, as the masks are.

While a profiler records, the step's phases are the ranges
``mgu.train.e2e.{augment,forward,loss,backward,optimizer}`` and each loss
term's work is ``mgu.loss.<term>`` (``seg``: CE and the class
probabilities; ``feature``, ``partition``, ``shape`` with the instancing's
``mgu.cc.*``, ``smooth``, ``detection``; ``utils/profiling.py::span``).

Every model the config builds trains: the dense head, class scores (no
loss reaches them, as in JAX: the class branch moves by weight decay
alone), each ablation switch, the U-Net without BatchNorm or
rematerialized, any odd Sobel size, on COCO instance annotations or on
masks alone.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from mingraph_unet_tpu_torch.config import PipelineConfig
from mingraph_unet_tpu_torch.data.dataset import BatchLoader, MangoDataset, device_preprocess_batch
from mingraph_unet_tpu_torch.device import resolve_device
from mingraph_unet_tpu_torch.models import losses
from mingraph_unet_tpu_torch.models.detection import dense_detection_loss
from mingraph_unet_tpu_torch.models.pipeline import MinGraphUNet
from mingraph_unet_tpu_torch.ops import cc
from mingraph_unet_tpu_torch.ops.patches import patch_reduce_mean
from mingraph_unet_tpu_torch.parallel.data import (all_reduce_gradients, all_reduce_metrics, batch_mean,
                                                   data_parallel, replicated, spatial_share)
from mingraph_unet_tpu_torch.parallel.mesh import Mesh, replicate
from mingraph_unet_tpu_torch.parallel.spatial import spatial_sharded_unet
from mingraph_unet_tpu_torch.train.common import (TrainState, draw_step_augment, make_multistep, make_optimizer,
                                                  run_epochs, spatial_step, trainer_mesh)
from mingraph_unet_tpu_torch.utils.profiling import span

__all__ = ["BALANCED_LOSSES", "LossBalance", "build_mingraph_unet", "gt_union_box", "make_e2e_train_step",
           "mingraph_unet_kwargs", "train_end_to_end"]

Device = Optional[Union[str, torch.device]]

# Slot order of the uncertainty balancer's log-variances.
BALANCED_LOSSES = ("l_shape", "l_feature", "l_partition", "l_smooth", "l_partition_sup")


class LossBalance(nn.Module):
    """The uncertainty balancer's learnable log-variances, one per
    :data:`BALANCED_LOSSES` slot, starting at 0."""

    def __init__(self):
        super().__init__()
        self.log_vars = nn.Parameter(torch.zeros(len(BALANCED_LOSSES)))


def mingraph_unet_kwargs(cfg: PipelineConfig) -> Dict[str, Any]:
    """The ``MinGraphUNet`` arguments that ``cfg`` sets, all but the dtype
    and the device."""
    m = cfg.model
    return dict(
        num_classes=m.unet.out_channels,
        init_features=m.unet.init_features,
        depth=m.unet.depth,
        use_batchnorm=m.unet.use_batchnorm,
        remat=m.unet.remat,
        patch_size=m.graph_construction.patch_size,
        unet_patch_feature_dim=m.graph_construction.unet_patch_feature_dim,
        sobel_kernel_size=cfg.preprocessing.sobel_kernel_size,
        normalization_mean=cfg.preprocessing.normalization_mean,
        normalization_std=cfg.preprocessing.normalization_std,
        gat_hidden_dim=m.gat.hidden_dim,
        gat_output_dim=m.gat.output_dim,
        gat_num_heads=m.gat.num_heads,
        gat_num_layers=m.gat.num_layers,
        gat_dropout=m.gat.dropout,
        gat_alpha=m.gat.alpha,
        num_segments=cfg.dataset.num_semantic_regions,
        sigma_ncut=m.mincut.sigma_ncut,
        fc_hidden_dim=m.fusion_detection.fc_hidden_dim,
        detection_pre_pool=m.fusion_detection.detection_pre_pool,
        num_detection_classes=cfg.dataset.num_detection_classes,
        use_dense_detection=m.fusion_detection.use_dense_detection,
        use_patch_gat=m.ablation.use_patch_gat,
        use_partition=m.ablation.use_partition,
        use_region_gat=m.ablation.use_region_gat,
        use_fusion=m.ablation.use_fusion,
        in_channels=m.unet.in_channels,
        seed=cfg.training.seed,
    )


def build_mingraph_unet(cfg: PipelineConfig, device: Device = None) -> MinGraphUNet:
    """The ``MinGraphUNet`` of ``cfg`` in train mode, weights drawn from
    ``cfg.training.seed``, compute dtype bf16 when ``cfg.training.bf16``
    (parameters stay f32); with ``loss_balance: uncertainty`` it carries a
    :class:`LossBalance` as ``model.loss_balance``, which the forward does
    not use."""
    dtype = torch.bfloat16 if cfg.training.bf16 else torch.float32
    model = MinGraphUNet(**mingraph_unet_kwargs(cfg), dtype=dtype, device=device)
    if cfg.training.loss_balance == "uncertainty":
        model.loss_balance = LossBalance().to(model.device)
    return model.train()


@torch.no_grad()
def gt_union_box(masks: torch.Tensor, foreground_class: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per image the normalized union box (cx, cy, w, h) of the foreground
    pixels of ``masks`` (B, H, W), zeros without foreground, and the
    has-object flag."""
    b, h, w = masks.shape
    fg = masks == foreground_class
    x_min, y_min, x_max, y_max = cc.instance_boxes(fg).unbind(-1)
    has = fg.any(dim=2).any(dim=1)
    box = torch.stack([(x_min + x_max + 1.0) / 2.0 / w, (y_min + y_max + 1.0) / 2.0 / h,
                       (x_max - x_min + 1.0) / w, (y_max - y_min + 1.0) / h], dim=-1)
    return torch.where(has[:, None], box, torch.zeros_like(box)), has


@torch.no_grad()
def _gt_instances(masks: torch.Tensor, max_instances: int, exact: bool) -> torch.Tensor:
    """The dense head's ground truth without annotations: the ``max_instances``
    largest connected components (10 pixels at least) of each mask's
    foreground, as (B, O, H, W) f32 masks."""
    fg = (masks == 1).to(torch.int32)
    if exact:
        inst, _ = cc.top_instances(cc.label_components(fg), max_instances, min_area=10)
    else:
        inst, _ = cc.top_instances_dense(cc.label_components_stencil(fg), max_instances, min_area=10)
    return inst


def make_e2e_train_step(model: MinGraphUNet, opt: torch.optim.Optimizer, cfg: PipelineConfig,
                        augment: bool = True, train_detection: bool = True, mesh: Optional[Mesh] = None
                        ) -> Callable:
    """``train_step(state, images_u8 (B, H, W, 3), masks (B, H, W), gen,
    instances=None)`` takes one optimizer step on ``model`` with ``opt``, which ``state``
    (a ``TrainState``, for the schedule and the step count) must hold, and
    returns the step's terms as device scalars: ``total``, ``l_unet_seg``,
    ``l_shape``, ``l_feature``, ``l_partition``, ``l_smooth``, and where
    they apply ``l_partition_sup``, ``bal_s_<term>`` (the log-variance the
    step used), ``l_bbox``, ``l_conf``, ``l_dense_obj`` and
    ``l_dense_box``. ``gen``, a ``torch.Generator``
    on the model's device, draws the augmentation and the dropout masks.
    ``instances`` (B, O, H, W), annotated ground-truth instance masks, are
    L_shape's objects and the dense head's ground truth (no connected
    components).
    With a ``mesh`` that has process groups, the images are this rank's
    rows of the global batch (the same rows on every rank of a spatial
    group, whose U-Net then runs H-sharded) and the step and its terms are
    the global batch's; ``gen`` must be seeded alike on every rank."""
    pre = cfg.preprocessing
    lw = cfg.model.losses
    patch = cfg.model.graph_construction.patch_size
    max_instances = cfg.model.fusion_detection.max_instances
    exact_instancing = cfg.training.instancing == "exact"
    balance = cfg.training.loss_balance == "uncertainty"
    if balance and not isinstance(getattr(model, "loss_balance", None), LossBalance):
        raise ValueError("loss_balance 'uncertainty' needs the model's LossBalance (build_mingraph_unet adds it)")
    spatial = spatial_step(mesh)

    def loss_terms(out: Dict[str, Any], aug_masks: torch.Tensor, aug_inst: Optional[torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The step's terms (``aux``) and ``L_total``, each term in its own
        range ``mgu.loss.<term>``."""
        logits = out["logits"]
        b = logits.shape[0]
        with span("loss.seg"):
            l_seg = losses.cross_entropy_loss(logits, aug_masks)
            probs = torch.softmax(logits, dim=-1)  # L_shape's and L_smooth's foreground map
        with span("loss.feature"):
            # y_p from the ground truth: foreground fraction per patch > 0.5.
            with torch.no_grad():
                fg_frac = patch_reduce_mean((aug_masks == 1).float()[..., None], patch)[..., 0]
                y_p = (fg_frac > 0.5).float()
            n_patches = y_p.shape[1] * y_p.shape[2]
            l_feature = losses.feature_consistency_loss(
                out["f_unet_patches"].reshape(b, n_patches, -1), out["gat_feats"].reshape(b, n_patches, -1),
                y_p.reshape(b, n_patches), margin=lw.feature_loss_margin)
        with span("loss.partition"):
            l_partition = batch_mean(out["l_partition"])
        with span("loss.shape"):
            if aug_inst is not None:  # the ellipse prior on the annotated instances: no gradient into the model
                l_shape = losses.elliptical_shape_loss(aug_inst.float())
            else:
                l_shape = losses.elliptical_shape_loss_soft_instances(probs, max_instances=max_instances,
                                                                      exact=exact_instancing)
        with span("loss.smooth"):
            l_smooth = losses.total_variation_loss(probs[..., 1:2])

        aux = {"l_unet_seg": l_seg, "l_shape": l_shape, "l_feature": l_feature, "l_partition": l_partition,
               "l_smooth": l_smooth}
        graph_terms = [("l_shape", l_shape, lw.l_shape_weight), ("l_feature", l_feature, lw.l_feature_weight),
                       ("l_partition", l_partition, lw.l_partition_weight),
                       ("l_smooth", l_smooth, lw.l_smooth_weight)]
        if lw.l_partition_sup_weight > 0.0:
            with span("loss.partition"):
                l_psup = losses.partition_supervision_loss(out["soft_assignments"], y_p)  # f32 (f64) already
            aux["l_partition_sup"] = l_psup
            graph_terms.append(("l_partition_sup", l_psup, lw.l_partition_sup_weight))
        total = l_seg
        for name, val, wt in graph_terms:
            if wt == 0.0:
                continue
            if balance:
                s = model.loss_balance.log_vars[BALANCED_LOSSES.index(name)]
                total = total + torch.exp(-s) * wt * val + replicated(0.5 * s)
                aux[f"bal_s_{name}"] = s.detach().clone()  # before the update
            else:
                total = total + wt * val
        if train_detection:
            with span("loss.detection"):
                gt_box, has_obj = gt_union_box(aug_masks)
                l_bbox, l_conf = losses.detection_losses(out["pred_bboxes"], out["pred_confidence"], gt_box,
                                                         has_obj)
            total = total + l_bbox + l_conf
            aux["l_bbox"], aux["l_conf"] = l_bbox, l_conf
        if "dense_objectness_logits" in out:
            with span("loss.detection"):
                gt = aug_inst if aug_inst is not None else _gt_instances(aug_masks, max_instances, exact_instancing)
                l_dense_obj, l_dense_box = dense_detection_loss(
                    {"objectness_logits": out["dense_objectness_logits"], "boxes": out["dense_boxes"]}, gt, patch)
            total = total + l_dense_obj + l_dense_box
            aux["l_dense_obj"], aux["l_dense_box"] = l_dense_obj, l_dense_box
        aux["total"] = total
        return aux, total

    def train_step(state: TrainState, images_u8: torch.Tensor, masks: torch.Tensor, gen: torch.Generator,
                   instances: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        if state.model is not model or state.optimizer is not opt:
            raise ValueError("state must hold the model and optimizer this step was made for")
        dev = model.device
        images_u8, masks = images_u8.to(dev), masks.to(dev).long()
        if instances is not None:
            instances = instances.to(dev)
        b, h, w = masks.shape
        with data_parallel(mesh, b):
            with span("train.e2e.augment"):
                draw = draw_step_augment(gen, b, h, w, pre) if augment else None
                imgs, aug_masks, *aug_inst = device_preprocess_batch(
                    images_u8, masks, pre.normalization_mean, pre.normalization_std, draw,
                    num_classes=cfg.dataset.num_classes, instances=instances)
                aug_inst = aug_inst[0] if aug_inst else None
            with span("train.e2e.forward"):
                model.train()
                u = spatial_sharded_unet(model.unet, imgs, mesh, level0=True) if spatial else None
                out = model(imgs, gen=gen, unet_outputs=u)
            with span("train.e2e.loss"):
                aux, total = loss_terms(out, aug_masks, aug_inst)
            share = spatial_share(total)

        with span("train.e2e.backward"):
            opt.zero_grad(set_to_none=True)
            share.backward()
            # A parameter the total does not reach (the MinCut predictor while
            # the graph terms are off) has a zero gradient in JAX, which the
            # optimizer still applies (weight decay moves it): the same here.
            for p in model.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            all_reduce_gradients(model.parameters(), mesh)
        with span("train.e2e.optimizer"):
            state.apply_gradients()
        aux = {k: v.detach() for k, v in aux.items()}
        return all_reduce_metrics(aux, mesh, keys=[k for k in aux if not k.startswith("bal_s_")])

    return train_step


def _warmup_cfg(cfg: PipelineConfig) -> PipelineConfig:
    """``cfg`` with every graph term's weight at 0 (the warm-up phase)."""
    zero = dict(l_shape_weight=0.0, l_feature_weight=0.0, l_partition_weight=0.0, l_smooth_weight=0.0,
                l_partition_sup_weight=0.0)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, losses=dataclasses.replace(cfg.model.losses, **zero)))


def train_end_to_end(
    config_dir: str,
    max_epochs: Optional[int] = None,
    max_steps_per_epoch: Optional[int] = None,
    data_root_override: Optional[str] = None,
    train_detection: bool = True,
    device: Device = None,
) -> Tuple[TrainState, Dict[str, Any]]:
    """Train from a config directory; resumes from the newest checkpoint
    when ``training.resume`` is set. A relative ``annotations_file`` that
    does not exist as given is looked up in the train split's directory. Returns the state and
    ``{"epoch_loss": [...]}`` (the mean total per epoch run)."""
    cfg = PipelineConfig.from_config_dir(config_dir)
    train_cfg = cfg.training
    mesh = trainer_mesh(train_cfg)
    dev = resolve_device(device)
    ds_cfg = cfg.dataset
    data_root = data_root_override or ds_cfg.data_root
    model = replicate(build_mingraph_unet(cfg, dev), mesh)
    ann_file = ds_cfg.annotations_file
    if ann_file and not os.path.isabs(ann_file) and not os.path.exists(ann_file):
        ann_file = os.path.join(data_root, ds_cfg.train_dir, ann_file)
    dataset = MangoDataset(
        image_dir=os.path.join(data_root, ds_cfg.train_dir, ds_cfg.image_folder),
        mask_dir=os.path.join(data_root, ds_cfg.train_dir, ds_cfg.mask_folder),
        image_size=cfg.preprocessing.resize_dim,
        num_classes=cfg.model.unet.out_channels,
        annotations_file=ann_file,
        max_instances=cfg.model.fusion_detection.max_instances,
    )
    loader = BatchLoader(dataset, train_cfg.batch_size, shuffle=True, drop_last=True, seed=train_cfg.seed,
                         shard=(mesh.batch_index, mesh.batch_size))
    steps_per_epoch = max(1, len(loader))
    if max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)

    optimizer, scheduler = make_optimizer(model.parameters(), train_cfg, steps_per_epoch)
    state = TrainState(model, optimizer, scheduler)
    gen = torch.Generator(device=dev).manual_seed(train_cfg.seed)
    window = max(1, train_cfg.scan_window)
    phases: Dict[str, Tuple[Callable, Callable]] = {}

    def steps_for_epoch(epoch: int) -> Tuple[Callable, Callable]:
        """The warm-up phase's step (graph terms off) for the first
        ``graph_warmup_epochs`` epochs, then the joint one; the model and
        the optimizer state are the same across phases."""
        phase = "warmup" if epoch < train_cfg.graph_warmup_epochs else "joint"
        if phase not in phases:
            step = make_e2e_train_step(model, optimizer, _warmup_cfg(cfg) if phase == "warmup" else cfg,
                                       augment=True, train_detection=train_detection, mesh=mesh)
            phases[phase] = (step, make_multistep(step, window))
        return phases[phase]

    history = run_epochs(state, gen, loader, train_cfg, steps_per_epoch, steps_for_epoch, loss_key="total",
                         name="train_end_to_end", max_epochs=max_epochs)
    return state, history
