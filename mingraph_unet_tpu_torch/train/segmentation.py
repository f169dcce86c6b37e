"""U-Net-only segmentation trainer. Counterpart of
``mingraph_unet_tpu/train/segmentation.py``.

One train step: synced augmentation and normalization of the uint8 batch
on the device (``data/dataset.py::device_preprocess_batch``), the U-Net in
train mode (its s2d conv2s through the K4 kernel on the card), CE +
``dice_weight``·soft-Dice, backward, Adam (or SGD) and the per-step StepLR.
The trainer adds step-indexed checkpoints with exact resume and JSONL
metrics. Entry points run on the CUDA card unless ``device="cpu"`` is
passed (under ``torchrun``, each rank on its current card).

Data parallelism: with ``torch.distributed`` initialized by the caller,
``data_parallel`` ranks (0: all of them) each take their rows of every
global batch of ``batch_size``; the step is the one-process step on the
global batch (augmentation drawn for the whole batch, BN statistics over
it, losses and gradients summed over the ranks, ``parallel/data.py``), the
parameters are broadcast from rank 0 at the start, and rank 0 alone writes
logs and checkpoints.

Spatial parallelism (``spatial_parallel`` > 1, data × spatial ranks): the
ranks of a spatial group hold the same batch rows, augment the whole
images alike, and each runs the U-Net on its H rows of them
(``parallel/spatial.py::spatial_sharded_unet``: every conv exchanges its
halo rows, K4 runs on the shard, BN sums over batch × spatial); the
gathered logits feed CE + Dice, computed alike on every rank of the group,
each rank backpropagating 1/S of its loss and the gradients summed over
every rank. H / spatial_parallel must be a multiple of 2^(depth + 1).
Sharded inference is ``parallel/spatial.py::spatial_sharded_apply``.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from mingraph_unet_tpu_torch.config import PipelineConfig
from mingraph_unet_tpu_torch.data.dataset import BatchLoader, MangoDataset, device_preprocess_batch
from mingraph_unet_tpu_torch.device import resolve_device
from mingraph_unet_tpu_torch.experiments.metrics import segmentation_metrics
from mingraph_unet_tpu_torch.models.losses import cross_entropy_loss, dice_loss
from mingraph_unet_tpu_torch.models.unet import UNet
from mingraph_unet_tpu_torch.parallel.data import (all_reduce_gradients, all_reduce_metrics, data_parallel,
                                                   spatial_share)
from mingraph_unet_tpu_torch.parallel.mesh import Mesh, replicate
from mingraph_unet_tpu_torch.parallel.spatial import spatial_sharded_unet
from mingraph_unet_tpu_torch.train.common import (TrainState, draw_step_augment, make_multistep, make_optimizer,
                                                  run_epochs, spatial_step, trainer_mesh)
from mingraph_unet_tpu_torch.utils.profiling import span

__all__ = ["build_unet", "make_train_step", "train_unet_segmentation", "evaluate_unet"]

Device = Optional[Union[str, torch.device]]


def build_unet(cfg: PipelineConfig, device: Device = None) -> UNet:
    """The U-Net of ``cfg.model.unet`` in train mode, weights drawn from
    ``cfg.training.seed``, compute dtype bf16 when ``cfg.training.bf16``
    (parameters stay f32), with or without BatchNorm and rematerialized as
    ``cfg.model.unet`` says. Its s2d levels follow from the input shape."""
    u = cfg.model.unet
    dev = resolve_device(device)
    dtype = torch.bfloat16 if cfg.training.bf16 else torch.float32
    gen = torch.Generator().manual_seed(cfg.training.seed)
    model = UNet(gen, u.in_channels, u.out_channels, u.init_features, u.depth, dtype, u.use_batchnorm, u.remat)
    return model.to(dev).train()


def make_train_step(cfg: PipelineConfig, augment: bool = True, mesh: Optional[Mesh] = None) -> Callable:
    """``train_step(state, images_u8 (B, H, W, 3), masks (B, H, W), gen)``
    takes one optimizer step on ``state`` and returns the step's
    ``{"loss", "ce", "dice"}`` as device tensors. ``gen`` is a
    ``torch.Generator`` on the model's device; augmentation draws from it.
    With a ``mesh`` that has process groups, the images are this rank's rows
    of the global batch (the same rows on every rank of a spatial group,
    whose U-Net then runs H-sharded) and the step is the global batch's
    (the returned values too); ``gen`` must be seeded alike on every
    rank."""
    pre = cfg.preprocessing
    dice_w = cfg.model.losses.dice_weight
    spatial = spatial_step(mesh)

    def train_step(state: TrainState, images_u8: torch.Tensor, masks: torch.Tensor,
                   gen: torch.Generator) -> Dict[str, torch.Tensor]:
        model = state.model
        dev = next(model.parameters()).device
        images_u8, masks = images_u8.to(dev), masks.to(dev).long()
        b, h, w = masks.shape
        with data_parallel(mesh, b):
            with span("train.augment"):
                draw = draw_step_augment(gen, b, h, w, pre) if augment else None
                imgs, masks = device_preprocess_batch(images_u8, masks, pre.normalization_mean,
                                                      pre.normalization_std, draw, num_classes=cfg.dataset.num_classes)
            with span("train.forward"):
                model.train()
                logits = (spatial_sharded_unet(model, imgs, mesh) if spatial else model(imgs))["logits"]
            with span("train.loss"):
                ce = cross_entropy_loss(logits, masks)
                dice = dice_loss(logits, masks)
                loss = ce + dice_w * dice
                share = spatial_share(loss)
        with span("train.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            share.backward()
            all_reduce_gradients(model.parameters(), mesh)
        with span("train.optimizer"):
            state.apply_gradients()
        return all_reduce_metrics({"loss": loss.detach(), "ce": ce.detach(), "dice": dice.detach()}, mesh)

    return train_step


def train_unet_segmentation(
    config_dir: str,
    max_epochs: Optional[int] = None,
    max_steps_per_epoch: Optional[int] = None,
    data_root_override: Optional[str] = None,
    device: Device = None,
) -> Tuple[TrainState, Dict[str, Any]]:
    """Train from a config directory; resumes from the newest checkpoint
    when ``training.resume`` is set. Returns the state and
    ``{"epoch_loss": [...]}`` of the epochs run."""
    cfg = PipelineConfig.from_config_dir(config_dir)
    train_cfg = cfg.training
    mesh = trainer_mesh(train_cfg)
    dev = resolve_device(device)
    ds_cfg = cfg.dataset
    data_root = data_root_override or ds_cfg.data_root
    dataset = MangoDataset(
        image_dir=os.path.join(data_root, ds_cfg.train_dir, ds_cfg.image_folder),
        mask_dir=os.path.join(data_root, ds_cfg.train_dir, ds_cfg.mask_folder),
        image_size=cfg.preprocessing.resize_dim,
        num_classes=cfg.model.unet.out_channels,
    )
    loader = BatchLoader(dataset, train_cfg.batch_size, shuffle=True, drop_last=True, seed=train_cfg.seed,
                         shard=(mesh.batch_index, mesh.batch_size))
    steps_per_epoch = max(1, len(loader))
    if max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)

    model = replicate(build_unet(cfg, dev), mesh)
    optimizer, scheduler = make_optimizer(model.parameters(), cfg.training, steps_per_epoch)
    state = TrainState(model, optimizer, scheduler)
    gen = torch.Generator(device=dev).manual_seed(train_cfg.seed)
    train_step = make_train_step(cfg, augment=True, mesh=mesh)
    steps = (train_step, make_multistep(train_step, max(1, train_cfg.scan_window)))
    history = run_epochs(state, gen, loader, train_cfg, steps_per_epoch, lambda epoch: steps, loss_key="loss",
                         name="train_segmentation", max_epochs=max_epochs)
    return state, history


@torch.no_grad()
def evaluate_unet(model: UNet, dataset: MangoDataset, cfg: PipelineConfig, batch_size: int = 8) -> Dict[str, Any]:
    """Predict over ``dataset`` in eval mode (the BN running statistics)
    and compute the reference-exact segmentation metrics; the model's mode
    is restored afterwards."""
    pre = cfg.preprocessing
    was_training = model.training
    model.eval()
    dev = next(model.parameters()).device
    trues, preds = [], []
    for imgs_np, masks_np in BatchLoader(dataset, batch_size, shuffle=False, drop_last=False).epoch(0):
        imgs_u8 = torch.from_numpy(imgs_np).to(dev)
        imgs, _ = device_preprocess_batch(imgs_u8, torch.zeros(imgs_u8.shape[:3], dtype=torch.long, device=dev),
                                          pre.normalization_mean, pre.normalization_std)
        preds.append(model(imgs)["logits"].argmax(-1).cpu().numpy().reshape(-1))
        trues.append(masks_np.reshape(-1))
    model.train(was_training)
    return segmentation_metrics(np.concatenate(trues), np.concatenate(preds), cfg.model.unet.out_channels)
