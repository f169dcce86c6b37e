"""Shared trainer machinery: optimizer, learning-rate schedule, train state,
multi-step windows, the epoch loop. Counterpart of
``mingraph_unet_tpu/train/common.py``.

Optimizer semantics are the JAX package's (and the reference's):
- Adam with L2 ``weight_decay`` folded into the gradient, Adam over
  ``g + wd·p``: ``torch.optim.Adam(weight_decay=...)``, not AdamW.
- SGD with momentum and the same folded weight decay.
- StepLR, ``lr·γ^⌊step / (steps_per_epoch·lr_step_size)⌋``, stepped once
  per optimizer step (a staircase), so the k-th update uses the rate of
  step k as optax's schedule does.

Data and spatial parallelism (a mesh with process groups): the loader
gives each rank its rows of every global batch (the ranks of a spatial
group the same rows, whose H rows they then split in the U-Net), the steps
reduce as ``parallel/data.py`` sets out, and only global rank 0 writes logs
and checkpoints; on resume every rank reads the checkpoint.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from mingraph_unet_tpu_torch.config import PreprocessingConfig, TrainingConfig
from mingraph_unet_tpu_torch.data.dataset import BatchLoader
from mingraph_unet_tpu_torch.ops.image import AugmentDraw, draw_augment
from mingraph_unet_tpu_torch.parallel.data import global_batch, local_rows
from mingraph_unet_tpu_torch.parallel.mesh import Mesh, make_mesh
from mingraph_unet_tpu_torch.train.checkpoint import CheckpointManager
from mingraph_unet_tpu_torch.utils.logging import MetricsLogger

__all__ = ["TrainState", "draw_step_augment", "make_optimizer", "make_lr_schedule", "make_multistep",
           "run_epochs", "spatial_step", "trainer_mesh"]


@dataclass
class TrainState:
    """Everything a resume needs: the model (parameters and BN running
    statistics), the optimizer, the schedule and the number of steps
    taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients in ``.grad``, then the
        schedule's step."""
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1

    def state_dict(self) -> Dict[str, Any]:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "step": self.step,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])


def make_lr_schedule(
    optimizer: torch.optim.Optimizer, cfg: TrainingConfig, steps_per_epoch: int
) -> torch.optim.lr_scheduler.LambdaLR:
    """StepLR per step (``lr_scheduler: steplr``), else a constant rate."""
    if cfg.lr_scheduler and cfg.lr_scheduler.lower() == "steplr":
        period = max(1, steps_per_epoch * cfg.lr_step_size)
        gamma = cfg.lr_gamma
        return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: gamma ** (step // period))
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: 1.0)


def make_optimizer(
    params: Iterable[nn.Parameter], cfg: TrainingConfig, steps_per_epoch: int
) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    name = cfg.optimizer.lower()
    if name == "adam":
        opt = torch.optim.Adam(params, lr=cfg.learning_rate, weight_decay=cfg.weight_decay or 0.0)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=cfg.learning_rate, momentum=cfg.sgd_momentum or 0.0,
                              weight_decay=cfg.weight_decay or 0.0)
    else:
        raise ValueError(f"Optimizer {cfg.optimizer!r} not supported.")
    return opt, make_lr_schedule(opt, cfg, steps_per_epoch)


def trainer_mesh(cfg: TrainingConfig) -> Mesh:
    """The (data, spatial) mesh of ``cfg.data_parallel`` (0: every rank the
    spatial axis leaves) × ``cfg.spatial_parallel`` over the initialized
    process group, the trivial mesh without one (``make_mesh`` raises
    ``ValueError`` where the ranks do not match)."""
    return make_mesh(cfg.data_parallel, cfg.spatial_parallel)


def spatial_step(mesh: Optional[Mesh]) -> bool:
    """Whether a train step on ``mesh`` runs the U-Net H-sharded over its
    spatial axis. A spatial axis of more than one rank without process
    groups raises ``ValueError``: there is no one to exchange rows with,
    and the step never falls back to the unsharded U-Net."""
    if mesh is None or mesh.spatial_size == 1:
        return False
    if not mesh.distributed:
        raise ValueError(f"a spatial axis of {mesh.spatial_size} ranks needs the mesh's process groups "
                         "(make_mesh under an initialized torch.distributed)")
    return True


def draw_step_augment(gen: torch.Generator, b: int, h: int, w: int, pre: PreprocessingConfig) -> AugmentDraw:
    """A train step's augmentation parameters for its ``b`` images: drawn for
    the global batch (``b`` itself outside ``data_parallel``) and cut to
    this rank's rows, so every rank sees the one-process draws."""
    draw = draw_augment(gen, global_batch(b), h, w, pre.horizontal_flip_prob, pre.rotation_degrees,
                        pre.random_crop_prob)
    return AugmentDraw(*(local_rows(f) for f in draw))


def make_multistep(train_step: Callable, window: int) -> Callable:
    """``train_step(state, images, masks, gen) -> metrics`` becomes
    ``multistep(state, images (K, B, ...), masks (K, B, ...), gen)``: the K
    steps in order, returning each metric averaged over them."""

    def multistep(state: TrainState, images, masks, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        if len(images) != window or len(masks) != window:
            raise ValueError(f"multistep expects {window} batches, got {len(images)} and {len(masks)}")
        steps = [train_step(state, images[i], masks[i], gen) for i in range(window)]
        return {k: torch.stack([m[k] for m in steps]).mean() for k in steps[0]}

    return multistep


def run_epochs(
    state: TrainState,
    gen: torch.Generator,
    loader: BatchLoader,
    cfg: TrainingConfig,
    steps_per_epoch: int,
    steps_for_epoch: Callable[[int], Tuple[Callable, Callable]],
    loss_key: str,
    name: str,
    max_epochs: Optional[int] = None,
) -> Dict[str, Any]:
    """The trainers' host loop. Resumes ``state`` and ``gen`` from the newest
    checkpoint in ``cfg.checkpoint_dir`` when ``cfg.resume`` is set, then
    runs each epoch's steps (``steps_for_epoch(epoch) -> (train_step,
    multistep)``, the latter over ``cfg.scan_window`` batches at once),
    logs every metric to JSONL, prints the epoch's means and saves a
    checkpoint every ``save_epoch_interval`` epochs and after the last.
    Returns ``{"epoch_loss": [...]}``, the mean ``loss_key`` of each epoch
    run. Under ``torch.distributed`` only global rank 0 logs, prints and
    writes checkpoints (the steps' metrics are already global); every rank
    resumes from the checkpoint."""
    dev = next(state.model.parameters()).device
    ckpt = CheckpointManager(cfg.checkpoint_dir, max_to_keep=3, best_metric=cfg.checkpoint_best_metric,
                             best_mode=cfg.checkpoint_best_mode)
    start_epoch = 0
    if cfg.resume and ckpt.latest_step is not None:
        restored = ckpt.restore_latest(map_location=dev)
        state.load_state_dict(restored["state"])
        gen.set_state(restored["rng"])
        start_epoch = int(restored["epoch"]) + 1
        print(f"[{name}] resumed from step {state.step} (epoch {start_epoch})")

    window = max(1, cfg.scan_window)
    num_epochs = max_epochs if max_epochs is not None else cfg.num_epochs
    writer = not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
    logger = MetricsLogger(cfg.log_dir, name, cfg.log_interval) if writer else None
    history: Dict[str, Any] = {"epoch_loss": []}
    global_step = start_epoch * steps_per_epoch

    with torch.autograd.set_detect_anomaly(cfg.debug_nans):
        for epoch in range(start_epoch, num_epochs):
            train_step, multistep = steps_for_epoch(epoch)
            epoch_lr = state.optimizer.param_groups[0]["lr"]
            running: Dict[str, float] = {}
            n_steps = 0
            pending = []  # (metrics on the device, steps covered, global step)

            def drain(keep: int = 0) -> None:
                """Read queued metrics on the host, leaving the newest
                ``keep`` in flight so the card is not waited on every step."""
                while len(pending) > keep:
                    metrics, done, gstep = pending.pop(0)
                    values = {k: float(v) for k, v in metrics.items()}
                    for k, v in values.items():
                        running[k] = running.get(k, 0.0) + v * done
                    if logger is not None:
                        logger.log(gstep, {**values, "lr": epoch_lr, "epoch": epoch})

            def run(batches) -> None:
                nonlocal n_steps, global_step
                i = 0
                while i < len(batches):
                    if len(batches) - i >= window:
                        chunk = batches[i : i + window]
                        imgs = torch.from_numpy(np.stack([b[0] for b in chunk]))
                        masks = torch.from_numpy(np.stack([b[1] for b in chunk]).astype(np.uint8))
                        metrics, done = multistep(state, imgs, masks, gen), window
                    else:
                        imgs = torch.from_numpy(batches[i][0])
                        masks = torch.from_numpy(batches[i][1].astype(np.uint8))
                        metrics, done = train_step(state, imgs, masks, gen), 1
                    i += done
                    n_steps += done
                    global_step += done
                    pending.append((metrics, done, global_step))
                    drain(keep=1)

            batches = (loader.prefetch_epoch(epoch, prefetch=cfg.num_workers)
                       if cfg.num_workers > 0 else loader.epoch(epoch))
            buf = []
            for batch in batches:
                if n_steps + len(buf) >= steps_per_epoch:
                    break
                buf.append(batch)
                if len(buf) == window:
                    run(buf)
                    buf = []
            run(buf)
            drain()
            avg = {k: v / max(1, n_steps) for k, v in running.items()}
            epoch_loss = avg.get(loss_key, 0.0)
            history["epoch_loss"].append(epoch_loss)
            if not writer:
                continue
            print(f"[{name}] epoch {epoch + 1}/{num_epochs} " + " ".join(f"{k}={v:.4f}" for k, v in sorted(avg.items())))
            if (epoch + 1) % cfg.save_epoch_interval == 0 or epoch == num_epochs - 1:
                ckpt.save(state.step, {"state": state.state_dict(), "epoch": epoch, "rng": gen.get_state()},
                          metrics={"loss": epoch_loss})
    if logger is not None:
        logger.close()
    return history
