"""Shared trainer machinery: optimizer, learning-rate schedule, train state,
multi-step windows. Counterpart of ``mingraph_unet_tpu/train/common.py``.

Optimizer semantics are the JAX package's (and the reference's):
- Adam with L2 ``weight_decay`` folded into the gradient, Adam over
  ``g + wd·p``: ``torch.optim.Adam(weight_decay=...)``, not AdamW.
- SGD with momentum and the same folded weight decay.
- StepLR, ``lr·γ^⌊step / (steps_per_epoch·lr_step_size)⌋``, stepped once
  per optimizer step (a staircase), so the k-th update uses the rate of
  step k as optax's schedule does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Tuple

import torch
from torch import nn

from mingraph_unet_tpu_torch.config import TrainingConfig

__all__ = ["TrainState", "make_optimizer", "make_lr_schedule", "make_multistep"]


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
