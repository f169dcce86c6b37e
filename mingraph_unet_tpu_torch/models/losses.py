"""Segmentation losses of the U-Net trainer: softmax cross-entropy and soft
Dice. Counterpart of ``mingraph_unet_tpu/models/losses.py``
(``cross_entropy_loss``, ``dice_loss``); the other losses there belong to
the end-to-end trainer and are not ported yet.

Logits are NHWC with the class last, labels integer (B, H, W); both losses
are computed in the logits' dtype, f32 on the training path.
"""

from __future__ import annotations

import torch

__all__ = ["cross_entropy_loss", "dice_loss"]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over every pixel."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[..., None]).mean()


def dice_loss(logits: torch.Tensor, labels: torch.Tensor, smooth: float = 1.0) -> torch.Tensor:
    """Soft Dice, ``1 − mean_{b,c}[(2·I + s) / (U + s)]`` with per-class sums
    over the spatial axes of the softmax probabilities and the one-hot
    target."""
    probs = torch.softmax(logits, dim=-1)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (labels.long()[..., None] == classes).to(probs.dtype)
    intersection = (probs * onehot).sum(dim=(1, 2))
    union = probs.sum(dim=(1, 2)) + onehot.sum(dim=(1, 2))
    return 1.0 - ((2.0 * intersection + smooth) / (union + smooth)).mean()
