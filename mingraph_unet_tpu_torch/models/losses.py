"""Losses of the segmentation and end-to-end trainers. Counterpart of
``mingraph_unet_tpu/models/losses.py``.

Logits are NHWC with the class last, labels integer (B, H, W). Each loss
is computed in its inputs' dtype, at least f32 (f32 on the training paths,
f64 in an f64 reference), and is
differentiable where the JAX one is: the connected-component instances of
:func:`elliptical_shape_loss_soft_instances` are a no-gradient input, as
JAX's ``stop_gradient``.

Inside ``parallel/data.py::data_parallel`` each loss returns this rank's
contribution to the loss of the global batch (means over the batch are
taken over the global count, the shape and box losses divide by the valid
objects and positive images of all ranks), so that the contributions of
all ranks sum to the one-process loss. A loss computed inside that context
is thus not the loss: the trainers sum the contributions over the ranks
(``all_reduce_metrics``) outside it, and that function refuses to run
inside it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mingraph_unet_tpu_torch.ops import cc
from mingraph_unet_tpu_torch.parallel.data import batch_mean, global_batch, global_count, replicated

__all__ = [
    "cross_entropy_loss",
    "dice_loss",
    "feature_consistency_loss",
    "partition_supervision_loss",
    "total_variation_loss",
    "elliptical_shape_loss",
    "elliptical_shape_loss_from_probs",
    "elliptical_shape_loss_soft",
    "elliptical_shape_loss_soft_instances",
    "detection_losses",
]


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over every pixel. Inside ``data_parallel``: this rank's contribution."""
    logp = torch.log_softmax(logits, dim=-1)
    return batch_mean(-logp.gather(-1, labels.long()[..., None]))


def dice_loss(logits: torch.Tensor, labels: torch.Tensor, smooth: float = 1.0) -> torch.Tensor:
    """Soft Dice, ``1 − mean_{b,c}[(2·I + s) / (U + s)]`` with per-class sums
    over the spatial axes of the softmax probabilities and the one-hot
    target. Inside ``data_parallel``: this rank's contribution."""
    probs = torch.softmax(logits, dim=-1)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (labels.long()[..., None] == classes).to(probs.dtype)
    intersection = (probs * onehot).sum(dim=(1, 2))
    union = probs.sum(dim=(1, 2)) + onehot.sum(dim=(1, 2))
    return replicated(1.0) - batch_mean((2.0 * intersection + smooth) / (union + smooth))


def feature_consistency_loss(f_unet: torch.Tensor, f_graph: torch.Tensor, patch_labels: torch.Tensor,
                             margin: float = 1.0) -> torch.Tensor:
    """L_feature ``Σ_p [y_p·d² + (1 − y_p)·max(0, m − d)²]`` over patches,
    mean over the batch, with ``d = sqrt(‖f_u − f_g‖² + 1e-8)``.
    ``f_unet``, ``f_graph`` (B, N, D); ``patch_labels`` (B, N) in {0, 1}.
    Inside ``data_parallel``: this rank's contribution."""
    if f_unet.shape != f_graph.shape:
        raise ValueError(f"f_unet {tuple(f_unet.shape)} and f_graph {tuple(f_graph.shape)} must match")
    y = patch_labels.to(f_unet.dtype)
    dist_sq = ((f_unet - f_graph) ** 2).sum(dim=-1)
    dist = torch.sqrt(dist_sq + 1e-8)
    negative = (1.0 - y) * torch.relu(margin - dist) ** 2
    return batch_mean((y * dist_sq + negative).sum(dim=-1))


def partition_supervision_loss(soft_assignments: torch.Tensor, y_p: torch.Tensor,
                               eps: float = 1e-8) -> torch.Tensor:
    """Patch CE of the MinCut soft assignments (B, nph, npw, K) against the
    patch labels ``y_p`` (B, nph, npw) in {0, 1}: region 1 is fruit, 0
    background. Mean over patches and batch. Inside ``data_parallel``: this rank's contribution."""
    p_target = soft_assignments.gather(-1, y_p.long()[..., None])[..., 0]
    return batch_mean(-torch.log(p_target + eps))


def total_variation_loss(x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Anisotropic TV on NHWC maps, ``w·(Σ∂h²/count_h + Σ∂w²/count_w)/B``.
    Inside ``data_parallel``: this rank's contribution."""
    b, h, w = x.shape[0], x.shape[1], x.shape[2]
    h_tv = ((x[:, 1:] - x[:, :-1]) ** 2).sum()
    w_tv = ((x[:, :, 1:] - x[:, :, :-1]) ** 2).sum()
    return weight * (h_tv / ((h - 1) * w) + w_tv / (h * (w - 1))) / global_batch(b)


def _masked_shape_terms(masks: torch.Tensor, min_pixels: int, epsilon: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-object (loss, valid) of stacked instance masks (..., O, H, W):
    the mean over the object's pixels of ``(pᵀ Σ⁻¹ p − 1)²``, with the
    sample covariance (denominator n − 1) plus εI inverted in closed form."""
    m = masks.to(torch.promote_types(masks.dtype, torch.float32))
    h, w = m.shape[-2], m.shape[-1]
    ys = torch.arange(h, dtype=m.dtype, device=m.device)[:, None]
    xs = torch.arange(w, dtype=m.dtype, device=m.device)[None, :]
    n = m.sum(dim=(-2, -1))
    safe_n = torch.clamp(n, min=1.0)
    cy = (m * ys).sum(dim=(-2, -1)) / safe_n
    cx = (m * xs).sum(dim=(-2, -1)) / safe_n
    dy = (ys - cy[..., None, None]) * m
    dx = (xs - cx[..., None, None]) * m
    denom = torch.clamp(n - 1.0, min=1.0)
    syy = (dy * dy).sum(dim=(-2, -1)) / denom
    sxx = (dx * dx).sum(dim=(-2, -1)) / denom
    sxy = (dy * dx).sum(dim=(-2, -1)) / denom
    a, d, b = syy + epsilon, sxx + epsilon, sxy
    det = a * d - b * b
    safe_det = torch.where(det.abs() > 1e-20, det, torch.ones_like(det))
    inv_a, inv_d, inv_b = d / safe_det, a / safe_det, -b / safe_det
    maha = (inv_a[..., None, None] * dy * dy + 2.0 * inv_b[..., None, None] * dy * dx
            + inv_d[..., None, None] * dx * dx)
    per_obj = ((maha - 1.0) ** 2 * m).sum(dim=(-2, -1)) / safe_n
    valid = (n >= min_pixels) & (n >= 2)
    return per_obj, valid


def elliptical_shape_loss(object_masks: torch.Tensor, min_pixels: int = 10, epsilon: float = 1e-6
                          ) -> torch.Tensor:
    """L_shape over stacked (soft or binary) instance masks (B, O, H, W):
    the mean over valid objects (at least ``min_pixels`` and 2 pixels of
    mass) of their Mahalanobis-ellipse penalty, 0 when none is valid.
    Inside ``data_parallel``: this rank's contribution (the valid objects
    counted over all ranks), as for the two soft forms below."""
    per_obj, valid = _masked_shape_terms(object_masks, min_pixels, epsilon)
    total = torch.where(valid, per_obj, torch.zeros_like(per_obj)).sum()
    count = global_count(valid.sum())
    return torch.where(count > 0, total / torch.clamp(count, min=1), torch.zeros_like(total))


def elliptical_shape_loss_from_probs(segmentation_probs: torch.Tensor, foreground_class: int = 1,
                                     min_pixels: int = 10, epsilon: float = 1e-6) -> torch.Tensor:
    """L_shape with each image's argmax foreground (B, H, W, C) as one hard
    object (the reference's semantic fallback)."""
    if segmentation_probs.shape[-1] <= foreground_class:
        return torch.zeros((), dtype=torch.float32, device=segmentation_probs.device)
    masks = (segmentation_probs.argmax(dim=-1) == foreground_class).to(torch.float32)[:, None]
    return elliptical_shape_loss(masks, min_pixels, epsilon)


def elliptical_shape_loss_soft(segmentation_probs: torch.Tensor, foreground_class: int = 1,
                               min_pixels: int = 10, epsilon: float = 1e-6) -> torch.Tensor:
    """L_shape with the foreground probability map (B, H, W, C) as one
    soft object per image."""
    if segmentation_probs.shape[-1] <= foreground_class:
        return torch.zeros((), dtype=torch.float32, device=segmentation_probs.device)
    p_fg = _at_least_f32(segmentation_probs[..., foreground_class])
    return elliptical_shape_loss(p_fg[:, None], min_pixels, epsilon)


def elliptical_shape_loss_soft_instances(segmentation_probs: torch.Tensor, foreground_class: int = 1,
                                         max_instances: int = 8, threshold: float = 0.5, min_pixels: int = 10,
                                         epsilon: float = 1e-6, exact: bool = False) -> torch.Tensor:
    """L_shape per predicted instance: the connected components of the
    thresholded foreground probability (``ops/cc.py``: the stencil and
    dense forms, or with ``exact`` the hook-and-jump and histogram forms)
    pick up to ``max_instances`` slots, and each slot weighs its pixels by
    the soft probability. The instances carry no gradient."""
    if segmentation_probs.shape[-1] <= foreground_class:
        return torch.zeros((), dtype=torch.float32, device=segmentation_probs.device)
    p_fg = _at_least_f32(segmentation_probs[..., foreground_class])
    hard = (p_fg > threshold).to(torch.int32)
    if exact:
        inst, _ = cc.top_instances(cc.label_components(hard), max_instances, min_area=min_pixels)
    else:
        inst, _ = cc.top_instances_dense(cc.label_components_stencil(hard), max_instances, min_area=min_pixels)
    return elliptical_shape_loss(inst * p_fg[:, None], min_pixels, epsilon)


def detection_losses(pred_boxes: torch.Tensor, pred_conf: torch.Tensor, gt_boxes: torch.Tensor,
                     gt_has_object: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-box losses: L1 box error summed over (cx, cy, w, h), averaged
    over the images with an object, and the BCE of the confidence (clipped
    to [1e-7, 1 − 1e-7]) averaged over all images. Inside ``data_parallel``: this rank's contribution."""
    has = gt_has_object.to(pred_boxes.dtype)
    l1 = (pred_boxes - gt_boxes).abs().sum(dim=-1)
    bbox_loss = (l1 * has).sum() / torch.clamp(global_count(has.sum()), min=1.0)
    conf = torch.clamp(pred_conf[..., 0], 1e-7, 1.0 - 1e-7)
    bce = -(has * torch.log(conf) + (1.0 - has) * torch.log(1.0 - conf))
    return bbox_loss, batch_mean(bce)
