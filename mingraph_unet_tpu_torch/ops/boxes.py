"""Box utilities: conversions, IoU matrices and greedy NMS over a fixed
candidate set. Counterpart of ``mingraph_unet_tpu/ops/boxes.py``. Boxes are
xyxy unless noted; every function takes any leading batch axes.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["box_iou_matrix", "nms", "cxcywh_to_xyxy", "xyxy_to_cxcywh"]


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def box_iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: a (..., N, 4) × b (..., M, 4) → (..., N, M); 0 where
    the union is empty."""
    a = a[..., :, None, :]
    b = b[..., None, :, :]
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0) * torch.clamp(a[..., 3] - a[..., 1], min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0) * torch.clamp(b[..., 3] - b[..., 1], min=0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy non-maximum suppression: boxes (..., K, 4), scores (..., K) →
    ``keep`` (..., K) bool in the original order and ``order`` (..., K),
    the score-descending candidate order (equal scores lowest index first,
    as JAX's stable ``argsort``). Walking the sorted list, box ``j > i`` is
    suppressed when its IoU with box ``i`` is at least ``iou_threshold``
    and box ``i`` is itself kept. A loop of K steps on whole tensors, with
    no host synchronization."""
    k = boxes.shape[-2]
    order = torch.argsort(-scores, dim=-1, stable=True)
    sorted_boxes = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    idx = torch.arange(k, device=boxes.device)
    over = (box_iou_matrix(sorted_boxes, sorted_boxes) >= iou_threshold) & (idx[None, :] > idx[:, None])
    keep = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    for i in range(k):
        keep = keep & ~(over[..., i, :] & keep[..., i : i + 1])
    return torch.zeros_like(keep).scatter(-1, order, keep), order
