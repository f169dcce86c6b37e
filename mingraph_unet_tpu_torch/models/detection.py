"""Detection heads. Counterpart of ``mingraph_unet_tpu/models/detection.py``.

- :class:`DetectionHead`, the single-box head: Conv(C→C/2) → ReLU → BN →
  Conv(C/2→C/4) → ReLU → BN → global mean, then FC(fc_hidden) → ReLU →
  Dropout(0.5) → FC(fc_hidden/2) → ReLU → Dropout(0.5), sigmoid bbox (B, 4),
  sigmoid confidence (B, 1) and, when ``num_classes > 1``, class scores
  (B, num_classes). The reference's Conv→ReLU→BN order is kept; BN has eps
  1e-5 and, in train mode (``module.train()``), normalizes over the batch
  statistics and updates the running ones (flax's rules,
  ``layers.FoldableBatchNorm``). ``pre_pool_size`` is the JAX head's own
  average pool of its input down to ≤ S×S before the convs (the non-pooled
  pipeline path with ``detection_pre_pool`` set). Its convs are
  ``ops/kernels/conv3x3.py::conv3x3_same``, which picks the kernel (f32 on
  the card) or ``conv2d_nhwc``.
- :class:`DenseDetectionHead`, the multi-instance head: per ``cell_size``
  cell an objectness logit and a box (centre offset in the cell, size as a
  fraction of the image), decoded by :func:`decode_dense_detections` (top-k
  and NMS) and trained by :func:`dense_detection_loss`. Its convs are plain
  ``F.conv2d``, as the JAX package leaves them to XLA. Ranges:
  ``mgu.dense_head`` (the head's forward), ``mgu.decode.topk`` (scores,
  boxes and the top-k) and ``mgu.decode.nms`` (NMS and the survivors).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from mingraph_unet_tpu_torch.models import layers
from mingraph_unet_tpu_torch.models.layers import ConvParams, Dense, FoldableBatchNorm
from mingraph_unet_tpu_torch.ops.boxes import cxcywh_to_xyxy, nms
from mingraph_unet_tpu_torch.ops.cc import _top_k_stable, instance_boxes
from mingraph_unet_tpu_torch.ops.conv import conv2d_nhwc
from mingraph_unet_tpu_torch.ops.kernels.conv3x3 import conv3x3_same
from mingraph_unet_tpu_torch.parallel.data import batch_mean, global_count
from mingraph_unet_tpu_torch.utils.profiling import span

__all__ = ["DetectionHead", "DenseDetectionHead", "decode_dense_detections", "dense_detection_loss"]

HEAD_DROPOUT = 0.5


def _avg_pool(x: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """flax ``avg_pool`` with window and stride ``(sh, sw)``, 'VALID': a
    ragged trailing row or column is dropped. NHWC."""
    b, h, w, c = x.shape
    x = x[:, : h // sh * sh, : w // sw * sw]
    return x.reshape(b, h // sh, sh, w // sw, sw, c).mean(dim=(2, 4))


class DetectionHead(nn.Module):
    """``forward(f (B, H, W, C), pre_pool_size, gen) → (bboxes (B, 4),
    confidence (B, 1)[, class_scores (B, num_classes)])``, f32 (f64 in an
    f64 head); ``gen`` draws the dropout masks in train mode."""

    def __init__(self, in_features: int, gen: torch.Generator, fc_hidden_dim: int = 256,
                 dtype: torch.dtype = torch.float32, num_classes: int = 1):
        super().__init__()
        c = in_features
        self.dtype = dtype
        self.conv1 = ConvParams(c, c // 2, (3, 3), gen)
        self.bn1 = FoldableBatchNorm(c // 2)
        self.conv2 = ConvParams(c // 2, c // 4, (3, 3), gen)
        self.bn2 = FoldableBatchNorm(c // 4)
        self.fc1 = Dense(c // 4, fc_hidden_dim, gen, dtype)
        self.fc2 = Dense(fc_hidden_dim, fc_hidden_dim // 2, gen, dtype)
        self.fc_bbox = Dense(fc_hidden_dim // 2, 4, gen, dtype)
        self.fc_confidence = Dense(fc_hidden_dim // 2, 1, gen, dtype)
        if num_classes > 1:
            self.fc_class_scores = Dense(fc_hidden_dim // 2, num_classes, gen, dtype)

    def forward(self, f: torch.Tensor, pre_pool_size: Optional[int] = None,
                gen: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        with span("detection"):
            x = f.to(self.dtype)
            if pre_pool_size is not None and x.shape[1] > pre_pool_size:
                x = _avg_pool(x, max(1, x.shape[1] // pre_pool_size), max(1, x.shape[2] // pre_pool_size))
            for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2)):
                x = bn(torch.relu(conv3x3_same(x, conv.kernel, conv.bias)))
            x = x.mean(dim=(1, 2))
            gen = gen if self.training else None
            x = layers.dropout(torch.relu(self.fc1(x)), HEAD_DROPOUT, gen)
            x = layers.dropout(torch.relu(self.fc2(x)), HEAD_DROPOUT, gen)
            acc = torch.promote_types(x.dtype, torch.float32)
            out = (torch.sigmoid(self.fc_bbox(x).to(acc)), torch.sigmoid(self.fc_confidence(x).to(acc)))
            if hasattr(self, "fc_class_scores"):
                out += (self.fc_class_scores(x).to(acc),)
            return out


class DenseDetectionHead(nn.Module):
    """``forward(f (B, H, W, C)) → {"objectness_logits": (B, gh, gw),
    "boxes": (B, gh, gw, 4)}``, f32 (f64 in an f64 head), with ``gh =
    H // cell_size``: conv 3×3 → ReLU → average pool by ``cell_size``
    (VALID) → conv 3×3 → ReLU → 1×1 objectness and sigmoid 1×1 box (dx, dy
    the centre's offset in its cell, w, h fractions of the image)."""

    def __init__(self, in_features: int, gen: torch.Generator, cell_size: int = 16, hidden: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cell_size = cell_size
        self.dtype = dtype
        self.conv1 = ConvParams(in_features, hidden, (3, 3), gen)
        self.conv2 = ConvParams(hidden, hidden, (3, 3), gen)
        self.obj_head = ConvParams(hidden, 1, (1, 1), gen)
        self.box_head = ConvParams(hidden, 4, (1, 1), gen)

    def forward(self, f: torch.Tensor) -> Dict[str, torch.Tensor]:
        with span("dense_head"):
            x = torch.relu(conv2d_nhwc(f.to(self.dtype), self.conv1.kernel, self.conv1.bias, padding=1))
            x = _avg_pool(x, self.cell_size, self.cell_size)
            x = torch.relu(conv2d_nhwc(x, self.conv2.kernel, self.conv2.bias, padding=1))
            acc = torch.promote_types(x.dtype, torch.float32)
            obj = conv2d_nhwc(x, self.obj_head.kernel, self.obj_head.bias, padding=0).to(acc)
            box = torch.sigmoid(conv2d_nhwc(x, self.box_head.kernel, self.box_head.bias, padding=0).to(acc))
            return {"objectness_logits": obj[..., 0], "boxes": box}


def decode_dense_detections(
    objectness_logits: torch.Tensor,
    boxes: torch.Tensor,
    image_hw: Tuple[int, int],
    cell_size: int,
    top_k: int = 32,
    score_threshold: float = 0.5,
    iou_threshold: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense head outputs → per image ``(boxes_xyxy (B, K, 4), scores (B, K),
    valid (B, K))`` with ``K = min(top_k, gh·gw)``: the K best cells (equal
    scores lowest index first, as ``jax.lax.top_k``), NMS among them, and
    the survivors scoring at least ``score_threshold``; invalid slots hold
    zero boxes and scores. Boxes are in pixels and not clipped to the image.
    The sigmoid is taken in f64 and rounded once to f32, so that the card
    and the CPU give the same scores bit for bit (their f32 ``exp`` differ
    in the last place); everything after it is exactly rounded f32
    arithmetic. No host synchronization."""
    b, gh, gw = objectness_logits.shape
    h, w = image_hw
    k = min(top_k, gh * gw)
    dev = objectness_logits.device
    with span("decode.topk"):
        scores_all = torch.sigmoid(objectness_logits.double()).float().reshape(b, gh * gw)
        yy = torch.arange(gh, dtype=torch.float32, device=dev).repeat_interleave(gw)
        xx = torch.arange(gw, dtype=torch.float32, device=dev).repeat(gh)
        flat = boxes.float().reshape(b, gh * gw, 4)
        cx = (xx[None] + flat[..., 0]) * cell_size
        cy = (yy[None] + flat[..., 1]) * cell_size
        xyxy = cxcywh_to_xyxy(torch.stack([cx, cy, flat[..., 2] * w, flat[..., 3] * h], dim=-1))
        top_scores, top_idx = _top_k_stable(scores_all, k)
        top_boxes = torch.gather(xyxy, 1, top_idx[..., None].expand(b, k, 4))
    with span("decode.nms"):
        keep, _ = nms(top_boxes, top_scores, iou_threshold=iou_threshold)
        valid = keep & (top_scores >= score_threshold)
        return (torch.where(valid[..., None], top_boxes, torch.zeros_like(top_boxes)),
                torch.where(valid, top_scores, torch.zeros_like(top_scores)), valid)


def dense_detection_loss(outputs: Dict[str, torch.Tensor], gt_instance_masks: torch.Tensor,
                         cell_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(objectness BCE, box L1 over positive cells) of the dense head's
    ``outputs`` against ground-truth instance masks (B, O, H, W) (all-zero
    rows pad). Each instance activates the cell holding its box centre
    (cell indices truncated from f32, as JAX's int32 cast), which regresses
    its (offset, size). Inside ``parallel/data.py::data_parallel`` both
    terms are this rank's contributions to the global batch's: the BCE's
    mean over every image's cells, the L1 over every rank's instances."""
    obj_logits = outputs["objectness_logits"]
    pred_boxes = outputs["boxes"]
    b, gh, gw = obj_logits.shape
    h, w = gt_instance_masks.shape[-2:]
    with torch.no_grad():
        x0, y0, x1, y1 = instance_boxes(gt_instance_masks).unbind(-1)  # (B, O)
        has = gt_instance_masks.flatten(2).ne(0).any(-1)
        cx = (x0 + x1 + 1.0) / 2.0
        cy = (y0 + y1 + 1.0) / 2.0
        cell_x = torch.clamp((cx / cell_size).to(torch.int32), 0, gw - 1)
        cell_y = torch.clamp((cy / cell_size).to(torch.int32), 0, gh - 1)
        cell_flat = (cell_y * gw + cell_x).long()
        tgt = torch.zeros((b, gh * gw), dtype=obj_logits.dtype, device=obj_logits.device).scatter_reduce(
            1, cell_flat, has.to(obj_logits.dtype), reduce="amax", include_self=True).reshape(b, gh, gw)
        gt_reg = torch.stack([cx / cell_size - cell_x, cy / cell_size - cell_y,
                              (x1 - x0 + 1.0) / w, (y1 - y0 + 1.0) / h], dim=-1)
    obj_bce = batch_mean(torch.clamp(obj_logits, min=0) - obj_logits * tgt + torch.log1p(torch.exp(-obj_logits.abs())))
    pred_at_cells = torch.gather(pred_boxes.reshape(b, gh * gw, 4), 1, cell_flat[..., None].expand(*cell_flat.shape, 4))
    l1 = (pred_at_cells - gt_reg.to(pred_at_cells.dtype)).abs().sum(-1)
    has_f = has.to(l1.dtype)
    return obj_bce, (l1 * has_f).sum() / torch.clamp(global_count(has_f.sum()), min=1.0)
