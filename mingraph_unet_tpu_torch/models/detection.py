"""Single-box detection head. Counterpart of
``mingraph_unet_tpu/models/detection.py::DetectionHead``: Conv(C→C/2) →
ReLU → BN → Conv(C/2→C/4) → ReLU → BN → global mean, then FC(fc_hidden) →
ReLU → Dropout(0.5) → FC(fc_hidden/2) → ReLU → Dropout(0.5), sigmoid bbox
(B, 4) and confidence (B, 1). The reference's Conv→ReLU→BN order is kept;
BN has eps 1e-5 and, in train mode (``module.train()``), normalizes over the
batch statistics and updates the running ones (flax's rules,
``layers.FoldableBatchNorm``). ``pre_pool_size`` is the JAX head's own
average pool of its input down to ≤ S×S before the convs (the non-pooled
pipeline path with ``detection_pre_pool`` set). The dense head and class
scores (``num_detection_classes > 1``) are not ported."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mingraph_unet_tpu_torch.models import layers
from mingraph_unet_tpu_torch.models.layers import ConvParams, Dense, FoldableBatchNorm
from mingraph_unet_tpu_torch.ops.conv import conv2d_nhwc

__all__ = ["DetectionHead"]

HEAD_DROPOUT = 0.5


def _avg_pool_to(x: torch.Tensor, size: int) -> torch.Tensor:
    """flax ``avg_pool`` with window and stride ``(H // size, W // size)``
    (each at least 1), 'VALID': a ragged trailing row or column is dropped.
    NHWC; the identity unless H > size."""
    b, h, w, c = x.shape
    if h <= size:
        return x
    sh, sw = max(1, h // size), max(1, w // size)
    x = x[:, : h // sh * sh, : w // sw * sw]
    return x.reshape(b, h // sh, sh, w // sw, sw, c).mean(dim=(2, 4))


class DetectionHead(nn.Module):
    """``forward(f (B, H, W, C), pre_pool_size, gen) → (bboxes (B, 4),
    confidence (B, 1))``, f32 (f64 in an f64 head); ``gen`` draws the
    dropout masks in train mode."""

    def __init__(self, in_features: int, gen: torch.Generator, fc_hidden_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
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

    def forward(self, f: torch.Tensor, pre_pool_size: Optional[int] = None,
                gen: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        x = f.to(self.dtype)
        if pre_pool_size is not None:
            x = _avg_pool_to(x, pre_pool_size)
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2)):
            x = bn(torch.relu(conv2d_nhwc(x, conv.kernel, conv.bias, padding=1)))
        x = x.mean(dim=(1, 2))
        gen = gen if self.training else None
        x = layers.dropout(torch.relu(self.fc1(x)), HEAD_DROPOUT, gen)
        x = layers.dropout(torch.relu(self.fc2(x)), HEAD_DROPOUT, gen)
        acc = torch.promote_types(x.dtype, torch.float32)
        return torch.sigmoid(self.fc_bbox(x).to(acc)), torch.sigmoid(self.fc_confidence(x).to(acc))
