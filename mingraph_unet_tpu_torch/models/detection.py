"""Single-box detection head (inference). Counterpart of
``mingraph_unet_tpu/models/detection.py::DetectionHead``: Conv(C→C/2) →
ReLU → BN → Conv(C/2→C/4) → ReLU → BN → global mean, then FC(fc_hidden) →
ReLU → FC(fc_hidden/2) → ReLU, sigmoid bbox (B, 4) and confidence (B, 1).
The reference's Conv→ReLU→BN order is kept; BN uses running statistics
with eps 1e-5. Dropout is the identity at inference. The serving path feeds
it the 32×32 pooled map, so the JAX head's own ``pre_pool_size`` pooling is
not ported."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from mingraph_unet_tpu_torch.models.layers import ConvParams, Dense, FoldableBatchNorm
from mingraph_unet_tpu_torch.ops.conv import conv2d_nhwc

__all__ = ["DetectionHead"]


class DetectionHead(nn.Module):
    """``forward(f (B, H, W, C)) → (bboxes (B, 4), confidence (B, 1))``, f32."""

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

    def forward(self, f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = f.to(self.dtype)
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2)):
            x = bn(torch.relu(conv2d_nhwc(x, conv.kernel, conv.bias, padding=1)))
        x = x.mean(dim=(1, 2))
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        return torch.sigmoid(self.fc_bbox(x).float()), torch.sigmoid(self.fc_confidence(x).float())
