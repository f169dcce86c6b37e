"""Image transforms used on the inference path. Counterpart of
``mingraph_unet_tpu/ops/image.py`` (the port keeps its own copy of the
constants)."""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import torch

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "denormalize", "rgb_to_gray"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_GRAY_WEIGHTS = (0.299, 0.587, 0.114)  # OpenCV RGB→gray


@lru_cache(maxsize=None)
def _channel_vector(values: Tuple[float, ...], dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Cached per device: a host-to-card copy inside the forward would
    synchronize the stream."""
    return torch.tensor(values, dtype=dtype, device=device)


def denormalize(img: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Invert channel-wise normalization: ``img * std + mean`` (NHWC / HWC)."""
    std_t = _channel_vector(tuple(std), img.dtype, img.device)
    return img * std_t + _channel_vector(tuple(mean), img.dtype, img.device)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """RGB→gray with OpenCV weights: (…, H, W, 3) → (…, H, W)."""
    w = _GRAY_WEIGHTS
    return w[0] * img[..., 0] + w[1] * img[..., 1] + w[2] * img[..., 2]
