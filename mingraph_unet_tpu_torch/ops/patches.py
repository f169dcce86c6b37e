"""Patch pooling and broadcasting on NHWC tensors. Counterpart of
``mingraph_unet_tpu/ops/patches.py`` (forward only)."""

from __future__ import annotations

import torch

__all__ = ["patch_reduce_mean", "broadcast_patch_to_pixels"]


def patch_reduce_mean(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Per-patch channel means, summed in f32 (f64 for f64): (N, H, W, C) →
    (N, H/p, W/p, C)."""
    n, h, w, c = x.shape
    p = patch_size
    y = x.to(torch.promote_types(x.dtype, torch.float32)).reshape(n, h // p, p, w // p, p, c).sum(dim=(2, 4))
    return (y / (p * p)).to(x.dtype)


def broadcast_patch_to_pixels(patch_vals: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(N, nph, npw, C) → (N, nph·p, npw·p, C) by nearest (block) upsampling."""
    x = patch_vals.repeat_interleave(patch_size, dim=1)
    return x.repeat_interleave(patch_size, dim=2)
