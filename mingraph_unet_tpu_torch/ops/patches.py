"""Patch extraction, pooling and broadcasting on NHWC tensors. Counterpart
of ``mingraph_unet_tpu/ops/patches.py`` (forward only)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "patch_grid_dims",
    "pad_to_multiple",
    "patchify",
    "unpatchify",
    "patch_reduce_mean",
    "broadcast_patch_to_pixels",
]


def patch_grid_dims(h: int, w: int, patch_size: int) -> Tuple[int, int]:
    """(num_patches_h, num_patches_w) after padding to multiples."""
    return (-(-h // patch_size), -(-w // patch_size))


def pad_to_multiple(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Zero-pad the spatial axes 1 and 2 of NHWC (or NHW) at the bottom and
    right up to multiples of ``patch_size``."""
    pad_h, pad_w = (-x.shape[1]) % patch_size, (-x.shape[2]) % patch_size
    if pad_h == 0 and pad_w == 0:
        return x
    after = x.dim() - 3  # axes after W, which F.pad lists first
    return F.pad(x, (0, 0) * after + (0, pad_w, 0, pad_h))


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """NHWC → (N, nph, npw, P, P, C) non-overlapping patches, padded first;
    node index r · npw + c in row-major order."""
    x = pad_to_multiple(x, patch_size)
    n, h, w, c = x.shape
    p = patch_size
    return x.reshape(n, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)


def unpatchify(patches: torch.Tensor) -> torch.Tensor:
    """(N, nph, npw, P, P, C) → NHWC, the inverse of :func:`patchify`."""
    n, nph, npw, p, _, c = patches.shape
    return patches.permute(0, 1, 3, 2, 4, 5).reshape(n, nph * p, npw * p, c)


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
