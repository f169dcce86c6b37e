"""Feature fusion: U-Net feature maps ⊕ graph embeddings. Counterpart of
``mingraph_unet_tpu/models/fusion.py``.

- U-Net maps of any size are resized bilinearly to a common size (half-pixel
  centers, no antialias: ``F.interpolate(..., align_corners=False)``, which
  is ``jax.image.resize(..., "linear", antialias=False)`` when upsampling and
  also when downsampling) and channel-concatenated.
- Per-region ``f_g (R, D)`` with an integer ``region_to_pixel_map (B, H, W)``
  is broadcast to pixels by a one-hot matmul (an index outside [0, R) gives
  zeros), then resized; a per-pixel ``f_g (B, H, W, D)`` is just resized.
- ``"concat"`` or ``"add"`` (equal widths).

No parameters; all NHWC and differentiable.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mingraph_unet_tpu_torch.ops.segment import gather_rows

__all__ = ["FeatureFusion", "fuse_features", "resize_bilinear_nhwc"]


def resize_bilinear_nhwc(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` to ``size`` with half-pixel centers and
    no antialias; the identity at the same size."""
    if (x.shape[1], x.shape[2]) == tuple(size):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear", align_corners=False,
                      antialias=False)
    return y.permute(0, 2, 3, 1)


def fuse_features(
    f_u_list: Sequence[torch.Tensor],
    f_g: torch.Tensor,
    target_spatial_size: Optional[Tuple[int, int]] = None,
    region_to_pixel_map: Optional[torch.Tensor] = None,
    fusion_method: str = "concat",
) -> torch.Tensor:
    """Fuse U-Net maps ``(B, H_i, W_i, C_i)`` with graph embeddings: ``f_g``
    is ``(R, D)`` with ``region_to_pixel_map`` or ``(B, H, W, D)``. The
    output size defaults to the first U-Net map's."""
    if target_spatial_size is None:
        target_spatial_size = (f_u_list[0].shape[1], f_u_list[0].shape[2])
    h, w = target_spatial_size
    f_u = torch.cat([resize_bilinear_nhwc(f, (h, w)) for f in f_u_list], dim=-1)
    if f_g.dim() == 2:
        if region_to_pixel_map is None:
            raise ValueError("per-region f_g requires region_to_pixel_map")
        rmap = region_to_pixel_map.long()
        b, rh, rw = rmap.shape
        flat = rmap.reshape(b, -1)
        flat = torch.where((flat >= 0) & (flat < f_g.shape[0]), flat, torch.full_like(flat, -1))
        f_g_aligned = resize_bilinear_nhwc(gather_rows(f_g, flat).reshape(b, rh, rw, f_g.shape[-1]), (h, w))
    elif f_g.dim() == 4:
        f_g_aligned = resize_bilinear_nhwc(f_g, (h, w))
    else:
        raise ValueError(f"f_g has unsupported shape {tuple(f_g.shape)}; expected (R, D) with a region map "
                         "or (B, H, W, D)")
    method = fusion_method.lower()
    if method == "concat":
        return torch.cat([f_u, f_g_aligned], dim=-1)
    if method == "add":
        if f_u.shape[-1] != f_g_aligned.shape[-1]:
            raise ValueError("Channel dimensions must match for 'add' fusion")
        return f_u + f_g_aligned
    raise NotImplementedError(f"Fusion method {fusion_method!r} not implemented.")


class FeatureFusion(nn.Module):
    """Module form of :func:`fuse_features` (no parameters)."""

    def __init__(self, fusion_method: str = "concat"):
        super().__init__()
        self.fusion_method = fusion_method

    def forward(self, f_u_list: Sequence[torch.Tensor], f_g: torch.Tensor,
                target_spatial_size: Optional[Tuple[int, int]] = None,
                region_to_pixel_map: Optional[torch.Tensor] = None) -> torch.Tensor:
        return fuse_features(f_u_list, f_g, target_spatial_size, region_to_pixel_map, self.fusion_method)
