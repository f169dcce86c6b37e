"""Segment pooling and broadcasting as one-hot matmuls. Counterpart of
``mingraph_unet_tpu/ops/segment.py``."""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["segment_mean", "gather_rows"]


def _one_hot(labels: torch.Tensor, k: int, dtype: torch.dtype) -> torch.Tensor:
    """(..., N) integer labels → (..., N, K); a label outside [0, K) gives an
    all-zero row."""
    classes = torch.arange(k, device=labels.device)
    return (labels[..., None] == classes).to(dtype)


def segment_mean(
    values: torch.Tensor, labels: torch.Tensor, num_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment mean of ``values (..., N, D)`` keyed by ``labels (..., N)``;
    empty segments give zeros. Returns ``(means (..., K, D), counts (..., K))``."""
    onehot = _one_hot(labels, num_segments, values.dtype)
    sums = torch.einsum("...nk,...nd->...kd", onehot, values)
    counts = onehot.sum(dim=-2)
    return sums / torch.clamp(counts, min=1.0)[..., None], counts


def gather_rows(table: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``table (..., K, D)`` rows at ``labels (..., N)`` → (..., N, D);
    negative labels give zeros."""
    onehot = _one_hot(labels, table.shape[-2], table.dtype)
    return torch.einsum("...nk,...kd->...nd", onehot, table)
