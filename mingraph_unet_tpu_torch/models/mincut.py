"""Soft Normalized-Cut partitioning on the patch lattice. Counterpart of
``mingraph_unet_tpu/models/mincut.py``: Gaussian edge weights
``w = exp(−‖f_i − f_j‖²/2σ²)`` over the four lattice neighbours,
``L = Σ_k cut_k / assoc_k``, where a segment counts only when
``assoc_k > 1e-8``. The loss is differentiable in both the features and the
assignments (autograd's gradient); in train mode the predictor's GAT drops
at ``dropout_rate``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mingraph_unet_tpu_torch.models.gat import GATNetwork
from mingraph_unet_tpu_torch.ops import lattice as lattice_ops

__all__ = ["normalized_cut_loss_lattice", "SegmentPredictor", "MinCutRefinement"]

_ASSOC_EPS = 1e-8


def normalized_cut_loss_lattice(
    features: torch.Tensor, soft_assignments: torch.Tensor, sigma: float = 1.0
) -> torch.Tensor:
    """``features (..., nph, npw, D)``, ``soft_assignments (..., nph, npw, K)``
    → loss per leading batch index."""
    nph, npw = features.shape[-3], features.shape[-2]
    w_dirs, p_neighbors = [], []
    for dr, dc in lattice_ops.DIRECTIONS:
        f_n = lattice_ops.shift(features, dr, dc)
        valid = lattice_ops.neighbor_mask(nph, npw, dr, dc, features.dtype, features.device)
        dist_sq = ((features - f_n) ** 2).sum(dim=-1)
        w_dirs.append(torch.exp(-dist_sq / (2.0 * sigma**2)) * valid)
        p_neighbors.append(lattice_ops.shift(soft_assignments, dr, dc))
    w = torch.stack(w_dirs, dim=-1)  # (..., nph, npw, 4)
    pn = torch.stack(p_neighbors, dim=-2)  # (..., nph, npw, 4, K)
    p = soft_assignments
    assoc = torch.einsum("...rck,...rc->...k", p, w.sum(dim=-1))
    cut = torch.einsum("...rck,...rcd->...k", p, w) - torch.einsum("...rck,...rcd,...rcdk->...k", p, w, pn)
    ok = assoc > _ASSOC_EPS
    per_k = torch.where(ok, cut / torch.where(ok, assoc, torch.ones_like(assoc)), torch.zeros_like(cut))
    return per_k.sum(dim=-1)


class SegmentPredictor(nn.Module):
    """Per-node K-way segment logits from a 1-layer lattice GAT
    (``gnn_predictor``)."""

    def __init__(self, in_features, num_segments, hidden_dim, num_heads, gen, alpha=0.2, dtype=torch.float32,
                 dropout_rate=0.1):
        super().__init__()
        self.gnn_predictor = GATNetwork(
            in_features, hidden_dim, num_segments, num_heads, gen, 1, alpha, "lattice", dtype, dropout_rate
        )

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.gnn_predictor(x, gen=gen)


class MinCutRefinement(nn.Module):
    """``forward(gat_features) → (l_partition, soft_assignments)`` on the
    lattice (``segment_predictor``)."""

    def __init__(self, in_features, num_segments, gen, sigma_ncut=1.0, predictor_hidden=None,
                 predictor_heads=1, alpha=0.2, dtype=torch.float32, dropout_rate=0.1):
        super().__init__()
        self.sigma_ncut = sigma_ncut
        self.segment_predictor = SegmentPredictor(
            in_features, num_segments, predictor_hidden or in_features, predictor_heads, gen, alpha, dtype,
            dropout_rate,
        )

    def forward(self, gat_features: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = self.segment_predictor(gat_features, gen=gen)
        acc = torch.promote_types(logits.dtype, torch.float32)  # f32, or f64 in an f64 model
        soft = torch.softmax(logits.to(acc), dim=-1)
        return normalized_cut_loss_lattice(gat_features.to(acc), soft, self.sigma_ncut), soft
