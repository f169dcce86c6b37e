"""Soft Normalized-Cut partitioning. Counterpart of
``mingraph_unet_tpu/models/mincut.py``: Gaussian edge weights
``w = exp(−‖f_i − f_j‖²/2σ²)``, ``L = Σ_k cut_k / assoc_k``, where a segment
counts only when ``assoc_k > 1e-8``. Two backends: ``"lattice"`` (the four
lattice neighbours of a grid, the model's) and ``"dense"`` (any graph as an
(N, N) 0/1 mask, for the region graph and the tests). The segment
predictor is a GAT on the backend's graph or, with ``use_gnn=False``, a
two-layer MLP (``fc1`` → ReLU → ``fc2``). The loss is differentiable in both
the features and the assignments (autograd's gradient); in train mode the
predictor's GAT drops at ``dropout_rate`` (the MLP does not drop)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mingraph_unet_tpu_torch.models.gat import GATNetwork
from mingraph_unet_tpu_torch.models.layers import Dense
from mingraph_unet_tpu_torch.ops import lattice as lattice_ops
from mingraph_unet_tpu_torch.utils.profiling import span

__all__ = ["edge_weights_dense", "normalized_cut_loss_dense", "normalized_cut_loss_lattice", "SegmentPredictor",
           "MinCutRefinement"]

_ASSOC_EPS = 1e-8


def _per_segment(cut: torch.Tensor, assoc: torch.Tensor) -> torch.Tensor:
    ok = assoc > _ASSOC_EPS
    per_k = torch.where(ok, cut / torch.where(ok, assoc, torch.ones_like(assoc)), torch.zeros_like(cut))
    return per_k.sum(dim=-1)


def edge_weights_dense(node_features: torch.Tensor, adj: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """``W[i, j] = adj[i, j]·exp(−‖f_i − f_j‖²/2σ²)`` for ``node_features``
    (..., N, D) and a 0/1 ``adj`` (N, N) or (..., N, N); the squared
    distance from the Gram matrix, clipped at 0."""
    sq = (node_features * node_features).sum(dim=-1)
    gram = torch.einsum("...nd,...md->...nm", node_features, node_features)
    dist_sq = torch.clamp(sq[..., :, None] + sq[..., None, :] - 2.0 * gram, min=0.0)
    return torch.exp(-dist_sq / (2.0 * sigma**2)) * adj.to(node_features.dtype)


def normalized_cut_loss_dense(node_features: torch.Tensor, adj: torch.Tensor, soft_assignments: torch.Tensor,
                              sigma: float = 1.0) -> torch.Tensor:
    """The loss on a dense graph, ``soft_assignments`` (..., N, K) → loss
    per leading batch index: for every edge (i → j) ``cut_k += w_ij·P_ik·(1 −
    P_jk)`` and ``deg_i += w_ij``."""
    w = edge_weights_dense(node_features, adj, sigma)
    p = soft_assignments
    assoc = torch.einsum("...nk,...n->...k", p, w.sum(dim=-1))
    wp = torch.einsum("...nm,...mk->...nk", w, p)
    return _per_segment(assoc - torch.einsum("...nk,...nk->...k", p, wp), assoc)


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
    return _per_segment(cut, assoc)


class SegmentPredictor(nn.Module):
    """Per-node K-way segment logits: a ``num_gnn_layers`` GAT on the
    backend's graph (``gnn_predictor``, hidden width ``hidden_dim`` or the
    input's), or with ``use_gnn=False`` the MLP ``fc1`` → ReLU → ``fc2``
    (hidden width ``hidden_dim`` or twice the input's)."""

    def __init__(self, in_features, num_segments, hidden_dim, num_heads, gen, alpha=0.2, dtype=torch.float32,
                 dropout_rate=0.1, use_gnn=True, num_gnn_layers=1, backend="lattice"):
        super().__init__()
        self.use_gnn = use_gnn
        if use_gnn:
            self.gnn_predictor = GATNetwork(in_features, hidden_dim or in_features, num_segments, num_heads, gen,
                                            num_gnn_layers, alpha, backend, dtype, dropout_rate)
        else:
            hidden = hidden_dim or 2 * in_features
            self.fc1 = Dense(in_features, hidden, gen, dtype)
            self.fc2 = Dense(hidden, num_segments, gen, dtype)

    def forward(self, x: torch.Tensor, adj: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.use_gnn:
            return self.gnn_predictor(x, adj, gen=gen)
        return self.fc2(torch.relu(self.fc1(x)))


class MinCutRefinement(nn.Module):
    """``forward(gat_features, adj=None) → (l_partition, soft_assignments)``
    (``segment_predictor``): on the lattice of a grid ``(..., nph, npw, D)``
    with ``backend="lattice"``, on the graph ``adj`` of nodes ``(..., N,
    D)`` with ``backend="dense"``."""

    def __init__(self, in_features, num_segments, gen, sigma_ncut=1.0, predictor_hidden=None,
                 predictor_heads=1, alpha=0.2, dtype=torch.float32, dropout_rate=0.1, backend="lattice",
                 predictor_use_gnn=True):
        super().__init__()
        self.sigma_ncut = sigma_ncut
        self.backend = backend
        self.segment_predictor = SegmentPredictor(
            in_features, num_segments, predictor_hidden, predictor_heads, gen, alpha, dtype, dropout_rate,
            predictor_use_gnn, 1, backend,
        )

    def forward(self, gat_features: torch.Tensor, adj: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.backend != "lattice" and adj is None:
            raise ValueError("the dense backend needs an adjacency mask")
        with span("graph.mincut"):
            logits = self.segment_predictor(gat_features, adj, gen=gen)
            acc = torch.promote_types(logits.dtype, torch.float32)  # f32, or f64 in an f64 model
            soft = torch.softmax(logits.to(acc), dim=-1)
            if self.backend == "lattice":
                return normalized_cut_loss_lattice(gat_features.to(acc), soft, self.sigma_ncut), soft
            return normalized_cut_loss_dense(gat_features.to(acc), adj, soft, self.sigma_ncut), soft
