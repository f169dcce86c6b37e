"""Graph attention layers. Counterpart of ``mingraph_unet_tpu/models/gat.py``.

The edge score ``e_ij = LeakyReLU(a·[Wh_i ‖ Wh_j])`` is rank-1 in (i, j):
``e_ij = LeakyReLU(s_src[i] + s_dst[j])`` with ``s_* = Wh·a_*``.
:class:`DenseGAT` masks an (N, N) score matrix; :class:`LatticeGAT` takes
the softmax over the four shifted lattice neighbours. As in the reference,
the softmax subtracts the per-head *global* max over edges and adds 1e-10
to the denominator; nodes without incoming edges aggregate to zero. The
global max is not detached: autograd splits its gradient evenly among ties,
as JAX does. In train mode (``module.train()`` and a ``gen``) dropout acts
on the attention weights and on the layer's output, as the JAX layers'
``attn_dropout`` and ``out_dropout``; it has no parameters.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mingraph_unet_tpu_torch.models import layers
from mingraph_unet_tpu_torch.models.layers import xavier_uniform
from mingraph_unet_tpu_torch.ops import lattice as lattice_ops
from mingraph_unet_tpu_torch.utils.profiling import NO_SPAN, span

__all__ = ["adjacency_from_edge_index", "fully_connected_adjacency", "DenseGAT", "LatticeGAT", "GATNetwork"]


def adjacency_from_edge_index(edge_index, num_nodes: int, device=None) -> torch.Tensor:
    """COO (2, E) edges (row 0 source, row 1 target) → the dense f32 mask
    ``adj[target, source] = 1``; repeated edges count once."""
    ei = torch.as_tensor(np.asarray(edge_index), dtype=torch.long, device=device)
    adj = torch.zeros((num_nodes, num_nodes), device=device)
    adj[ei[1], ei[0]] = 1.0
    return adj


def fully_connected_adjacency(num_nodes: int, device=None) -> torch.Tensor:
    """All-pairs adjacency without self-loops (the K-region graph)."""
    return torch.ones((num_nodes, num_nodes), device=device) - torch.eye(num_nodes, device=device)


class _HeadParams(nn.Module):
    """Per-head ``W (H, in, out)``, ``a_src (H, out)``, ``a_dst (H, out)``,
    Xavier-uniform with gain 1.414 (the reference's fused (1, 2·out) fans
    for the attention vectors)."""

    def __init__(self, in_features: int, head_out: int, num_heads: int, gen: torch.Generator):
        super().__init__()
        gain = 1.414
        self.W = nn.Parameter(xavier_uniform((num_heads, in_features, head_out), gain, in_features, head_out, gen))
        self.a_src = nn.Parameter(xavier_uniform((num_heads, head_out), gain, 2 * head_out, 1, gen))
        self.a_dst = nn.Parameter(xavier_uniform((num_heads, head_out), gain, 2 * head_out, 1, gen))


def leaky_relu(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """``jax.nn.leaky_relu``: at exactly 0 its gradient is 1 (the positive
    branch), where ``F.leaky_relu``'s is ``alpha``."""
    return torch.where(x >= 0, x, alpha * x)


def _head_out(out_features: int, num_heads: int, concat: bool) -> int:
    if not concat:
        return out_features
    if out_features % num_heads:
        raise ValueError("out_features must be divisible by num_heads when concatenating")
    return out_features // num_heads


class DenseGAT(nn.Module):
    """Multi-head GAT over a dense mask: ``x (..., N, D)``, ``adj (N, N)``
    with ``adj[j, i] = 1`` for an edge i→j → (..., out)."""

    def __init__(self, in_features, out_features, num_heads, gen, alpha=0.2, concat=True, dtype=torch.float32,
                 dropout_rate=0.0):
        super().__init__()
        self.heads = _HeadParams(in_features, _head_out(out_features, num_heads, concat), num_heads, gen)
        self.alpha, self.concat, self.dtype, self.dropout_rate = alpha, concat, dtype, dropout_rate

    def forward(self, x: torch.Tensor, adj: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        p = self.heads
        h = torch.einsum("...nd,hdo->...hno", x.to(dt), p.W.to(dt))
        s_src = torch.einsum("...hno,ho->...hn", h, p.a_src.to(dt))
        s_dst = torch.einsum("...hno,ho->...hn", h, p.a_dst.to(dt))
        e = leaky_relu(s_src[..., :, None, :] + s_dst[..., :, :, None], self.alpha)  # (..., H, tgt, src)
        mask = adj.bool()
        mask = mask[None] if mask.dim() == 2 else mask[..., None, :, :]
        e_valid = torch.where(mask, e, torch.full_like(e, float("-inf")))
        gmax = e_valid.amax(dim=(-2, -1), keepdim=True)
        gmax = torch.where(torch.isfinite(gmax), gmax, torch.zeros_like(gmax))
        exp_e = torch.where(mask, torch.exp(e - gmax), torch.zeros_like(e))
        attn = exp_e / (exp_e.sum(dim=-1, keepdim=True) + 1e-10)
        gen = gen if self.training else None
        attn = layers.dropout(attn, self.dropout_rate, gen)
        h_prime = F.elu(torch.einsum("...hji,...hio->...hjo", attn, h))
        if self.concat:
            moved = h_prime.movedim(-3, -2)  # (..., N, H, O)
            out = moved.reshape(*moved.shape[:-2], -1)
        else:
            out = h_prime.mean(dim=-3)
        return layers.dropout(out, self.dropout_rate, gen)


class LatticeGAT(nn.Module):
    """Multi-head GAT over the implicit 4-connected lattice:
    ``x (..., nph, npw, D)`` → ``(..., nph, npw, out)``, O(4N)."""

    def __init__(self, in_features, out_features, num_heads, gen, alpha=0.2, concat=True, dtype=torch.float32,
                 dropout_rate=0.0):
        super().__init__()
        self.heads = _HeadParams(in_features, _head_out(out_features, num_heads, concat), num_heads, gen)
        self.alpha, self.concat, self.dtype, self.dropout_rate = alpha, concat, dtype, dropout_rate

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        p = self.heads
        nph, npw = x.shape[-3], x.shape[-2]
        h = torch.einsum("...rcd,hdo->...hrco", x.to(dt), p.W.to(dt))
        s_src = torch.einsum("...hrco,ho->...hrc", h, p.a_src.to(dt))
        s_dst = torch.einsum("...hrco,ho->...hrc", h, p.a_dst.to(dt))
        nh = torch.stack([lattice_ops.shift(h, dr, dc) for dr, dc in lattice_ops.DIRECTIONS], dim=-2)
        ns = torch.stack(
            [lattice_ops.shift(s_src[..., None], dr, dc)[..., 0] for dr, dc in lattice_ops.DIRECTIONS], dim=-1
        )
        valid = torch.stack(
            [lattice_ops.neighbor_mask(nph, npw, dr, dc, h.dtype, h.device) for dr, dc in lattice_ops.DIRECTIONS],
            dim=-1,
        )
        e = leaky_relu(ns + s_dst[..., None], self.alpha)  # (..., H, nph, npw, 4)
        mask = valid.bool()
        e_valid = torch.where(mask, e, torch.full_like(e, float("-inf")))
        gmax = e_valid.amax(dim=(-3, -2, -1), keepdim=True)  # per head, over grid and directions
        gmax = torch.where(torch.isfinite(gmax), gmax, torch.zeros_like(gmax))
        exp_e = torch.where(mask, torch.exp(e - gmax), torch.zeros_like(e))
        attn = exp_e / (exp_e.sum(dim=-1, keepdim=True) + 1e-10)
        gen = gen if self.training else None
        attn = layers.dropout(attn, self.dropout_rate, gen)
        h_prime = F.elu(torch.einsum("...rck,...rcko->...rco", attn, nh))  # (..., H, nph, npw, O)
        if self.concat:
            moved = h_prime.movedim(-4, -2)  # (..., nph, npw, H, O)
            out = moved.reshape(*moved.shape[:-2], -1)
        else:
            out = h_prime.mean(dim=-4)
        return layers.dropout(out, self.dropout_rate, gen)


class GATNetwork(nn.Module):
    """Stacked GAT (``layer{i}``): one layer → a single averaging layer to
    ``output_dim``; more → concat layers at ``hidden_dim`` then an averaging
    layer. ``backend`` is ``"lattice"`` (grid input) or ``"dense"``
    (``forward(x, adj)``); every layer drops at ``dropout_rate`` in train
    mode, drawing from the ``gen`` given to :meth:`forward`. ``span``
    names the forward's range (``utils/profiling.py::span``); None opens
    none, for a network nested in a named range (the MinCut segment
    predictor, inside ``mgu.graph.mincut``)."""

    def __init__(self, in_features, hidden_dim, output_dim, num_heads, gen, num_layers=1,
                 alpha=0.2, backend="dense", dtype=torch.float32, dropout_rate=0.1, span=None):
        super().__init__()
        cls = LatticeGAT if backend == "lattice" else DenseGAT
        self.backend = backend
        self.num_layers = num_layers
        self.span = span
        dims = [(in_features, output_dim, False)] if num_layers == 1 else (
            [(in_features, hidden_dim, True)]
            + [(hidden_dim, hidden_dim, True)] * (num_layers - 2)
            + [(hidden_dim, output_dim, False)]
        )
        for i, (din, dout, concat) in enumerate(dims):
            self.add_module(f"layer{i}", cls(din, dout, num_heads, gen, alpha, concat, dtype, dropout_rate))

    def forward(self, x: torch.Tensor, adj: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.backend == "dense" and adj is None:
            raise ValueError("the dense backend needs an adjacency mask")
        with span(self.span) if self.span is not None else NO_SPAN:
            for i in range(self.num_layers):
                layer = getattr(self, f"layer{i}")
                x = layer(x, gen=gen) if self.backend == "lattice" else layer(x, adj, gen=gen)
        return x
