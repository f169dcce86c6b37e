"""4-connected patch-lattice helpers. Counterpart of
``mingraph_unet_tpu/ops/lattice.py``: a node's incoming neighbours are its
four grid neighbours, so message passing is four shifted maps plus
validity masks. :func:`lattice_edge_index` gives the same graph as a COO
edge list (for the dense graph forms)."""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

__all__ = ["DIRECTIONS", "lattice_edge_index", "shift", "neighbor_mask"]

# Incoming-neighbour offsets (dr, dc): the neighbour at (r+dr, c+dc) sends a
# message to (r, c). Order: up, down, left, right.
DIRECTIONS: Tuple[Tuple[int, int], ...] = ((-1, 0), (1, 0), (0, -1), (0, 1))


@lru_cache(maxsize=None)
def lattice_edge_index(nph: int, npw: int) -> np.ndarray:
    """COO (2, E) int32 edges of the 4-connected lattice, row 0 the source
    and row 1 the target: both directions of each neighbour pair, right
    pair then down pair, row-major (the reference's order)."""
    edges = []
    for r in range(nph):
        for c in range(npw):
            idx = r * npw + c
            if c + 1 < npw:
                edges += [(idx, idx + 1), (idx + 1, idx)]
            if r + 1 < nph:
                edges += [(idx, idx + npw), (idx + npw, idx)]
    if not edges:
        return np.zeros((2, 0), dtype=np.int32)
    return np.asarray(edges, dtype=np.int32).T.copy()


def neighbor_mask(
    nph: int, npw: int, dr: int, dc: int, dtype=torch.float32, device=None
) -> torch.Tensor:
    """(nph, npw) mask: 1 where a neighbour at offset (dr, dc) exists."""
    m = torch.ones((nph, npw), dtype=dtype, device=device)
    if dr == -1:
        m[0, :] = 0
    elif dr == 1:
        m[-1, :] = 0
    if dc == -1:
        m[:, 0] = 0
    elif dc == 1:
        m[:, -1] = 0
    return m


def shift(x: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """Shift a grid ``(..., nph, npw, C)`` so that (r, c) holds the value
    from (r+dr, c+dc); entries from outside the grid are zero."""
    h_axis, w_axis = x.dim() - 3, x.dim() - 2
    out = x
    if dr:
        out = torch.roll(out, -dr, dims=h_axis)
    if dc:
        out = torch.roll(out, -dc, dims=w_axis)
    mask = neighbor_mask(x.shape[h_axis], x.shape[w_axis], dr, dc, x.dtype, x.device)
    return out * mask[..., None]
