"""4-connected patch-lattice helpers. Counterpart of
``mingraph_unet_tpu/ops/lattice.py``: a node's incoming neighbours are its
four grid neighbours, so message passing is four shifted maps plus
validity masks."""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["DIRECTIONS", "shift", "neighbor_mask"]

# Incoming-neighbour offsets (dr, dc): the neighbour at (r+dr, c+dc) sends a
# message to (r, c). Order: up, down, left, right.
DIRECTIONS: Tuple[Tuple[int, int], ...] = ((-1, 0), (1, 0), (0, -1), (0, 1))


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
