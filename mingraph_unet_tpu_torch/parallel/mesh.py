"""The (dcn, data, spatial) process mesh over ``torch.distributed``.
Counterpart of ``mingraph_unet_tpu/parallel/mesh.py``.

Axes, outermost first, as in JAX:
- ``dcn``: the outer part of the batch axis (multi-node data parallelism);
- ``data``: batch data parallelism; together with ``dcn`` it is one batch
  axis of dcn × data ranks, whose process group all-reduces gradients and
  the batch statistics;
- ``spatial``: H-axis sharding of the image, whose process group carries
  the convs' halo exchange (``parallel/halo.py``).

The caller initializes ``torch.distributed`` (``init_process_group``, as
``torchrun`` does): NCCL on cards, ``gloo`` on the CPU. Rank r sits at
``(dcn, data, spatial) = unravel(r, (dcn, data, spatial))``, the order of
JAX's ``devices.reshape(dcn, data, spatial)``. Without an initialized
process group only the trivial 1×1×1 mesh exists; it has no groups, and
:func:`shard_batch` and :func:`replicate` do nothing with it. With one, the
mesh always has its groups, of one rank each at world size 1. There the
all-reduces and broadcasts of data-parallel training run (over one rank),
but the halo exchange and ``gather_rows``' all-gather do not: an axis of
one rank has no neighbour and nothing to gather, so they need two or more
ranks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["Mesh", "make_mesh", "shard_batch", "replicate"]

@dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: the axis sizes, its coordinates, and
    its two process groups (None on the trivial mesh without
    ``torch.distributed``) with their members' global ranks in axis order."""

    shape: Tuple[int, int, int]                  # (dcn, data, spatial)
    coords: Tuple[int, int, int]                 # this rank's (dcn, data, spatial)
    batch_group: Optional[Any] = None            # the ranks of this spatial index: dcn × data
    spatial_group: Optional[Any] = None          # the ranks of this batch index, spatial order
    batch_ranks: Tuple[int, ...] = (0,)
    spatial_ranks: Tuple[int, ...] = (0,)

    @property
    def batch_size(self) -> int:
        """Ranks along the batch axis (dcn × data)."""
        return self.shape[0] * self.shape[1]

    @property
    def batch_index(self) -> int:
        return self.coords[0] * self.shape[1] + self.coords[1]

    @property
    def spatial_size(self) -> int:
        return self.shape[2]

    @property
    def spatial_index(self) -> int:
        return self.coords[2]

    @property
    def trivial(self) -> bool:
        return self.shape == (1, 1, 1)

    @property
    def distributed(self) -> bool:
        """Whether the mesh has process groups (``torch.distributed`` was
        initialized when it was made)."""
        return self.batch_group is not None


def make_mesh(data_parallel: int = 1, spatial_parallel: int = 1, dcn_parallel: int = 1) -> Mesh:
    """Build the (dcn, data, spatial) mesh over the initialized process
    group. ``data_parallel=0`` means all remaining ranks. Raises
    ``ValueError`` when the mesh needs more ranks than exist (one without
    ``torch.distributed``) or leaves ranks out of it. Every rank must call
    it, with the same arguments: it creates every group of the mesh."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    dcn = max(1, dcn_parallel)
    spatial = max(1, spatial_parallel)
    data = data_parallel if data_parallel > 0 else world // spatial // dcn
    need = dcn * data * spatial
    if need > world or data < 1:
        raise ValueError(f"Mesh {dcn}x{data}x{spatial} needs {need} ranks, only {world} available"
                         + ("" if initialized else " (torch.distributed is not initialized)"))
    if need < world:
        raise ValueError(f"Mesh {dcn}x{data}x{spatial} uses {need} of the {world} ranks; every rank must be on it")
    shape = (dcn, data, spatial)
    if not initialized:
        return Mesh(shape, (0, 0, 0))
    rank = dist.get_rank()
    coords = (rank // (data * spatial), rank // spatial % data, rank % spatial)
    batch_group = spatial_group = None
    batch_ranks = spatial_ranks = ()
    # new_group is collective: every rank creates every group, in one order.
    for s in range(spatial):
        ranks = tuple(b * spatial + s for b in range(dcn * data))
        group = dist.new_group(list(ranks))
        if s == coords[2]:
            batch_group, batch_ranks = group, ranks
    for b in range(dcn * data):
        ranks = tuple(b * spatial + s for s in range(spatial))
        group = dist.new_group(list(ranks))
        if b == coords[0] * data + coords[1]:
            spatial_group, spatial_ranks = group, ranks
    return Mesh(shape, coords, batch_group, spatial_group, batch_ranks, spatial_ranks)


def _slice(x: torch.Tensor, dim: int, index: int, count: int, what: str) -> torch.Tensor:
    if x.shape[dim] % count:
        raise ValueError(f"{what} {x.shape[dim]} (dim {dim}) does not divide over {count} ranks")
    n = x.shape[dim] // count
    return x.narrow(dim, index * n, n)


def shard_batch(x: torch.Tensor, mesh: Mesh, spatial: bool = False) -> torch.Tensor:
    """This rank's part of a global NHWC batch: its rows of N (over the
    batch axis, dcn × data) and, with ``spatial``, its rows of H (over the
    spatial axis). The global batch itself on the trivial mesh."""
    if mesh.trivial:
        return x
    x = _slice(x, 0, mesh.batch_index, mesh.batch_size, "batch")
    if spatial and mesh.spatial_size > 1:
        x = _slice(x, 1, mesh.spatial_index, mesh.spatial_size, "height")
    return x


def replicate(tree, mesh: Mesh):
    """Broadcast a module's parameters and buffers, or a tensor, or a list,
    tuple or dict of tensors, from global rank 0 to every rank, in place;
    returns ``tree``. Nothing on a mesh without process groups."""
    if not mesh.distributed:
        return tree
    if isinstance(tree, nn.Module):
        tensors = [t.data for t in tree.parameters()] + list(tree.buffers())
    elif isinstance(tree, torch.Tensor):
        tensors = [tree]
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    else:
        tensors = list(tree)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0)
    return tree
