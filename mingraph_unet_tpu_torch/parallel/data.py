"""Data-parallel training over the mesh's batch axis (dcn × data), and
spatial-parallel training over its spatial axis.

In JAX the sharded train step is the one-device step on the global batch:
XLA partitions it and inserts the reductions. Here each rank runs its own
step on its slice of the global batch, and this module makes that step the
global one:

- :class:`AllReduceSum` is an all-reduce (over one or more groups in turn)
  whose backward all-reduces the cotangent the same way. Train-mode
  BatchNorm sums its Σz, Σz² through it, so the statistics and their
  gradient are those of the global batch.
- **The loss rule, in one place.** Inside :func:`data_parallel` every loss
  returns this rank's *contribution*: its part of the global loss, such
  that the contributions of all ranks sum to the one-process loss
  (:func:`batch_mean` divides a sum over this rank's rows by the global
  count; :func:`global_count` gives a denominator such as the number of
  valid objects over all ranks; :func:`replicated` gives a term every rank
  holds, such as the uncertainty balancer's ``s/2``, its 1/ranks share).
  The gradient of the global loss is then the SUM over ranks of each
  rank's gradient: :func:`all_reduce_gradients` sums, it does not average,
  and :func:`all_reduce_metrics` sums the contributions into the global
  values that are logged.
- **Spatial ranks.** On a mesh with a spatial axis of S ranks, every rank
  of a spatial group holds the same images; only the U-Net runs on its H
  rows (``parallel/spatial.py::spatial_sharded_unet``), and what follows
  its gathered outputs runs replicated over the group. Each rank's
  contribution is then also multiplied by 1/S (:func:`spatial_share`), and
  :func:`all_reduce_gradients` sums over the spatial group and then the
  batch group. BatchNorm inside :func:`spatial_norm` (the U-Net's, which
  sees H-shards) sums its statistics over batch × spatial; outside it (the
  heads', which see whole images) over the batch group only. The logged
  values are summed over the batch group only: the spatial ranks hold
  them alike.
- Random draws over the batch (augmentation, dropout) are drawn for the
  whole global batch from one generator seeded alike on every rank, and
  each rank keeps its rows (:func:`local_rows`): the one-process step's
  draws, bit for bit.

Outside :func:`data_parallel` (or on a mesh without process groups) every
helper is the one-process operation.
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Dict, Iterable, Iterator, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from mingraph_unet_tpu_torch.parallel.mesh import Mesh

__all__ = ["AllReduceSum", "BatchShard", "active", "all_reduce_gradients", "all_reduce_metrics", "all_reduce_sum",
           "batch_mean", "data_parallel", "global_batch", "global_count", "local_rows", "norm_context", "norm_groups",
           "replicated", "restored", "spatial_norm", "spatial_share"]


class BatchShard(NamedTuple):
    """This rank's rows of the global batch: ``local`` images from
    ``index · local`` of ``count · local``, reduced over ``group``; the
    ``spatial_count`` ranks of its spatial group hold them alike."""

    group: Any
    index: int
    count: int
    local: int
    spatial_count: int = 1

    @property
    def total(self) -> int:
        return self.count * self.local

    @property
    def start(self) -> int:
        return self.index * self.local


# The enclosing data_parallel's shard: a context variable, so that the
# step's BatchNorm, dropout and losses see it without a parameter threaded
# through every module, and another thread's work does not.
_shard: ContextVar[Optional[BatchShard]] = ContextVar("batch_shard", default=None)
# The enclosing spatial_norm's (spatial group, ranks): BatchNorm inside it
# sees one H-shard of each image.
_spatial: ContextVar[Optional[Tuple[Any, int]]] = ContextVar("spatial_norm", default=None)


def active() -> Optional[BatchShard]:
    """The batch shard of the enclosing :func:`data_parallel`, or None."""
    return _shard.get()


@contextmanager
def data_parallel(mesh: Optional[Mesh], local_batch: int) -> Iterator[Optional[BatchShard]]:
    """Within: train-mode BatchNorm, dropout and the losses act on the
    global batch of ``mesh``'s batch axis, this rank holding
    ``local_batch`` images of it. Nothing changes for a mesh without
    process groups (or None)."""
    if mesh is None or not mesh.distributed:
        yield None
        return
    shard = BatchShard(mesh.batch_group, mesh.batch_index, mesh.batch_size, local_batch, mesh.spatial_size)
    token = _shard.set(shard)
    try:
        yield shard
    finally:
        _shard.reset(token)


@contextmanager
def spatial_norm(mesh: Optional[Mesh]) -> Iterator[None]:
    """Within: train-mode BatchNorm sees one H-shard of each image, so it
    sums its statistics over ``mesh``'s spatial group too (the sharded
    U-Net's forward). Nothing changes for a spatial axis of one rank or a
    mesh without process groups."""
    if mesh is None or not mesh.distributed or mesh.spatial_size == 1:
        yield
        return
    token = _spatial.set((mesh.spatial_group, mesh.spatial_size))
    try:
        yield
    finally:
        _spatial.reset(token)


def norm_groups() -> Tuple[Tuple[Any, ...], int]:
    """The groups train-mode BatchNorm sums its statistics over, in order
    (the spatial group inside :func:`spatial_norm`, then the batch group
    inside :func:`data_parallel`), and the number of equal parts the
    statistics' batch is cut into; ``((), 1)`` in one process."""
    groups, count = [], 1
    spatial, shard = _spatial.get(), _shard.get()
    if spatial is not None:
        groups.append(spatial[0])
        count *= spatial[1]
    if shard is not None:
        groups.append(shard.group)
        count *= shard.count
    return tuple(groups), count


NormContext = Tuple[Optional[BatchShard], Optional[Tuple[Any, int]]]


def norm_context() -> NormContext:
    """The enclosing :func:`data_parallel` shard and :func:`spatial_norm`
    group, as :func:`restored` takes them back: a rematerialized block's
    recompute runs in the backward, outside those contexts and on the
    autograd engine's thread, and must see the groups its forward saw."""
    return _shard.get(), _spatial.get()


@contextmanager
def restored(ctx: NormContext) -> Iterator[None]:
    """Within: the shard and spatial group of :func:`norm_context`'s
    ``ctx``, whatever encloses this."""
    shard, spatial = ctx
    t_shard, t_spatial = _shard.set(shard), _spatial.set(spatial)
    try:
        yield
    finally:
        _spatial.reset(t_spatial)
        _shard.reset(t_shard)


class AllReduceSum(torch.autograd.Function):
    """``y = Σ_ranks x`` over ``groups`` (one all-reduce each, in order);
    the backward is the same all-reduces of the cotangent, since every
    rank's loss reads y: ∂L/∂x_r = Σ_r' ∂ℓ_r'/∂y."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, groups) -> torch.Tensor:
        ctx.groups = groups
        y = x.clone()
        for group in groups:
            dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone()
        for group in ctx.groups:
            dist.all_reduce(g, group=group)
        return g, None


def all_reduce_sum(x: torch.Tensor, *groups) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``groups`` (all of
    them: over one group, then the next)."""
    return AllReduceSum.apply(x, groups)


def global_batch(local: int) -> int:
    """The global batch size, ``local`` outside :func:`data_parallel`."""
    shard = _shard.get()
    return local if shard is None else shard.total


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x``'s elements over the global batch (x holds this
    rank's rows of a tensor whose every element counts once): this rank's
    contribution, its sum over the global element count."""
    shard = _shard.get()
    if shard is None:
        return x.mean()
    return x.sum() / (x.numel() * shard.count)


def global_count(n: torch.Tensor) -> torch.Tensor:
    """A count (no gradient) summed over the batch axis."""
    shard = _shard.get()
    if shard is None:
        return n
    n = n.detach().clone()
    dist.all_reduce(n, group=shard.group)
    return n


def replicated(v):
    """A loss term that every rank holds whole: its share, 1/ranks of it,
    so that the contributions sum to it once."""
    shard = _shard.get()
    return v if shard is None else v / shard.count


def spatial_share(v):
    """A rank's contribution to the loss it backpropagates: 1/S of its
    batch contribution ``v``, the S ranks of its spatial group holding ``v``
    alike (``v`` itself without a spatial axis)."""
    shard = _shard.get()
    return v if shard is None else v / shard.spatial_count


def local_rows(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """This rank's rows (along dim 0) of a draw made for the global batch."""
    shard = _shard.get()
    if t is None or shard is None:
        return t
    return t[shard.start : shard.start + shard.local]


def _outside(name: str) -> None:
    """Refuse a reduction of the step's results inside :func:`data_parallel`,
    where the values it is given are one rank's contributions still being
    made (a loss there is not yet the loss)."""
    if _shard.get() is not None:
        raise RuntimeError(f"{name} must be called after the data_parallel context of the step, not inside it")


def all_reduce_gradients(params: Iterable[torch.nn.Parameter], mesh: Optional[Mesh]) -> None:
    """Sum every parameter's ``.grad`` over the spatial axis (where it has
    more than one rank) and then the batch axis, in one flat all-reduce a
    group (the loss rule above makes the sum the global gradient). Each
    ``.grad`` becomes a view of the reduced buffer, with no copy back.
    Called after the step's :func:`data_parallel` context."""
    _outside("all_reduce_gradients")
    if mesh is None or not mesh.distributed:
        return
    params = [p for p in params if p.grad is not None]
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    if mesh.spatial_size > 1:
        dist.all_reduce(flat, group=mesh.spatial_group)
    dist.all_reduce(flat, group=mesh.batch_group)
    off = 0
    for p in params:
        n = p.grad.numel()
        p.grad = flat[off : off + n].view_as(p.grad)
        off += n


def all_reduce_metrics(metrics: Dict[str, torch.Tensor], mesh: Optional[Mesh],
                       keys: Optional[Iterable[str]] = None) -> Dict[str, torch.Tensor]:
    """The global values of loss contributions: ``metrics[k]`` summed over
    the batch axis for each k of ``keys`` (default all), the rest as they
    are (values every rank holds alike; so are all of them over the
    spatial axis). Called after the step's :func:`data_parallel` context."""
    _outside("all_reduce_metrics")
    if mesh is None or not mesh.distributed:
        return metrics
    keys = list(metrics) if keys is None else [k for k in keys if k in metrics]
    vec = torch.stack([metrics[k].detach().to(torch.float64) for k in keys])
    dist.all_reduce(vec, group=mesh.batch_group)
    out = dict(metrics)
    for k, v in zip(keys, vec.unbind()):
        out[k] = v.to(metrics[k].dtype)
    return out
