"""Explicit halo exchange over the mesh's ``spatial`` axis. Counterpart of
``mingraph_unet_tpu/parallel/halo.py``.

An H-sharded NHWC tensor lives on the ranks of a spatial group, shard i
holding rows ``[i·h, (i+1)·h)``. A 'SAME' conv of height kh needs kh // 2
rows of each neighbour: :func:`halo_exchange_rows` sends this shard's top
rows up and its bottom rows down with one ``batch_isend_irecv`` over the
spatial group and returns what arrived, None at the global top and bottom.
The callers decide what to do with the rows: :func:`sharded_conv2d_same`
concatenates them (zeros at a global border) and runs a VALID-in-H conv;
:func:`sharded_psconv` hands them to the sharded psel kernel (K9), which
stages them in place of its zero padding, with no concat.

:func:`halo_rows` is the exchange under autograd (JAX differentiates its
``ppermute`` into the reverse ``ppermute``): its backward sends each halo
row's cotangent back to the rank the row came from, which adds it into the
shard's first or last rows. Every rank of the group runs it, a border rank
too (zeros for the missing side), so that the ranks' backward passes issue
the same exchanges in the same order.

The functions run inside each rank's program (JAX's ``shard_map`` body):
they take and return this rank's shard.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from mingraph_unet_tpu_torch.ops.conv import conv2d_nhwc
from mingraph_unet_tpu_torch.ops.kernels.psconv import conv2_s2d_halo
from mingraph_unet_tpu_torch.parallel.mesh import Mesh

__all__ = ["halo_exchange_rows", "halo_rows", "sharded_conv2d_same", "sharded_psconv"]

Rows = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


def _exchange(up: Optional[torch.Tensor], down: Optional[torch.Tensor], mesh: Mesh) -> Rows:
    """Send ``up`` to the shard above and ``down`` to the shard below, in one
    ``batch_isend_irecv``; returns what the shard above and the shard below
    sent (tensors shaped as ``up`` / ``down``), None at the global top /
    bottom, where nothing is sent."""
    n, idx = mesh.spatial_size, mesh.spatial_index
    group, ranks = mesh.spatial_group, mesh.spatial_ranks
    empty = lambda like: torch.empty(like.shape, dtype=like.dtype, device=like.device)  # noqa: E731
    from_above = empty(down) if idx > 0 else None
    from_below = empty(up) if idx < n - 1 else None
    if from_above is None and from_below is None:
        return None, None
    ops = []
    if from_above is not None:  # trade rows with the shard above
        ops += [dist.P2POp(dist.isend, up.contiguous(), ranks[idx - 1], group),
                dist.P2POp(dist.irecv, from_above, ranks[idx - 1], group)]
    if from_below is not None:  # and with the shard below
        ops += [dist.P2POp(dist.isend, down.contiguous(), ranks[idx + 1], group),
                dist.P2POp(dist.irecv, from_below, ranks[idx + 1], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_above, from_below


def halo_exchange_rows(x_local: torch.Tensor, halo: int, mesh: Mesh) -> Rows:
    """``(top, bottom)``: the ``halo`` rows (B, halo, W, C) just above this
    H-shard (the upper neighbour's bottom rows) and just below it (the
    lower neighbour's top rows); None at the global top / bottom and on a
    spatial axis of one rank. No gradient flows through it."""
    if mesh.spatial_size == 1 or halo == 0:
        return None, None
    if x_local.shape[1] < halo:
        raise ValueError(f"a shard of {x_local.shape[1]} rows cannot give a halo of {halo}")
    x_local = x_local.detach()
    return _exchange(x_local[:, :halo], x_local[:, -halo:], mesh)


class _HaloRows(torch.autograd.Function):
    """(top, bottom) halo rows, zeros at a global border; the backward is
    the exchange's transpose."""

    @staticmethod
    def forward(ctx, x_local: torch.Tensor, halo: int, mesh: Mesh):
        ctx.halo, ctx.mesh, ctx.x_shape = halo, mesh, x_local.shape
        top, bottom = halo_exchange_rows(x_local, halo, mesh)
        zeros = lambda: x_local.new_zeros((x_local.shape[0], halo) + tuple(x_local.shape[2:]))  # noqa: E731
        return zeros() if top is None else top, zeros() if bottom is None else bottom

    @staticmethod
    def backward(ctx, g_top: torch.Tensor, g_bottom: torch.Tensor):
        # g_top belongs to the shard above (its last rows), g_bottom to the
        # shard below (its first rows); what they send back belongs to ours.
        halo = ctx.halo
        from_above, from_below = _exchange(g_top, g_bottom, ctx.mesh)
        dx = g_top.new_zeros(ctx.x_shape)
        if from_above is not None:
            dx[:, :halo] += from_above
        if from_below is not None:
            dx[:, -halo:] += from_below
        return dx, None, None


def halo_rows(x_local: torch.Tensor, halo: int, mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`halo_exchange_rows` under autograd: ``(top, bottom)``, zeros
    for a global border (and both zeros on a spatial axis of one rank).
    The cotangents of the two rows go back to the ranks they came from
    and are added into the first / last ``halo`` rows of their shards'
    gradients: the transpose of the exchange, as JAX's ``ppermute``
    transposes to the reverse ``ppermute``. Every rank of the spatial group
    must call it, in the same order."""
    return _HaloRows.apply(x_local, halo, mesh)


def sharded_conv2d_same(x_local: torch.Tensor, kernel: torch.Tensor, mesh: Mesh,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """'SAME' 2D conv (any odd kernel, (kh, kw, Cin, Cout) HWIO, optional
    bias) of an H-sharded NHWC tensor: ``kh // 2`` rows exchanged
    (:func:`halo_rows`, so it is differentiable in x, the kernel and the
    bias), zeros at the global borders, then a conv that is VALID in H and
    'SAME' in W (on a spatial axis of one rank, the 'SAME' conv itself).
    Returns this shard's rows of the unsharded conv."""
    kh, kw = kernel.shape[:2]
    halo = kh // 2
    if mesh.spatial_size == 1 or halo == 0:
        return conv2d_nhwc(x_local, kernel, bias, padding=(halo, kw // 2))
    top, bottom = halo_rows(x_local, halo, mesh)
    return conv2d_nhwc(torch.cat([top, x_local, bottom], dim=1), kernel, bias, padding=(0, kw // 2))


def sharded_psconv(x_s2d_local: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, mesh: Mesh,
                   relu: bool = True) -> torch.Tensor:
    """The phase-select s2d conv (+ bias, ReLU when ``relu``) of an
    H-sharded s2d tensor (B, Hh_local, Ww, 4·Cin): one s2d row exchanged
    with each neighbour, then ``ops/kernels/psconv.py::conv2_s2d_halo`` on
    the shard (K9 where the rule of the unsharded K1 site takes it, else
    its plain version).
    ``kernel`` is the full-res (3, 3, Cin, Cout) HWIO kernel and ``bias``
    (Cout,), as ``psel_conv3x3`` takes them. The batch axis needs no
    communication: the conv is per image. Inference only (K9 has no
    backward); training takes ``parallel/spatial.py::SpatialShard.psel_train``."""
    top, bottom = halo_exchange_rows(x_s2d_local, 1, mesh)
    return conv2_s2d_halo(x_s2d_local, top, bottom, kernel, bias, relu)
