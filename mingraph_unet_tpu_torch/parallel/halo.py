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

The functions run inside each rank's program (JAX's ``shard_map`` body):
they take and return this rank's shard.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from mingraph_unet_tpu_torch.ops.conv import conv2d_nhwc
from mingraph_unet_tpu_torch.ops.kernels.psconv import (extend_rows, psel_conv3x3_halo, psel_conv3x3_halo_plain,
                                                        psel_fits)
from mingraph_unet_tpu_torch.parallel.mesh import Mesh

__all__ = ["halo_exchange_rows", "sharded_conv2d_same", "sharded_psconv"]

Rows = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


def halo_exchange_rows(x_local: torch.Tensor, halo: int, mesh: Mesh) -> Rows:
    """``(top, bottom)``: the ``halo`` rows (B, halo, W, C) just above this
    H-shard (the upper neighbour's bottom rows) and just below it (the
    lower neighbour's top rows); None at the global top / bottom and on a
    spatial axis of one rank."""
    n, idx = mesh.spatial_size, mesh.spatial_index
    if n == 1 or halo == 0:
        return None, None
    if x_local.shape[1] < halo:
        raise ValueError(f"a shard of {x_local.shape[1]} rows cannot give a halo of {halo}")
    shape = (x_local.shape[0], halo) + tuple(x_local.shape[2:])
    top = torch.empty(shape, dtype=x_local.dtype, device=x_local.device) if idx > 0 else None
    bottom = torch.empty(shape, dtype=x_local.dtype, device=x_local.device) if idx < n - 1 else None
    group, ranks = mesh.spatial_group, mesh.spatial_ranks
    ops = []
    if top is not None:  # trade rows with the shard above
        ops += [dist.P2POp(dist.isend, x_local[:, :halo].contiguous(), ranks[idx - 1], group),
                dist.P2POp(dist.irecv, top, ranks[idx - 1], group)]
    if bottom is not None:  # and with the shard below
        ops += [dist.P2POp(dist.isend, x_local[:, -halo:].contiguous(), ranks[idx + 1], group),
                dist.P2POp(dist.irecv, bottom, ranks[idx + 1], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return top, bottom


def sharded_conv2d_same(x_local: torch.Tensor, kernel: torch.Tensor, mesh: Mesh,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """'SAME' 2D conv (any odd kernel, (kh, kw, Cin, Cout) HWIO, optional
    bias) of an H-sharded NHWC tensor: ``kh // 2`` rows exchanged, zeros at
    the global borders, then a conv that is VALID in H and 'SAME' in W (on
    a spatial axis of one rank, the 'SAME' conv itself). Returns this
    shard's rows of the unsharded conv."""
    kh, kw = kernel.shape[:2]
    halo = kh // 2
    top, bottom = halo_exchange_rows(x_local, halo, mesh)
    if top is None and bottom is None:
        return conv2d_nhwc(x_local, kernel, bias, padding=(halo, kw // 2))
    return conv2d_nhwc(extend_rows(x_local, top, bottom, halo), kernel, bias, padding=(0, kw // 2))


def sharded_psconv(x_s2d_local: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, mesh: Mesh,
                   relu: bool = True) -> torch.Tensor:
    """The phase-select s2d conv (+ bias, ReLU when ``relu``) of an
    H-sharded s2d tensor (B, Hh_local, Ww, 4·Cin): one s2d row exchanged
    with each neighbour, then K9 (``psel_conv3x3_halo``) on the shard where
    :func:`psel_fits` accepts the widths (the rule of the unsharded K1
    site), else its plain version; the plain version on the CPU.
    ``kernel`` is the full-res (3, 3, Cin, Cout) HWIO kernel and ``bias``
    (Cout,), as ``psel_conv3x3`` takes them. The batch axis needs no
    communication: the conv is per image."""
    top, bottom = halo_exchange_rows(x_s2d_local, 1, mesh)
    fits = psel_fits(x_s2d_local.dtype, kernel.shape[2], kernel.shape[3])
    return (psel_conv3x3_halo if fits else psel_conv3x3_halo_plain)(x_s2d_local, top, bottom, kernel, bias, relu)
