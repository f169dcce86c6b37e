"""Large-scene inference. Counterpart of
``mingraph_unet_tpu/parallel/spatial.py``, with its two strategies:

1. :func:`tiled_inference`, on one device: the scene is cut into
   overlapping ``tile + 2·halo`` windows, the network runs batched over
   them, and each window's ``tile``-sized cell is stitched back. Border
   windows sit flush with the scene's edge (clamped starts), so the
   network's own zero padding acts at the true border.
2. :func:`spatial_sharded_apply`, over a mesh: each rank runs the network
   on its H-shard of the whole scene (and its rows of the batch). JAX lets
   XLA insert every conv's halo exchange; PyTorch has no partitioner, so
   the network is handed a :class:`SpatialShard` and exchanges at each
   conv itself (``models/unet.py``: the cuDNN convs through
   ``parallel/halo.py::sharded_conv2d_same``'s exchange, the s2d conv2s
   through K9, the decoder conv1s through K2's sharded entry, the
   windowed encoder conv1 one full-resolution row each way). Pooling, the
   2×2 ConvTranspose, K3 and K5 need no exchange when each shard's height
   is a multiple of the network's downsampling.

Who decides. A :class:`SpatialShard` method makes the exchange its site
needs and hands the rows to the site's op in ``ops/kernels/psconv.py``
(``conv2_s2d_halo``, ``dec_conv1_shard``, ``conv2_s2d_train_shard``),
which picks the kernel or the plain version by the unsharded site's rule.

Spatial-parallel training (:func:`spatial_sharded_unet`): every rank of a
spatial group holds the whole images of its batch rows, runs the U-Net in
train mode on its H rows (the train-mode sites of :class:`SpatialShard`:
each exchange differentiable, ``parallel/halo.py::halo_rows``, and K4 on
the shard, ``psconv_train_halo``, exchanging the cotangent's rows in its
backward), and :func:`gather_spatial` assembles the outputs the rest of
the step reads, differentiably: its backward gives each rank its rows of
the sum of every rank's cotangent.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from mingraph_unet_tpu_torch.ops import s2d as s2d_ops
from mingraph_unet_tpu_torch.ops.conv import conv2d_nhwc
from mingraph_unet_tpu_torch.ops.kernels.psconv import (conv2_s2d_train_shard, dec_conv1_halo_preact, dec_conv1_preact,
                                                        dec_conv1_shard)
from mingraph_unet_tpu_torch.parallel.halo import halo_exchange_rows, halo_rows, sharded_conv2d_same, sharded_psconv
from mingraph_unet_tpu_torch.parallel.mesh import Mesh, shard_batch
from mingraph_unet_tpu_torch.utils.profiling import span

__all__ = ["SpatialShard", "extract_tiles", "gather_rows", "gather_spatial", "spatial_sharded_apply",
           "spatial_sharded_unet", "stitch_tiles", "tiled_inference"]


def _tile_starts(size: int, tile: int, halo: int) -> List[int]:
    """Window starts along one axis, clamped into the scene."""
    win = tile + 2 * halo
    return [max(0, min(t * tile - halo, size - win)) for t in range(-(-size // tile))]


def extract_tiles(scene: torch.Tensor, tile: int, halo: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """NHWC scene → ``(nty·ntx·N, win, win, C)`` windows, tile-major, and
    the grid ``(nty, ntx)``; ``win = tile + 2·halo``. The scene must be at
    least one window on each side; for a pooling network H, W, tile and
    halo are multiples of its downsampling factor. Within the range
    ``mgu.scene.windows``."""
    n, h, w, c = scene.shape
    win = tile + 2 * halo
    if h < win or w < win:
        raise ValueError(f"Scene {h}x{w} smaller than window {win}; run un-tiled instead.")
    ys, xs = _tile_starts(h, tile, halo), _tile_starts(w, tile, halo)
    with span("scene.windows"):
        tiles = torch.stack([scene[:, y0 : y0 + win, x0 : x0 + win] for y0 in ys for x0 in xs])
        return tiles.reshape(len(ys) * len(xs) * n, win, win, c), (len(ys), len(xs))


def stitch_tiles(tile_outputs: torch.Tensor, grid: Tuple[int, int], batch: int, scene_hw: Tuple[int, int],
                 tile: int, halo: int) -> torch.Tensor:
    """Inverse of :func:`extract_tiles` for per-pixel outputs: crop each
    window to its cell (accounting for the clamped placement), lay the
    cells out and trim to the scene. Within the range ``mgu.scene.stitch``."""
    nty, ntx = grid
    h, w = scene_hw
    ys, xs = _tile_starts(h, tile, halo), _tile_starts(w, tile, halo)
    t_out = tile_outputs.reshape(nty, ntx, batch, *tile_outputs.shape[1:])
    with span("scene.stitch"):
        rows = []
        for ty in range(nty):
            oy = ty * tile - ys[ty]  # the cell's offset inside its window
            rows.append(torch.cat([t_out[ty, tx, :, oy : oy + tile, tx * tile - xs[tx] : tx * tile - xs[tx] + tile]
                                   for tx in range(ntx)], dim=2))
        return torch.cat(rows, dim=1)[:, :h, :w]


def tiled_inference(apply_fn: Callable[[torch.Tensor], torch.Tensor], scene: torch.Tensor, tile: int = 512,
                    halo: int = 32, tile_batch: Optional[int] = None) -> torch.Tensor:
    """``apply_fn`` (NHWC → NHWC per-pixel outputs) over a large scene by
    overlapping tiles, ``tile_batch`` windows per call (default all at
    once). Stitched outputs equal the whole-scene ones to float tolerance
    when ``halo`` covers the network's half receptive field and is a
    multiple of its downsampling factor."""
    n, h, w, _ = scene.shape
    tiles, grid = extract_tiles(scene, tile, halo)
    total = tiles.shape[0]
    if tile_batch is None or tile_batch >= total:
        outs = apply_fn(tiles)
    else:
        outs = torch.cat([apply_fn(tiles[s : s + tile_batch]) for s in range(0, total, tile_batch)])
    return stitch_tiles(outs, grid, n, (h, w), tile, halo)


@dataclass(frozen=True)
class SpatialShard:
    """What a network needs to run on one H-shard of a scene: the mesh (its
    spatial group carries the exchanges), this shard's index and the
    scene's full-resolution height. Shards are equal, so at any level of
    the network the shard of a grid of local height h starts at global row
    ``index · h`` of ``count · h``. Its methods are the sharded forms of
    the U-Net's conv sites; each returns this shard's rows of the
    unsharded op."""

    mesh: Mesh
    index: int
    h_global: int

    @property
    def count(self) -> int:
        return self.mesh.spatial_size

    def conv_same(self, x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        """A 'SAME' conv + bias (cuDNN after the exchange)."""
        return sharded_conv2d_same(x, kernel, self.mesh, bias)

    def windowed_down(self, x_full: torch.Tensor, kernel_win: torch.Tensor) -> torch.Tensor:
        """``s2d.conv3x3_windowed_down``: the 4×4 stride-2 window of s2d row
        I reads full-res rows 2I − 1 … 2I + 2, so one row from each
        neighbour (:func:`halo_rows`, differentiable; the unsharded conv on
        a spatial axis of one rank)."""
        if self.count == 1:
            return s2d_ops.conv3x3_windowed_down(x_full, kernel_win)
        top, bottom = halo_rows(x_full, 1, self.mesh)
        return conv2d_nhwc(torch.cat([top, x_full, bottom], dim=1), kernel_win, stride=2, padding=(0, 1))

    def psel(self, x_s2d: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """The s2d conv2 (K1's function): ``sharded_psconv``."""
        return sharded_psconv(x_s2d, kernel, bias, self.mesh)

    def psel_train(self, x_s2d: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
        """The s2d conv2 in training (K4's function: no bias, no ReLU):
        ``conv2_s2d_train_shard``, K4 on the shard with the x rows and, in
        its backward, the cotangent's rows exchanged with the neighbours
        (even on a spatial axis of one rank: no row then, bit-equal to K4);
        else the plain form over the rows of a differentiable exchange, and
        on one rank the unsharded plain conv."""
        return conv2_s2d_train_shard(x_s2d, kernel, lambda t: halo_exchange_rows(t, 1, self.mesh),
                                     lambda t: (None, None) if self.count == 1 else halo_rows(t, 1, self.mesh))

    def dec_conv1(self, x_skip_s2d, x_prev, k_skip, k_prev, t9) -> torch.Tensor:
        """The s2d decoder conv1 (K2's function): one row of both inputs
        exchanged, then ``dec_conv1_shard`` with the shard's global rows
        (K2's sharded entry where the tile takes it, else its plain
        version)."""
        hh = x_skip_s2d.shape[1]
        return dec_conv1_shard(x_skip_s2d, *halo_exchange_rows(x_skip_s2d, 1, self.mesh), x_prev,
                               *halo_exchange_rows(x_prev, 1, self.mesh), k_skip, k_prev, t9, self.index * hh,
                               self.count * hh)

    def dec_conv1_train(self, x_skip_s2d, x_prev, k_skip, k_prev, t9) -> torch.Tensor:
        """The s2d decoder conv1 in training, before its BN (the function of
        ``dec_conv1_preact``): one row of both inputs through a
        differentiable exchange, the bias field's border rows read from the
        shard's global rows; ``dec_conv1_preact`` itself on one rank."""
        if self.count == 1:
            return dec_conv1_preact(x_skip_s2d, x_prev, k_skip, k_prev, t9)
        hh = x_skip_s2d.shape[1]
        return dec_conv1_halo_preact(x_skip_s2d, *halo_rows(x_skip_s2d, 1, self.mesh), x_prev,
                                     *halo_rows(x_prev, 1, self.mesh), k_skip, k_prev, t9, self.index * hh,
                                     self.count * hh)


def spatial_sharded_apply(apply_fn: Callable[..., torch.Tensor], scene: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Whole-scene inference with H sharded over ``mesh``'s spatial axis
    and N over its batch axis: this rank's part of ``scene`` (NHWC, the
    whole scene on every rank) goes through ``apply_fn(x_local,
    spatial=SpatialShard(...))``, which returns this rank's part of a
    per-pixel output; :func:`gather_rows` assembles the whole. H must
    split into equal shards; a network adds its own rule (the U-Net: a
    multiple of 2^(depth + 1) rows a shard)."""
    n, h = scene.shape[:2]
    if h % mesh.spatial_size or n % mesh.batch_size:
        raise ValueError(f"scene {tuple(scene.shape)} does not split into {mesh.batch_size} x {mesh.spatial_size} "
                         f"equal shards")
    x_local = shard_batch(scene, mesh, spatial=True)
    return apply_fn(x_local, spatial=SpatialShard(mesh, mesh.spatial_index, h))


class _Gather(torch.autograd.Function):
    """Every rank's ``x`` concatenated along ``dim`` in rank order over
    ``group``; the backward takes this rank's part of the sum of every
    rank's cotangent (each rank's loss reads the whole). gloo has no
    reduce-scatter, so it is an all-reduce and a slice, on both backends."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, size: int, index: int, dim: int) -> torch.Tensor:
        ctx.group, ctx.index, ctx.dim, ctx.n = group, index, dim, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone(memory_format=torch.contiguous_format)  # the all-reduce writes in place
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, None, None


def gather_spatial(x_local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole images from every spatial rank's H-shard of them (dim 1,
    over the spatial group), on every rank of the group; differentiable.
    ``x_local`` itself on a spatial axis of one rank."""
    if not mesh.distributed or mesh.spatial_size == 1:
        return x_local
    return _Gather.apply(x_local, mesh.spatial_group, mesh.spatial_size, mesh.spatial_index, 1)


def gather_rows(x_local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole output from every rank's shard of it (H over the spatial
    axis, N over the batch axis), on every rank: the inverse of
    :func:`spatial_sharded_apply`'s slicing. Differentiable."""
    x = gather_spatial(x_local, mesh)
    if not mesh.distributed or mesh.batch_size == 1:
        return x
    return _Gather.apply(x, mesh.batch_group, mesh.batch_size, mesh.batch_index, 0)


def spatial_sharded_unet(unet, images: torch.Tensor, mesh: Mesh, level0: bool = False) -> Dict[str, Any]:
    """The train-mode U-Net of a spatial-parallel step. ``images`` (B, H, W,
    C) are the whole images of this rank's batch rows (alike on every rank
    of its spatial group); the U-Net runs on this rank's H rows
    (``unet(x_local, spatial=SpatialShard(...))``: every conv site
    exchanges its rows, BN sums over batch × spatial) and the outputs the
    step reads are gathered over the spatial group (:func:`gather_spatial`).
    Returns the U-Net's output dict with ``logits`` (B, H, W, classes) and,
    with ``level0``, level 0's skip and decoder output (``skip_s2d[0]``,
    ``f_u_s2d[0]`` where level 0 runs in s2d, else ``skips[0]``, ``f_u[0]``),
    the tensors ``models/pipeline.py`` reads from the U-Net. H must split
    into equal shards of a multiple of 2^(depth + 1) rows."""
    h = images.shape[1]
    if h % mesh.spatial_size:
        raise ValueError(f"{h} rows do not split into {mesh.spatial_size} equal shards")
    rows = h // mesh.spatial_size
    x_local = images.narrow(1, mesh.spatial_index * rows, rows)
    u = unet(x_local, spatial=SpatialShard(mesh, mesh.spatial_index, h))
    out: Dict[str, Any] = {"logits": gather_spatial(u["logits"], mesh), "skips": [None], "f_u": [None],
                           "skip_s2d": {}, "f_u_s2d": {}}
    if level0:
        for full, s2d in (("skips", "skip_s2d"), ("f_u", "f_u_s2d")):
            if 0 in u[s2d]:
                out[s2d][0] = gather_spatial(u[s2d][0], mesh)
            else:
                out[full][0] = gather_spatial(u[full][0], mesh)
    return out
