"""Large-scene tiled inference with halo overlap. Counterpart of
``mingraph_unet_tpu/parallel/spatial.py`` on one device: the scene is cut
into overlapping ``tile + 2·halo`` windows, the network runs batched over
them, and each window's ``tile``-sized cell is stitched back. Border
windows sit flush with the scene's edge (clamped starts), so the network's
own zero padding acts at the true border. The mesh-sharded whole-scene
apply (``spatial_sharded_apply``) waits for the multi-GPU slice.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

__all__ = ["extract_tiles", "stitch_tiles", "tiled_inference"]


def _tile_starts(size: int, tile: int, halo: int) -> List[int]:
    """Window starts along one axis, clamped into the scene."""
    win = tile + 2 * halo
    return [max(0, min(t * tile - halo, size - win)) for t in range(-(-size // tile))]


def extract_tiles(scene: torch.Tensor, tile: int, halo: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """NHWC scene → ``(nty·ntx·N, win, win, C)`` windows, tile-major, and
    the grid ``(nty, ntx)``; ``win = tile + 2·halo``. The scene must be at
    least one window on each side; for a pooling network H, W, tile and
    halo are multiples of its downsampling factor."""
    n, h, w, c = scene.shape
    win = tile + 2 * halo
    if h < win or w < win:
        raise ValueError(f"Scene {h}x{w} smaller than window {win}; run un-tiled instead.")
    ys, xs = _tile_starts(h, tile, halo), _tile_starts(w, tile, halo)
    tiles = torch.stack([scene[:, y0 : y0 + win, x0 : x0 + win] for y0 in ys for x0 in xs])
    return tiles.reshape(len(ys) * len(xs) * n, win, win, c), (len(ys), len(xs))


def stitch_tiles(tile_outputs: torch.Tensor, grid: Tuple[int, int], batch: int, scene_hw: Tuple[int, int],
                 tile: int, halo: int) -> torch.Tensor:
    """Inverse of :func:`extract_tiles` for per-pixel outputs: crop each
    window to its cell (accounting for the clamped placement), lay the
    cells out and trim to the scene."""
    nty, ntx = grid
    h, w = scene_hw
    ys, xs = _tile_starts(h, tile, halo), _tile_starts(w, tile, halo)
    t_out = tile_outputs.reshape(nty, ntx, batch, *tile_outputs.shape[1:])
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
