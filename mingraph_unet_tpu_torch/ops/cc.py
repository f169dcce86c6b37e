"""Connected components of binary masks and the largest-instance masks,
batched over the leading axis. Counterpart of ``mingraph_unet_tpu/ops/cc.py``
(which vmaps its per-image functions); same labels and masks, bit for bit.

Labels: background −1, every 4-connected component labelled by the minimum
linear index (``y·W + x``) of its pixels.

- :func:`label_components_stencil` (the train step's form): ``num_iters``
  sweeps of 4-neighbour min propagation, exact for components of geodesic
  diameter ≤ ``num_iters``; longer ones come out split. Eager PyTorch
  issues a few launches per sweep (a padded buffer is updated in place, so
  a sweep allocates nothing).
- :func:`label_components`: neighbour min, a scatter-min hook per root and
  two pointer jumps per sweep (exact for any shape in practice).
- :func:`top_instances` / :func:`top_instances_dense`: up to ``max_objects``
  largest components as (B, O, H, W) f32 masks and their areas. Equal areas
  keep JAX ``top_k``'s order, lowest index first: a stable descending sort
  replaces ``torch.topk``, which promises no order among ties.
- :func:`component_count` and :func:`instance_boxes`: the number of
  components of a label map, and the pixel bounding boxes of instance
  masks (over the last two axes, any leading axes).

None of these carries a gradient. While a profiler records, the stencil
labelling and each top-instance selection is one range of the program's
(``utils/profiling.py::span``): ``mgu.cc.stencil`` and
``mgu.cc.top_instances``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from mingraph_unet_tpu_torch.utils.profiling import span

__all__ = ["component_count", "instance_boxes", "label_components", "label_components_stencil", "top_instances",
           "top_instances_dense"]


def _top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, ties lowest
    index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _initial_labels(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    b, h, w = mask.shape
    n = h * w
    fg = mask.bool()
    idx = torch.arange(n, dtype=torch.int32, device=mask.device).reshape(1, h, w)
    return fg, torch.where(fg, idx, torch.full_like(idx, n)), n


@torch.no_grad()
def label_components_stencil(mask: torch.Tensor, num_iters: int = 128) -> torch.Tensor:
    """(B, H, W) binary → (B, H, W) int32 labels by ``num_iters`` sweeps of
    4-neighbour min propagation."""
    with span("cc.stencil"):
        fg, labels, n = _initial_labels(mask)
        padded = F.pad(labels, (1, 1, 1, 1), value=n)  # the border stays n
        inner = padded[:, 1:-1, 1:-1]
        # max(m, floor) keeps a foreground pixel's minimum (labels are >= 0)
        # and resets the background to n.
        floor = torch.where(fg, 0, n).to(torch.int32)
        m = torch.empty_like(labels)
        for _ in range(num_iters):
            torch.minimum(padded[:, :-2, 1:-1], padded[:, 2:, 1:-1], out=m)
            torch.minimum(m, padded[:, 1:-1, :-2], out=m)
            torch.minimum(m, padded[:, 1:-1, 2:], out=m)
            torch.minimum(m, inner, out=m)
            torch.maximum(m, floor, out=m)
            inner.copy_(m)
        return torch.where(fg, inner, torch.full_like(inner, -1))


@torch.no_grad()
def label_components(mask: torch.Tensor, num_iters: int = 16) -> torch.Tensor:
    """(B, H, W) binary → (B, H, W) int32 labels by hook-and-jump sweeps."""
    fg, labels, n = _initial_labels(mask)
    b, h, w = labels.shape
    big = torch.tensor(n, dtype=torch.int32, device=mask.device)
    flat_fg = fg.reshape(b, n)
    flat = labels.reshape(b, n)
    sentinel = torch.full((b, 1), n, dtype=torch.int32, device=mask.device)
    for _ in range(num_iters):
        p = F.pad(flat.reshape(b, h, w), (1, 1, 1, 1), value=n)
        m = torch.minimum(torch.minimum(p[:, :-2, 1:-1], p[:, 2:, 1:-1]),
                          torch.minimum(p[:, 1:-1, :-2], p[:, 1:-1, 2:]))
        mflat = torch.where(flat_fg, torch.minimum(m.reshape(b, n), flat), big)
        # Hook: each root adopts the minimum over the pixels that point at
        # it (bucket n collects the background and is dropped).
        root = torch.where(flat < n, flat, big).long()
        hook = torch.full((b, n + 1), n, dtype=torch.int32, device=mask.device)
        hook.scatter_reduce_(1, root, mflat, reduce="amin", include_self=True)
        flat = torch.minimum(mflat, hook.gather(1, root))
        for _ in range(2):  # pointer jumps
            ext = torch.cat([flat, sentinel], dim=1)
            flat = torch.minimum(flat, ext.gather(1, torch.where(flat < n, flat, big).long()))
    return torch.where(fg, flat.reshape(b, h, w), torch.full_like(labels, -1))


@torch.no_grad()
def top_instances(labels: torch.Tensor, max_objects: int, min_area: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``max_objects`` largest components by an exact per-label area
    count: (B, O, H, W) f32 masks (all-zero rows pad unused slots) and
    (B, O) f32 areas (0 for unused slots)."""
    with span("cc.top_instances"):
        b, h, w = labels.shape
        n = h * w
        flat = labels.reshape(b, n).long()
        ids = torch.where(flat >= 0, flat, torch.full_like(flat, n))
        areas_all = torch.zeros((b, n + 1), dtype=torch.float32, device=labels.device)
        areas_all.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.float32))
        areas_all[:, n] = 0.0  # the background bin
        top_areas, top_ids = _top_k_stable(areas_all, max_objects)
        keep = top_areas >= min_area
        masks = (labels[:, None] == top_ids[:, :, None, None]) & keep[:, :, None, None]
        return masks.float(), torch.where(keep, top_areas, torch.zeros_like(top_areas))


@torch.no_grad()
def top_instances_dense(labels: torch.Tensor, max_objects: int, min_area: int = 1,
                        candidates: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The in-step form of :func:`top_instances`, without a scatter: roots
    whose top-anchored window holds at least ``min_area`` foreground pixels
    (an integral-image box sum) are candidates; the first ``candidates``
    (default max(4·max_objects, 16)) in raster order get exact areas by
    dense comparison, and the largest ``max_objects`` of them are kept."""
    with span("cc.top_instances"):
        b, h, w = labels.shape
        n = h * w
        dev = labels.device
        cand = candidates or max(4 * max_objects, 16)
        fg = labels >= 0
        idx = torch.arange(n, dtype=torch.int32, device=dev).reshape(1, h, w)
        roots = fg & (labels == idx)

        side = 2 * math.isqrt(max(min_area - 1, 0)) + 3
        r = side // 2
        integ = F.pad(torch.cumsum(torch.cumsum(fg.float(), 1), 2), (1, 0, 1, 0))  # (B, H+1, W+1)
        # Edge-replicated extension of the integral image clamps the window at
        # the border, as JAX's pad(mode="edge").
        ext = F.pad(integ[:, None], (r, r + 1, 0, side), mode="replicate")[:, 0]
        c0, c1 = 2 * r + 1, 2 * r + 1 + w
        mass = ext[:, side : side + h, c0:c1] - ext[:, 0:h, c0:c1] - ext[:, side : side + h, 0:w] + ext[:, 0:h, 0:w]

        score = torch.where(roots & (mass >= min_area), n - idx, torch.zeros_like(idx))
        # The positive scores are distinct, so the top values do not depend on
        # how ties among the zeros are broken.
        top_scores = torch.topk(score.reshape(b, n), min(cand, n), dim=1).values
        ids_c = torch.where(top_scores > 0, n - top_scores, torch.full_like(top_scores, n))
        areas_c = (labels.reshape(b, 1, n) == ids_c[:, :, None]).sum(-1).float()
        areas_c = torch.where((top_scores > 0) & (areas_c >= min_area), areas_c, torch.zeros_like(areas_c))
        top_areas, pos = _top_k_stable(areas_c, max_objects)
        keep = top_areas >= float(max(min_area, 1))
        ids_k = torch.where(keep, ids_c.gather(1, pos), torch.full_like(pos, n, dtype=ids_c.dtype))
        masks = labels[:, None] == ids_k[:, :, None, None]
        return masks.float(), torch.where(keep, top_areas, torch.zeros_like(top_areas))


@torch.no_grad()
def component_count(labels: torch.Tensor) -> torch.Tensor:
    """(..., H, W) labels → (...) int32: the root pixels (label == own
    linear index)."""
    h, w = labels.shape[-2:]
    idx = torch.arange(h * w, dtype=labels.dtype, device=labels.device).reshape(h, w)
    return ((labels == idx) & (labels >= 0)).sum(dim=(-2, -1)).to(torch.int32)


@torch.no_grad()
def instance_boxes(masks: torch.Tensor) -> torch.Tensor:
    """(..., H, W) binary masks → (..., 4) f32 ``[x_min, y_min, x_max,
    y_max]``, the maxima the last row and column holding the object; an
    empty mask gives a zero box."""
    h, w = masks.shape[-2:]
    dev = masks.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    m = masks.bool()
    big, neg = torch.tensor(1e9, device=dev), torch.tensor(-1.0, device=dev)
    y_min = torch.where(m, ys, big).amin(dim=(-2, -1))
    x_min = torch.where(m, xs, big).amin(dim=(-2, -1))
    y_max = torch.where(m, ys, neg).amax(dim=(-2, -1))
    x_max = torch.where(m, xs, neg).amax(dim=(-2, -1))
    boxes = torch.stack([x_min, y_min, x_max, y_max], dim=-1)
    return torch.where(m.flatten(-2).any(-1)[..., None], boxes, torch.zeros_like(boxes))
