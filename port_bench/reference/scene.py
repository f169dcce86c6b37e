"""The large-scene serving forward with the dense fruit head, and its
decode, in plain PyTorch, NHWC, f32 (TF32 off: :meth:`Precision.active`).

Written from the model's equations, one scene at a time so that it fits
beside nothing else, reusing the U-Net and the graph branch of
``reference/model.py``:

- the scene normalized; windows of ``tile + 2·halo`` at the clamped starts
  ``max(0, min(t·tile − halo, H − win))`` (the whole scene where it is at
  most one window on a side); the U-Net on each window; each window's
  ``tile``-sized cell put back in place, for the logits, level 0's skip and
  the last decoder output;
- over the whole scene: the patch features (the skip's patch means through
  the projection, Sobel, hist-eq), the lattice GAT, MinCut's soft
  assignments, region pooling and the region GAT;
- the full-resolution fused map: the last decoder output beside the region
  embedding broadcast to its patch's pixels;
- the single-box head: the map average-pooled (VALID windows of H // S by
  W // S, ``detection_pre_pool`` S) before its two conv + ReLU + BN, the
  mean and the dense layers;
- the dense head: conv 3×3 + ReLU at full resolution, average pool by the
  cell, conv 3×3 + ReLU, the 1×1 objectness and the sigmoid of the 1×1
  box (centre offset in the cell, size as a fraction of the image);
- :func:`decode`: the sigmoid in f64 rounded once to f32, the stable top-k,
  boxes in pixels, pairwise IoU, greedy NMS over the score-sorted list, the
  survivors at or above the score threshold.

Replayed decisions (the program's, handed in as data):

- the hard patch labels that region pooling uses (``labels``): the argmax
  of near-equal soft assignments is a discrete decision that rounding may
  flip, and a flipped patch moves a region's mean by far more than rounding
  does; the labels themselves are judged where the reference's two best
  assignments are clear of each other;
- the program's own dense outputs, for the decode: its top-k, thresholds
  and NMS are discrete, so a bf16 objectness logit a rounding away from
  the reference's may change every slot after it. Both sides decode the
  same outputs; the dense outputs are judged by their own gaps, and the
  decode's arithmetic, exact f32 on both sides, by its slots.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from port_bench.reference import model as ref
from port_bench.reference.numerics import Precision

DENSE_HIDDEN = 64  # the dense head's width (models/detection.py::DenseDetectionHead)


def scene_spec(a: dict):
    """``reference/model.py::pipeline_spec``'s leaves and the dense head's."""
    c = a["init_features"] + a["gat_output_dim"]
    d = DENSE_HIDDEN
    spec = ref.pipeline_spec(a)
    for name, shape in (("conv1", (3, 3, c, d)), ("conv2", (3, 3, d, d)), ("obj_head", (1, 1, d, 1)),
                        ("box_head", (1, 1, d, 4))):
        spec += [(f"dense_detection_head.{name}.kernel", shape, "kernel"),
                 (f"dense_detection_head.{name}.bias", (shape[-1],), "bias")]
    return spec


def window_starts(size: int, tile: int, halo: int) -> List[int]:
    """Starts of the windows along one axis, one a tile, clamped into the scene."""
    win = tile + 2 * halo
    return [max(0, min(t * tile - halo, size - win)) for t in range(-(-size // tile))]


def stitched_unet(p, images: torch.Tensor, depth: int, tile: int, halo: int, prec: Precision):
    """``{"logits", "skip0", "f_u0"}`` of the U-Net run window by window over
    (n, H, W, C) normalized scenes, each window's cell put back in place."""
    n, h, w, _ = images.shape
    win = tile + 2 * halo
    if h <= win or w <= win:
        return ref.unet(p, images, depth, prec, prefix="unet.")
    out: Dict[str, torch.Tensor] = {}
    for ty, y0 in enumerate(window_starts(h, tile, halo)):
        for tx, x0 in enumerate(window_starts(w, tile, halo)):
            u = ref.unet(p, images[:, y0 : y0 + win, x0 : x0 + win], depth, prec, prefix="unet.")
            r0, r1, c0, c1 = ty * tile, min((ty + 1) * tile, h), tx * tile, min((tx + 1) * tile, w)
            for k, v in u.items():
                if k not in out:
                    out[k] = torch.empty((n, h, w, v.shape[-1]), dtype=v.dtype, device=v.device)
                out[k][:, r0:r1, c0:c1] = v[:, r0 - y0 : r1 - y0, c0 - x0 : c1 - x0]
    return out


def avg_pool(x: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """Mean over (sh, sw) windows with the same stride, VALID: a ragged
    trailing row or column is dropped."""
    n, h, w, c = x.shape
    x = x[:, : h // sh * sh, : w // sw * sw]
    return x.reshape(n, h // sh, sh, w // sw, sw, c).mean(dim=(2, 4))


def dense_head(p, fused: torch.Tensor, cell: int, prec: Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    """(objectness logits (n, gh, gw), boxes (n, gh, gw, 4)) of the fused map."""
    name = "dense_detection_head"
    x = torch.relu(ref.conv2d(fused, p[f"{name}.conv1.kernel"], p[f"{name}.conv1.bias"], prec))
    x = avg_pool(x, cell, cell)
    x = torch.relu(ref.conv2d(x, p[f"{name}.conv2.kernel"], p[f"{name}.conv2.bias"], prec))
    obj = ref.conv2d(x, p[f"{name}.obj_head.kernel"], p[f"{name}.obj_head.bias"], prec, pad=0)
    box = torch.sigmoid(ref.conv2d(x, p[f"{name}.box_head.kernel"], p[f"{name}.box_head.bias"], prec, pad=0))
    return obj[..., 0], box


def scene_forward(p, images_u8: torch.Tensor, a: dict, mean: Sequence[float], std: Sequence[float], tile: int,
                  halo: int, prec: Precision, labels: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The eval forward of (n, H, W, 3) uint8 scenes: the outputs the cell
    compares, and ``hard_patch_labels``, the argmax of the soft
    assignments. ``labels`` (n, H/p, W/p), when given, replace that argmax
    in the region pooling."""
    ps, k = a["patch_size"], a["num_segments"]
    m = torch.tensor(mean, device=images_u8.device)
    s = torch.tensor(std, device=images_u8.device)
    images = (images_u8.float() / 255.0 - m) / s
    n, h, w, _ = images.shape
    u = stitched_unet(p, images, a["depth"], tile, halo, prec)
    unet_patch = ref.dense(ref.patch_mean(u["skip0"], ps), p, "patch_feature_proj", prec)
    rgb255 = torch.clamp(images * s + m, 0.0, 1.0) * 255.0
    histeq = ref.equalize_luma(torch.clamp(torch.round(rgb255), 0, 255).to(torch.uint8)).float() / 255.0
    feats = torch.cat([unet_patch, ref.sobel_patch_mean(rgb255, ps), ref.patch_mean(histeq, ps)], dim=-1)
    gat = ref.lattice_gat(p, "patch_gat", feats, prec)
    soft = torch.softmax(ref.lattice_gat(p, "mincut.segment_predictor.gnn_predictor", gat, prec), dim=-1)
    _, r, c, d = gat.shape
    hard = torch.argmax(soft, dim=-1)
    flat = (hard if labels is None else labels.to(hard.device)).reshape(n, r * c)
    onehot = (flat[..., None] == torch.arange(k, device=flat.device)).float()  # (n, patches, k)
    sums = torch.einsum("bnk,bnd->bkd", onehot, gat.reshape(n, r * c, d))
    region = ref.dense_gat_all_pairs(p, "region_gat", sums / torch.clamp(onehot.sum(dim=1), min=1.0)[..., None], prec)
    f_g = torch.einsum("bnk,bkd->bnd", onehot, region).reshape(n, r, c, d)
    fused = torch.cat([u["f_u0"], f_g.repeat_interleave(ps, dim=1).repeat_interleave(ps, dim=2)], dim=-1)
    pre = a.get("detection_pre_pool")
    det_in = avg_pool(fused, max(1, h // pre), max(1, w // pre)) if pre is not None and h > pre else fused
    bbox, conf = ref.detection_head(p, det_in, prec)
    obj, box = dense_head(p, fused, ps, prec)
    return {"logits": u["logits"], "gat_feats": gat, "soft_assignments": soft, "region_embeddings": region,
            "pred_bboxes": bbox, "pred_confidence": conf, "dense_objectness_logits": obj, "dense_boxes": box,
            "hard_patch_labels": hard}


# ---------------------------------------------------------------------------
# The decode
# ---------------------------------------------------------------------------


def pairwise_iou(b: torch.Tensor) -> torch.Tensor:
    """(n, K, 4) xyxy → (n, K, K) IoU; 0 where the union is empty."""
    x0, y0, x1, y1 = (b[..., :, None, i] for i in range(4))
    u0, v0, u1, v1 = (b[..., None, :, i] for i in range(4))
    inter = torch.clamp(torch.minimum(x1, u1) - torch.maximum(x0, u0), min=0) * torch.clamp(
        torch.minimum(y1, v1) - torch.maximum(y0, v0), min=0)
    area = torch.clamp(b[..., 2] - b[..., 0], min=0) * torch.clamp(b[..., 3] - b[..., 1], min=0)
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def decode(obj: torch.Tensor, box: torch.Tensor, image_hw: Tuple[int, int], cell: int, top_k: int,
           score_threshold: float, iou_threshold: float, margin: float) -> Dict[str, torch.Tensor]:
    """Dense outputs (n, gh, gw), (n, gh, gw, 4) → per scene ``det_boxes``
    (n, K, 4) xyxy pixels, ``det_scores`` (n, K) and ``det_valid`` (n, K),
    K = min(top_k, gh·gw), zeros in the slots that are not valid; and
    ``decode_clear`` (n, K): the slots whose decisions are clear by more
    than ``margin`` of both thresholds (the score's, and every IoU with an
    earlier candidate, whose own keep must be clear where it suppresses)."""
    n, gh, gw = obj.shape
    h, w = image_hw
    k = min(top_k, gh * gw)
    dev = obj.device
    scores = torch.sigmoid(obj.double()).float().reshape(n, gh * gw)
    row = torch.arange(gh, dtype=torch.float32, device=dev).repeat_interleave(gw)
    col = torch.arange(gw, dtype=torch.float32, device=dev).repeat(gh)
    f = box.float().reshape(n, gh * gw, 4)
    cx, cy = (col + f[..., 0]) * cell, (row + f[..., 1]) * cell
    bw, bh = f[..., 2] * w, f[..., 3] * h
    xyxy = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], dim=-1)
    # The k best, equal scores lowest cell index first; the list stays in this order.
    top, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    cand = torch.gather(xyxy, 1, idx[..., None].expand(n, k, 4))
    iou = pairwise_iou(cand)
    keep = torch.ones((n, k), dtype=torch.bool, device=dev)
    nms_clear = torch.ones((n, k), dtype=torch.bool, device=dev)
    for j in range(1, k):
        suppressing = (iou[:, :j, j] >= iou_threshold) & keep[:, :j]
        keep[:, j] = ~suppressing.any(dim=1)
        near = (iou[:, :j, j] - iou_threshold).abs() <= margin
        nms_clear[:, j] = ~(near | ((iou[:, :j, j] >= iou_threshold) & ~nms_clear[:, :j])).any(dim=1)
    valid = keep & (top >= score_threshold)
    return {"det_boxes": torch.where(valid[..., None], cand, torch.zeros_like(cand)),
            "det_scores": torch.where(valid, top, torch.zeros_like(top)), "det_valid": valid,
            "decode_clear": nms_clear & ((top - score_threshold).abs() > margin)}
