"""The end-to-end trainer's step in plain PyTorch: the configured augmentation,
MinGraph-UNet in train mode with the full-resolution detection head,

``L_total = CE + λ1·L_shape + λ2·L_feature + λ3·L_partition + λ4·L_smooth
+ L_bbox + L_conf``,

autograd, and Adam with L2 weight decay folded into the gradient. Written
from the equations: the U-Net with batch-statistics BN, hist-eq, Sobel and
patch means (``model.py``), the lattice GAT with dropout on its attention
and its output, the MinCut soft assignments and their normalized cut over
the lattice, region pooling and the all-pairs region GAT, fusion of the
last decoder map with the region embeddings broadcast to pixels, and the
detection head (conv → ReLU → BN, twice, in train mode; global mean; two
ReLU FCs with dropout 0.5; sigmoid box and confidence) on the fused map.

Replayed decisions. Each is a discrete choice of the program's that a
difference in the last place of an f32 value can flip, and a flipped choice
moves a term by far more than rounding does, so the program's choice is
given to the reference as data, as the serving reference takes the
program's region labels:

- the augmentation draw: the generator's state before the step, from which
  :func:`train.draw` draws the crop, flip and angle in the trainer's order;
- the dropout masks: the keep masks of the program's dropouts, in the
  order the forward applies them (the patch GAT's attention and output, the
  segment predictor's, the region GAT's, the head's two FCs): the
  reference draws no dropout of its own;
- the region labels: the argmax of the soft assignments by which patches
  are pooled into regions, two near-equal logits apart;
- the instance slots: the connected components of the thresholded
  foreground probability that the program's CC and top-K put in each of the
  ``max_instances`` slots, which L_shape weighs by the soft probability; a
  pixel at the threshold decides whether two blobs are one. The slots are
  not taken on trust: :func:`instance_slots` labels the program's own
  foreground map from the equations of the fast instancing, and
  :func:`instance_gap` counts the pixels whose slot differs.

A step given no decisions (``None``: a fault cut its batch) runs without
dropout, pools by its own labels and has no instances.

Each checked step's terms are computed at the program's parameters before
that step (:func:`train_steps`' ``starts``), so that one step's function is
compared on the same inputs; the gradient and the parameters after the
steps come from the reference's own run from the same start.
:func:`smooth_gap` compares L_smooth where it is well conditioned: see its
docstring.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference import model as ref
from port_bench.reference import train as ref_train
from port_bench.reference.numerics import Precision

HEAD_DROPOUT = 0.5  # the detection head's two FCs
SHAPE_MIN_PIXELS, SHAPE_EPS = 10, 1e-6
CC_THRESHOLD, CC_SWEEPS = 0.5, 128  # L_shape's instances: p_fg > 0.5, 128 sweeps of 4-neighbour minima
ASSOC_EPS = 1e-8
TERMS = ("total", "l_unet_seg", "l_shape", "l_feature", "l_partition", "l_smooth", "l_bbox", "l_conf")


def smooth_gap(tv: float, tv_h_ref: float, tv_w_ref: float) -> float:
    """L_smooth's gap in the units of the foreground map: ``|TV − TV_ref| /
    (4·(√TV_h + √TV_w))`` of the reference's parts.

    ``TV_h = mean(d²)`` over the vertical neighbour differences ``d`` of the
    map (``TV_w`` over the horizontal ones). An error ``δp`` of at most ``ε``
    in every probability moves each ``d`` by at most ``2ε``, so to first
    order ``|ΔTV_h| = |mean(2·d·δd)| ≤ 4ε·mean|d| ≤ 4ε·√TV_h``, and the same
    for ``w``. The gap is therefore at most the map's largest error ``ε``,
    whatever the seed; the relative gap ``|ΔTV| / TV`` is ``≈ 2ε/|d|``,
    which a nearly flat map at initialization makes large."""
    denom = 4.0 * (math.sqrt(max(tv_h_ref, 0.0)) + math.sqrt(max(tv_w_ref, 0.0)))
    return abs(tv - (tv_h_ref + tv_w_ref)) / max(denom, 1e-30)


def tv_parts(p_fg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(TV_h, TV_w) of (B, H, W) maps: the mean squared neighbour difference
    down and across."""
    return (p_fg[:, 1:] - p_fg[:, :-1]).pow(2).mean(), (p_fg[:, :, 1:] - p_fg[:, :, :-1]).pow(2).mean()


# ---------------------------------------------------------------------------
# The forward in train mode
# ---------------------------------------------------------------------------


def _drop(x: torch.Tensor, keeps: Optional[Iterator[torch.Tensor]], rate: float) -> torch.Tensor:
    """Inverted dropout with the next replayed keep mask; the identity
    without masks."""
    if keeps is None:
        return x
    keep = next(keeps)
    if keep.shape != x.shape:
        raise ValueError(f"a replayed dropout mask {tuple(keep.shape)} does not fit {tuple(x.shape)}")
    return torch.where(keep.to(x.device), x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def lattice_gat(p, name: str, x: torch.Tensor, prec: Precision, rate: float, keeps) -> torch.Tensor:
    """One averaging GAT layer over the 4-connected lattice of (B, R, C, D)
    (``model.lattice_gat``), its attention and its output dropped."""
    w, a_src, a_dst = (p[f"{name}.layer0.heads.{k}"] for k in ("W", "a_src", "a_dst"))
    h = torch.einsum("brcd,hdo->bhrco", prec.q(x), prec.q(w))
    s_src = torch.einsum("bhrco,ho->bhrc", prec.q(h), prec.q(a_src))
    s_dst = torch.einsum("bhrco,ho->bhrc", prec.q(h), prec.q(a_dst))
    ones = torch.ones(x.shape[1:3] + (1,), device=x.device)
    nh = torch.stack([ref._shift(h, dr, dc) for dr, dc in ref.DIRECTIONS], dim=-2)
    ns = torch.stack([ref._shift(s_src[..., None], dr, dc)[..., 0] for dr, dc in ref.DIRECTIONS], dim=-1)
    valid = torch.stack([ref._shift(ones, dr, dc)[..., 0] for dr, dc in ref.DIRECTIONS], dim=-1) > 0
    e = ref._leaky(ns + s_dst[..., None])
    gmax = torch.where(valid, e, torch.full_like(e, float("-inf"))).amax(dim=(-3, -2, -1), keepdim=True)
    ex = torch.where(valid, torch.exp(e - gmax), torch.zeros_like(e))
    attn = _drop(ex / (ex.sum(dim=-1, keepdim=True) + 1e-10), keeps, rate)
    out = F.elu(torch.einsum("bhrck,bhrcko->bhrco", prec.q(attn), prec.q(nh))).mean(dim=1)
    return _drop(out, keeps, rate)


def region_gat(p, name: str, x: torch.Tensor, prec: Precision, rate: float, keeps) -> torch.Tensor:
    """One averaging GAT layer over the complete graph without self-loops of
    (B, N, D) (``model.dense_gat_all_pairs``), its attention and its output
    dropped."""
    w, a_src, a_dst = (p[f"{name}.layer0.heads.{k}"] for k in ("W", "a_src", "a_dst"))
    n = x.shape[1]
    h = torch.einsum("bnd,hdo->bhno", prec.q(x), prec.q(w))
    s_src = torch.einsum("bhno,ho->bhn", prec.q(h), prec.q(a_src))
    s_dst = torch.einsum("bhno,ho->bhn", prec.q(h), prec.q(a_dst))
    e = ref._leaky(s_src[..., None, :] + s_dst[..., :, None])  # (b, h, target, source)
    mask = ~torch.eye(n, dtype=torch.bool, device=x.device)
    gmax = torch.where(mask, e, torch.full_like(e, float("-inf"))).amax(dim=(-2, -1), keepdim=True)
    ex = torch.where(mask, torch.exp(e - gmax), torch.zeros_like(e))
    attn = _drop(ex / (ex.sum(dim=-1, keepdim=True) + 1e-10), keeps, rate)
    out = F.elu(torch.einsum("bhji,bhio->bhjo", prec.q(attn), prec.q(h))).mean(dim=1)
    return _drop(out, keeps, rate)


def normalized_cut(f: torch.Tensor, soft: torch.Tensor, sigma: float) -> torch.Tensor:
    """Per image ``Σ_k cut_k / assoc_k`` over the segments with ``assoc_k >
    1e-8``: for every lattice edge j → i with ``w_ij = exp(−‖f_i − f_j‖² /
    2σ²)``, ``assoc_k += w_ij·P_ik`` and ``cut_k += w_ij·P_ik·(1 − P_jk)``."""
    ones = torch.ones(f.shape[1:3] + (1,), device=f.device)
    assoc = cut = 0.0
    for dr, dc in ref.DIRECTIONS:
        valid = ref._shift(ones, dr, dc)[..., 0]
        w = torch.exp(-(f - ref._shift(f, dr, dc)).pow(2).sum(-1) / (2.0 * sigma**2)) * valid
        assoc = assoc + torch.einsum("brck,brc->bk", soft, w)
        cut = cut + torch.einsum("brck,brc->bk", soft * (1.0 - ref._shift(soft, dr, dc)), w)
    ok = assoc > ASSOC_EPS
    return torch.where(ok, cut / torch.where(ok, assoc, torch.ones_like(assoc)), torch.zeros_like(cut)).sum(-1)


def batch_norm_train(p, pre: str, z: torch.Tensor, stats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """BN over every axis but the last by the batch's statistics (biased
    variance); the new running statistics ``0.9·running + 0.1·batch`` go
    into ``stats``."""
    mean = z.mean(dim=(0, 1, 2))
    var = torch.clamp((z * z).mean(dim=(0, 1, 2)) - mean * mean, min=0.0)
    with torch.no_grad():
        stats[f"{pre}.mean"] = ref.BN_MOMENTUM * p[f"{pre}.mean"] + (1 - ref.BN_MOMENTUM) * mean
        stats[f"{pre}.var"] = ref.BN_MOMENTUM * p[f"{pre}.var"] + (1 - ref.BN_MOMENTUM) * var
    a = p[f"{pre}.scale"] * torch.rsqrt(var + ref.BN_EPS)
    return z * a + (p[f"{pre}.bias"] - mean * a)


def detection_head(p, x: torch.Tensor, prec: Precision, stats, keeps) -> Tuple[torch.Tensor, torch.Tensor]:
    for i in (1, 2):
        z = torch.relu(ref.conv2d(x, p[f"detection_head.conv{i}.kernel"], p[f"detection_head.conv{i}.bias"], prec))
        x = batch_norm_train(p, f"detection_head.bn{i}", z, stats)
    x = x.mean(dim=(1, 2))
    x = _drop(torch.relu(ref.dense(x, p, "detection_head.fc1", prec)), keeps, HEAD_DROPOUT)
    x = _drop(torch.relu(ref.dense(x, p, "detection_head.fc2", prec)), keeps, HEAD_DROPOUT)
    return (torch.sigmoid(ref.dense(x, p, "detection_head.fc_bbox", prec)),
            torch.sigmoid(ref.dense(x, p, "detection_head.fc_confidence", prec)))


def forward(p, images: torch.Tensor, a: dict, prec: Precision, stats: Dict[str, torch.Tensor],
            keeps: Optional[Iterator[torch.Tensor]], labels: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """MinGraph-UNet in train mode on normalized (B, H, W, 3) images."""
    ps, k, rate = a["patch_size"], a["num_segments"], a["gat_dropout"]
    m = torch.tensor(a["normalization_mean"], device=images.device)
    s = torch.tensor(a["normalization_std"], device=images.device)
    u = ref.unet(p, images, a["depth"], prec, prefix="unet.", stats=stats)
    unet_patch = ref.dense(ref.patch_mean(u["skip0"], ps), p, "patch_feature_proj", prec)
    with torch.no_grad():
        rgb255 = torch.clamp(images * s + m, 0.0, 1.0) * 255.0
        histeq = ref.equalize_luma(torch.clamp(torch.round(rgb255), 0, 255).to(torch.uint8)).float() / 255.0
        cues = torch.cat([ref.sobel_patch_mean(rgb255, ps), ref.patch_mean(histeq, ps)], dim=-1)
    gat = lattice_gat(p, "patch_gat", torch.cat([unet_patch, cues], dim=-1), prec, rate, keeps)
    seg_logits = lattice_gat(p, "mincut.segment_predictor.gnn_predictor", gat, prec, rate, keeps)
    soft = torch.softmax(seg_logits, dim=-1)
    l_partition = normalized_cut(gat, soft, a["sigma_ncut"])
    b, r, c, d = gat.shape
    hard = torch.argmax(soft, dim=-1) if labels is None else labels.to(gat.device)
    onehot = (hard.reshape(b, r * c)[..., None] == torch.arange(k, device=gat.device)).float()
    region_feats = torch.einsum("bnk,bnd->bkd", onehot, gat.reshape(b, r * c, d))
    region_feats = region_feats / torch.clamp(onehot.sum(dim=1), min=1.0)[..., None]
    region = region_gat(p, "region_gat", region_feats, prec, rate, keeps)
    f_g = torch.einsum("bnk,bkd->bnd", onehot, region).reshape(b, r, c, d)
    f_g_pixels = f_g.repeat_interleave(ps, dim=1).repeat_interleave(ps, dim=2)
    bbox, conf = detection_head(p, torch.cat([u["f_u0"], f_g_pixels], dim=-1), prec, stats, keeps)
    f_unet_patches = ref.dense(ref.patch_mean(u["f_u0"], ps), p, "feature_consistency_proj", prec)
    return {"logits": u["logits"], "gat": gat, "f_unet_patches": f_unet_patches, "soft": soft,
            "l_partition": l_partition, "bbox": bbox, "conf": conf}


# ---------------------------------------------------------------------------
# The loss terms
# ---------------------------------------------------------------------------


def shape_loss(p_fg: torch.Tensor, slots: Optional[torch.Tensor], max_instances: int) -> torch.Tensor:
    """L_shape over the instance slots (B, H, W) (the slot a pixel is in,
    −1 for none), each instance's pixels weighed by ``p_fg``: with the
    weighted offsets ``v = m·(pos − centroid)`` (mass ``n = Σm``), the
    covariance ``Σ vvᵀ / max(n − 1, 1) + εI`` and ``q = vᵀΣ⁻¹v``, an
    object's penalty is ``Σ m·(q − 1)² / max(n, 1)``; the mean over the
    objects of mass at least 10 (and 2), 0 when there is none."""
    if slots is None:
        return torch.zeros((), device=p_fg.device)
    b, h, w = p_fg.shape
    inst = (slots.to(p_fg.device).long()[:, None] == torch.arange(max_instances, device=p_fg.device)[:, None, None])
    m = inst.float() * p_fg[:, None]
    ys = torch.arange(h, dtype=torch.float32, device=p_fg.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=p_fg.device)[None, :]
    n = m.sum(dim=(-2, -1))
    mass = torch.clamp(n, min=1.0)
    vy = (ys - ((m * ys).sum(dim=(-2, -1)) / mass)[..., None, None]) * m
    vx = (xs - ((m * xs).sum(dim=(-2, -1)) / mass)[..., None, None]) * m
    dof = torch.clamp(n - 1.0, min=1.0)
    cyy = (vy * vy).sum(dim=(-2, -1)) / dof + SHAPE_EPS
    cxx = (vx * vx).sum(dim=(-2, -1)) / dof + SHAPE_EPS
    cyx = (vy * vx).sum(dim=(-2, -1)) / dof
    det = cyy * cxx - cyx * cyx
    q = ((cxx / det)[..., None, None] * vy * vy - 2.0 * (cyx / det)[..., None, None] * vy * vx
         + (cyy / det)[..., None, None] * vx * vx)
    per = ((q - 1.0) ** 2 * m).sum(dim=(-2, -1)) / mass
    valid = (n >= SHAPE_MIN_PIXELS) & (n >= 2)
    count = valid.sum()
    total = torch.where(valid, per, torch.zeros_like(per)).sum()
    return torch.where(count > 0, total / torch.clamp(count, min=1), torch.zeros_like(total))


def _neighbour_min_labels(fg: torch.Tensor, sweeps: int) -> torch.Tensor:
    """(H, W) foreground → int64 labels: each foreground pixel's least raster
    index ``y·W + x`` over the foreground pixels it reaches in at most
    ``sweeps`` 4-neighbour steps inside the foreground (its component's
    least where the component's geodesic diameter is at most ``sweeps``);
    ``H·W`` on the background."""
    h, w = fg.shape
    big = h * w
    lab = torch.where(fg, torch.arange(big, device=fg.device).reshape(h, w), big)
    for _ in range(sweeps):
        nb = lab.clone()
        nb[1:] = torch.minimum(nb[1:], lab[:-1])
        nb[:-1] = torch.minimum(nb[:-1], lab[1:])
        nb[:, 1:] = torch.minimum(nb[:, 1:], lab[:, :-1])
        nb[:, :-1] = torch.minimum(nb[:, :-1], lab[:, 1:])
        lab = torch.where(fg, nb, big)
    return lab


def _window_counts(fg: torch.Tensor, side: int) -> torch.Tensor:
    """(H, W) → the foreground pixels in rows ``y … y+side−1`` and columns
    ``x−side//2 … x+side//2`` of each (y, x), the window cut at the border."""
    h, w = fg.shape
    f = fg.long()
    rows = torch.zeros_like(f)
    for dy in range(min(side, h)):
        rows[: h - dy] += f[dy:]
    win = torch.zeros_like(f)
    for dx in range(-(side // 2), side // 2 + 1):
        if dx >= 0:
            win[:, : max(w - dx, 0)] += rows[:, dx:]
        elif -dx < w:
            win[:, -dx:] += rows[:, : w + dx]
    return win


def instance_slots(p_fg: torch.Tensor, max_instances: int) -> torch.Tensor:
    """L_shape's instances of the foreground maps (B, H, W), from the
    equations of the fast instancing, as (B, H, W) int8 slots (−1 for none).

    The pixels with ``p_fg > 0.5`` are labelled by :func:`_neighbour_min_labels`
    in 128 sweeps; a root is a pixel whose label is its own index. With
    ``a = SHAPE_MIN_PIXELS``, a root is a candidate where its window
    (``side = 2·⌊√(a − 1)⌋ + 3`` rows from the root down, ``side`` columns
    centred on it, cut at the border) holds at least ``a`` foreground
    pixels. The first ``max(4·max_instances, 16)`` candidates in raster order
    have their areas counted; those of area at least ``a`` are ranked by
    area, the earlier first among equals, and slot i holds the pixels of the
    i-th of the first ``max_instances``."""
    b, h, w = p_fg.shape
    min_area = SHAPE_MIN_PIXELS
    side = 2 * math.isqrt(min_area - 1) + 3
    n_cand = max(4 * max_instances, 16)
    slots = torch.full((b, h, w), -1, dtype=torch.int8, device=p_fg.device)
    for i in range(b):
        fg = p_fg[i] > CC_THRESHOLD
        lab = _neighbour_min_labels(fg, CC_SWEEPS)
        flat = lab.flatten()
        is_root = fg.flatten() & (flat == torch.arange(h * w, device=flat.device))
        cand = torch.nonzero(is_root & (_window_counts(fg, side).flatten() >= min_area))[:n_cand, 0]
        areas = torch.bincount(flat[fg.flatten()], minlength=h * w)[cand]
        cand, areas = cand[areas >= min_area], areas[areas >= min_area]
        order = torch.sort(areas, descending=True, stable=True).indices[:max_instances]
        for slot, root in enumerate(cand[order].tolist()):
            slots[i][lab == root] = slot
    return slots


def instance_gap(slots: List[Optional[torch.Tensor]], p_fg: List[Optional[torch.Tensor]],
                 max_instances: int) -> float:
    """The pixels, over the steps, whose program slot is not the one
    :func:`instance_slots` gives the program's own foreground map (so no
    rounding moves the threshold); inf where a step's slots or map are
    missing or do not fit."""
    gap = 0.0
    for sl, pf in zip(slots, p_fg):
        if sl is None or pf is None or sl.shape != pf.shape:
            return float("inf")
        gap += float((sl.to(pf.device) != instance_slots(pf.float(), max_instances)).sum())
    return gap


def union_box(labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per image the normalized (cx, cy, w, h) of the foreground's bounding
    box (zeros without foreground) and whether it has foreground."""
    b, h, w = labels.shape
    fg = labels == 1
    ys = torch.arange(h, dtype=torch.float32, device=labels.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=labels.device)[None, :]
    big = torch.tensor(1e9, device=labels.device)
    y0, y1 = torch.where(fg, ys, big).amin(dim=(1, 2)), torch.where(fg, ys, -big).amax(dim=(1, 2))
    x0, x1 = torch.where(fg, xs, big).amin(dim=(1, 2)), torch.where(fg, xs, -big).amax(dim=(1, 2))
    has = fg.flatten(1).any(1)
    box = torch.stack([(x0 + x1 + 1.0) / 2.0 / w, (y0 + y1 + 1.0) / 2.0 / h, (x1 - x0 + 1.0) / w,
                       (y1 - y0 + 1.0) / h], dim=-1)
    return torch.where(has[:, None], box, torch.zeros_like(box)), has


def loss_terms(out: Dict[str, torch.Tensor], labels: torch.Tensor, slots: Optional[torch.Tensor], a: dict,
               weights: dict, max_instances: int) -> Dict[str, torch.Tensor]:
    ps = a["patch_size"]
    logits = out["logits"]
    ce = -torch.log_softmax(logits, dim=-1).gather(-1, labels[..., None]).mean()
    p_fg = torch.softmax(logits, dim=-1)[..., 1]
    with torch.no_grad():
        y_p = (ref.patch_mean((labels == 1).float()[..., None], ps)[..., 0] > 0.5).float()
    dist_sq = (out["f_unet_patches"] - out["gat"]).pow(2).sum(-1)
    hinge = torch.relu(weights["feature_loss_margin"] - torch.sqrt(dist_sq + 1e-8)) ** 2
    feature = (y_p * dist_sq + (1.0 - y_p) * hinge).sum(dim=(1, 2)).mean()
    tv_h, tv_w = tv_parts(p_fg)
    gt, has = union_box(labels)
    hasf = has.float()
    bbox = ((out["bbox"] - gt).abs().sum(-1) * hasf).sum() / torch.clamp(hasf.sum(), min=1.0)
    conf = torch.clamp(out["conf"][..., 0], 1e-7, 1.0 - 1e-7)
    terms = {"l_unet_seg": ce, "l_shape": shape_loss(p_fg, slots, max_instances), "l_feature": feature,
             "l_partition": out["l_partition"].mean(), "l_smooth": tv_h + tv_w, "l_bbox": bbox,
             "l_conf": -(hasf * torch.log(conf) + (1.0 - hasf) * torch.log(1.0 - conf)).mean()}
    total = ce
    for name in ("l_shape", "l_feature", "l_partition", "l_smooth"):
        wt = weights[f"{name}_weight"]
        if wt != 0.0:
            total = total + wt * terms[name]
    terms["total"] = total + terms["l_bbox"] + terms["l_conf"]
    terms["tv_h"], terms["tv_w"], terms["p_fg"] = tv_h, tv_w, p_fg
    return terms


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _step_terms(p: Dict[str, torch.Tensor], x: torch.Tensor, labels: torch.Tensor, dec: Optional[dict], a: dict,
                weights: dict, max_instances: int, prec: Precision, stats: Dict[str, torch.Tensor]):
    """The forward and the loss terms of one step at the parameters ``p``,
    replaying the step's decisions ``dec``."""
    keeps = iter(dec["keeps"]) if dec is not None else None
    fwd = forward(p, x, a, prec, stats, keeps, dec["labels"] if dec is not None else None)
    terms = loss_terms(fwd, labels, dec["slots"] if dec is not None else None, a, weights, max_instances)
    if keeps is not None and next(keeps, None) is not None:
        raise ValueError("the program applied more dropouts than the reference replays")
    return fwd, terms


def train_steps(p0: Dict[str, torch.Tensor], batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                gen_states: Sequence[torch.Tensor], decisions: Sequence[Optional[dict]], a: dict, pre: dict,
                weights: dict, max_instances: int, opt: dict, prec: Precision, device,
                starts: Optional[Sequence[Dict[str, torch.Tensor]]] = None) -> dict:
    """Run ``len(batches)`` steps from ``p0`` (BN running statistics among
    them). ``decisions[t]``: the program's ``keeps`` (list), ``labels`` (B,
    R, C) and ``slots`` (B, H, W) of step t, or None. Returns ``grads``
    (each trainable leaf's first gradient before weight decay),
    ``opt_grads`` (with it) and ``params`` (every leaf after the last
    step), and a step's ``losses`` ({term: value}), ``tv`` ((TV_h, TV_w)),
    ``p_fg`` (B, H, W) and ``soft`` (B, R, C, K) lists, each computed at
    ``starts[t]`` where given (the program's parameters before step t),
    else at this run's own.

    ``starts`` keep the step's terms well conditioned: Adam's first updates
    move every element by about ±lr whatever the size of its gradient, so
    elements whose gradient is below its rounding error move apart by up to
    2·lr, and two runs that agree to rounding in the first step differ far
    more in the terms of the next ones. The parameters after the steps are
    compared by leaf norms, which that does not move."""
    stats_keys = {k for k in p0 if k.endswith(".mean") or k.endswith(".var")}
    p = {k: v.detach().clone().float() for k, v in p0.items()}
    train = [k for k in p if k not in stats_keys]
    m1 = {k: torch.zeros_like(p[k]) for k in train}
    m2 = {k: torch.zeros_like(p[k]) for k in train}
    lr, wd = opt["learning_rate"], opt["weight_decay"]
    b1, b2 = ref_train.BETAS
    mean = torch.tensor(pre["normalization_mean"], device=device)
    std = torch.tensor(pre["normalization_std"], device=device)
    out: dict = {"losses": [], "tv": [], "p_fg": [], "soft": [], "grads": {}, "opt_grads": {}}
    for t, ((imgs_u8, masks), state, dec) in enumerate(zip(batches, gen_states, decisions), start=1):
        gen = torch.Generator(device=device)
        gen.set_state(state)
        imgs_u8, masks = imgs_u8.to(device), masks.to(device).long()
        b, h, w = masks.shape
        flip, angle, crop = ref_train.draw(gen, b, h, w, pre)
        with torch.no_grad():
            planes = torch.cat([imgs_u8.float() / 255.0, (masks == 1).float()[..., None]], dim=-1)
            warped = ref_train.warp(planes, flip, angle, crop)
            x = (warped[..., :3] - mean) / std
            labels = torch.round(warped[..., 3]).long()
        leaves = {k: p[k].requires_grad_(True) if k in train else p[k] for k in p}
        new_stats: Dict[str, torch.Tensor] = {}
        fwd, terms = _step_terms(leaves, x, labels, dec, a, weights, max_instances, prec, new_stats)
        grads = torch.autograd.grad(terms["total"], [leaves[k] for k in train], allow_unused=True)
        if starts is not None:
            with torch.no_grad():
                start = {k: v.float() for k, v in starts[t - 1].items()}
                fwd, terms = _step_terms(start, x, labels, dec, a, weights, max_instances, prec, {})
        out["losses"].append({k: float(terms[k].detach()) for k in TERMS})
        out["tv"].append((float(terms["tv_h"].detach()), float(terms["tv_w"].detach())))
        out["p_fg"].append(terms["p_fg"].detach())
        out["soft"].append(fwd["soft"].detach())
        with torch.no_grad():
            for k, g in zip(train, grads):
                g = torch.zeros_like(p[k]) if g is None else g
                if t == 1:
                    out["grads"][k] = g.clone()
                g = g + wd * p[k]
                if t == 1:
                    out["opt_grads"][k] = g.clone()
                m1[k] = b1 * m1[k] + (1 - b1) * g
                m2[k] = b2 * m2[k] + (1 - b2) * g * g
                p[k] = p[k].detach() - lr / (1 - b1**t) * m1[k] / ((m2[k] / (1 - b2**t)).sqrt() + ref_train.EPS)
            p.update(new_stats)
    out["params"] = {k: v.detach() for k, v in p.items()}
    return out


def decision_gaps(labels: List[Optional[torch.Tensor]], slots: List[Optional[torch.Tensor]],
                  soft: List[torch.Tensor], p_fg: List[torch.Tensor], margin: float) -> Tuple[float, float, dict]:
    """The program's decisions held to the reference where its margin is
    clear: patches whose replayed region label is not the reference's argmax
    while the reference's two largest assignments differ by more than
    ``margin``; pixels the program put in an instance slot where the
    reference's foreground probability is below ``0.5 − margin``. Inf where
    a step's decisions are missing or do not fit. Also a step's largest
    margin under a flipped label and lowest probability in a slot."""
    n_labels = n_slots = 0.0
    seen: dict = {"flip_margin_steps": [], "slot_min_p_steps": []}
    for lab, sl, s, pf in zip(labels, slots, soft, p_fg):
        if lab is None or sl is None or lab.shape != s.shape[:-1] or sl.shape != pf.shape:
            return float("inf"), float("inf"), seen
        top2 = s.topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        flipped = lab.to(s.device) != s.argmax(-1)
        in_slot = sl.to(pf.device) >= 0
        n_labels += float((flipped & (gap > margin)).sum())
        n_slots += float((in_slot & (pf < 0.5 - margin)).sum())
        seen["flip_margin_steps"].append(float(torch.where(flipped, gap, 0.0).max()))
        seen["slot_min_p_steps"].append(float(torch.where(in_slot, pf, 1.0).min()))
    return n_labels, n_slots, seen
