"""The segmentation trainer's step in plain PyTorch: augmentation drawn
from the step's generator, normalization, the U-Net in train mode, cross
entropy + ``dice_weight``·soft Dice, autograd, and Adam with L2 weight
decay folded into the gradient (PyTorch's ``Adam(weight_decay=...)``).

The augmentation draws follow the trainer's order on a generator in the
state the benchmark recorded before the step: the crop window when
cropping is on (coin, area, log aspect, y offset, x offset), the flip
coin, the angle. The warps are written from their definitions: horizontal
flip; rotation about the centre by three shears, each a two-tap linear
resampling with zero fill; the crop window resampled back to full size.
The mask rides as a fourth channel of the linear warps and is rounded.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from port_bench.reference import model as ref
from port_bench.reference.numerics import Precision

BETAS, EPS = (0.9, 0.999), 1e-8
CROP_SCALE, CROP_RATIO = (0.8, 1.0), (0.75, 4.0 / 3.0)


def _uniform(gen: torch.Generator, b: int, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(b, generator=gen, device=gen.device) * (hi - lo) + lo


def draw(gen: torch.Generator, b: int, h: int, w: int, pre: dict):
    """(flip (B,) bool, shear angle (B,) radians, crop windows (B, 4) or None)."""
    crop = None
    if pre["random_crop_prob"] > 0:
        apply = torch.rand(b, generator=gen, device=gen.device) < pre["random_crop_prob"]
        area = _uniform(gen, b, *CROP_SCALE)
        aspect = torch.exp(_uniform(gen, b, math.log(CROP_RATIO[0]), math.log(CROP_RATIO[1])))
        ch = torch.clamp(torch.sqrt(area / aspect) * h, 1.0, float(h))
        cw = torch.clamp(torch.sqrt(area * aspect) * w, 1.0, float(w))
        y0 = _uniform(gen, b, 0.0, 1.0) * (h - ch)
        x0 = _uniform(gen, b, 0.0, 1.0) * (w - cw)
        crop = torch.stack([torch.where(apply, y0, 0.0), torch.where(apply, x0, 0.0),
                            torch.where(apply, ch, float(h)), torch.where(apply, cw, float(w))], dim=1)
    flip = torch.rand(b, generator=gen, device=gen.device) < pre["horizontal_flip_prob"]
    deg = pre["rotation_degrees"]
    angle = -_uniform(gen, b, -deg, deg) * (math.pi / 180.0)
    return flip, angle, crop


def _lerp_w(t: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """(B, R, W, C) sampled along W at ``src`` (B, R, W_out), linear, zero
    outside [0, W − 1]."""
    w = t.shape[2]
    i0 = torch.floor(src)
    f = src - i0
    out = 0.0
    for idx, wt in ((i0, 1.0 - f), (i0 + 1.0, f)):
        wt = wt * ((idx >= 0) & (idx <= w - 1))
        g = torch.gather(t, 2, idx.clamp(0, w - 1).long()[..., None].expand(-1, -1, -1, t.shape[3]))
        out = out + g * wt[..., None]
    return out


def _lerp_h(t: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    return _lerp_w(t.transpose(1, 2), src).transpose(1, 2)


def warp(img: torch.Tensor, flip: torch.Tensor, angle: torch.Tensor, crop) -> torch.Tensor:
    b, h, w, _ = img.shape
    dev = img.device
    img = torch.where(flip[:, None, None, None], img.flip(2), img)
    ys, xs = torch.arange(h, dtype=torch.float32, device=dev), torch.arange(w, dtype=torch.float32, device=dev)
    alpha, beta = torch.tan(angle / 2.0)[:, None], -torch.sin(angle)[:, None]
    cols = xs[None, None, :] + (alpha * (ys - (h - 1) / 2.0))[:, :, None]  # row y sampled at x + α(y − cy)
    rows = ys[None, None, :] + (beta * (xs - (w - 1) / 2.0))[:, :, None]   # column x at y + β(x − cx)
    img = _lerp_w(_lerp_h(_lerp_w(img, cols), rows), cols)
    if crop is None:
        return img
    y0, x0, ch, cw = crop.unbind(1)
    sy = (ys + 0.5) / h * ch[:, None] + y0[:, None] - 0.5
    sx = (xs + 0.5) / w * cw[:, None] + x0[:, None] - 0.5
    img = _lerp_h(img, sy[:, None, :].expand(b, w, h))
    return _lerp_w(img, sx[:, None, :].expand(b, h, w))


def loss_terms(logits: torch.Tensor, labels: torch.Tensor, dice_weight: float):
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, labels[..., None]).mean()
    probs = logp.exp()
    onehot = (labels[..., None] == torch.arange(logits.shape[-1], device=labels.device)).float()
    inter = (probs * onehot).sum(dim=(1, 2))
    union = probs.sum(dim=(1, 2)) + onehot.sum(dim=(1, 2))
    dice = 1.0 - ((2.0 * inter + 1.0) / (union + 1.0)).mean()
    return ce + dice_weight * dice, ce, dice


def train_steps(p0: Dict[str, torch.Tensor], batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                gen_states: Sequence[torch.Tensor], depth: int, pre: dict, opt: dict, dice_weight: float,
                prec: Precision, device) -> dict:
    """Run ``len(batches)`` steps from the parameters ``p0`` (BN running
    statistics among them). Returns ``losses`` [(loss, ce, dice)] a step,
    ``grads`` (each trainable leaf's first-step gradient before weight
    decay), ``opt_grads`` (the first step's gradient as Adam gets it, decay
    included), ``params`` (every leaf after the last step)."""
    stats = {k for k in p0 if k.endswith(".mean") or k.endswith(".var")}
    p = {k: v.detach().clone().float() for k, v in p0.items()}
    train = [k for k in p if k not in stats]
    m = {k: torch.zeros_like(p[k]) for k in train}
    v = {k: torch.zeros_like(p[k]) for k in train}
    lr, wd = opt["learning_rate"], opt["weight_decay"]
    out = {"losses": [], "grads": {}, "opt_grads": {}}
    mean, std = torch.tensor(pre["normalization_mean"], device=device), torch.tensor(pre["normalization_std"], device=device)
    for t, ((imgs_u8, masks), state) in enumerate(zip(batches, gen_states), start=1):
        gen = torch.Generator(device=device)
        gen.set_state(state)
        imgs_u8, masks = imgs_u8.to(device), masks.to(device).long()
        b, h, w = masks.shape
        flip, angle, crop = draw(gen, b, h, w, pre)
        with torch.no_grad():
            planes = torch.cat([imgs_u8.float() / 255.0, (masks == 1).float()[..., None]], dim=-1)
            warped = warp(planes, flip, angle, crop)
            x = (warped[..., :3] - mean) / std
            labels = torch.round(warped[..., 3]).long()
        leaves = {k: p[k].requires_grad_(True) if k in train else p[k] for k in p}
        new_stats: Dict[str, torch.Tensor] = {}
        logits = ref.unet(leaves, x, depth, prec, stats=new_stats)["logits"]
        loss, ce, dice = loss_terms(logits, labels, dice_weight)
        grads = torch.autograd.grad(loss, [leaves[k] for k in train])
        out["losses"].append((loss.detach(), ce.detach(), dice.detach()))
        with torch.no_grad():
            for k, g in zip(train, grads):
                if t == 1:
                    out["grads"][k] = g.clone()
                g = g + wd * p[k]
                if t == 1:
                    out["opt_grads"][k] = g.clone()
                m[k] = BETAS[0] * m[k] + (1 - BETAS[0]) * g
                v[k] = BETAS[1] * v[k] + (1 - BETAS[1]) * g * g
                denom = (v[k] / (1 - BETAS[1] ** t)).sqrt() + EPS
                p[k] = p[k].detach() - lr / (1 - BETAS[0] ** t) * m[k] / denom
            p.update(new_stats)
    out["params"] = {k: x.detach() for k, x in p.items()}
    return out


def leaf_norm_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                   keys: List[str]) -> Tuple[float, str]:
    """The worst leaf's | ‖got‖ − ‖want‖ | over max(‖want‖, the median
    leaf's ‖want‖), and that leaf's name."""
    norms = {k: float(want[k].double().norm()) for k in keys}
    med = sorted(norms.values())[len(norms) // 2]
    worst, name = 0.0, ""
    for k in keys:
        gap = abs(float(got[k].double().norm()) - norms[k]) / max(norms[k], med, 1e-30)
        if gap >= worst:
            worst, name = gap, k
    return worst, name
