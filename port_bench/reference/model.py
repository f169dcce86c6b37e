"""The U-Net and the MinGraph-UNet pipeline in plain PyTorch, NHWC.

Written from the model's equations at full resolution: no space-to-depth
layout, no folded decoder conv, no kernel. Parameters are a flat dict
under the flax tree's names (``unet.encoder.block0.conv1.kernel``, ...),
conv kernels HWIO and dense kernels (in, out); :func:`param_spec` lists
them for a configuration, with the kind that sets how the benchmark draws
them.

Eval mode folds each BatchNorm into its conv (``k·a``, ``b·a + c`` with
``a = scale / sqrt(var + eps)``, ``c = bias − mean·a``). Train mode
normalizes by the batch's statistics (biased variance) and returns the
running statistics ``0.9·running + 0.1·batch``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference.numerics import Precision

Params = Dict[str, torch.Tensor]
BN_EPS = 1e-5
BN_MOMENTUM = 0.9
GAT_ALPHA = 0.2
DIRECTIONS = ((-1, 0), (1, 0), (0, -1), (0, 1))  # incoming neighbour (r + dr, c + dc) → (r, c)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _conv_block_spec(pre: str, cin: int, f: int, bn: bool) -> List[Tuple[str, Tuple[int, ...], str]]:
    out = []
    for i, c in ((1, cin), (2, f)):
        out += [(f"{pre}.conv{i}.kernel", (3, 3, c, f), "kernel"), (f"{pre}.conv{i}.bias", (f,), "bias")]
    if bn:
        for i in (1, 2):
            out += [(f"{pre}.bn{i}.{leaf}", (f,), f"bn_{leaf}") for leaf in ("scale", "bias", "mean", "var")]
    return out


def unet_spec(prefix: str, in_ch: int, classes: int, init: int, depth: int, bn: bool = True):
    """(name, shape, kind) of every U-Net leaf, in the port's order."""
    spec = []
    cin, f = in_ch, init
    for i in range(depth):
        spec += _conv_block_spec(f"{prefix}encoder.block{i}", cin, f, bn)
        cin, f = f, 2 * f
    spec += _conv_block_spec(f"{prefix}encoder.bottleneck", cin, f, bn)
    prev = init * 2**depth
    for j, i in enumerate(reversed(range(depth))):
        out = init * 2**i
        pre = f"{prefix}decoder.block{j}"
        spec += [(f"{pre}.upsample.kernel", (2, 2, prev, prev // 2), "kernel"),
                 (f"{pre}.upsample.bias", (prev // 2,), "bias")]
        spec += _conv_block_spec(f"{pre}.conv_block", out + prev // 2, out, bn)
        prev = out
    spec += [(f"{prefix}decoder.final_conv.kernel", (1, 1, prev, classes), "kernel"),
             (f"{prefix}decoder.final_conv.bias", (classes,), "bias")]
    return spec


def _dense(name: str, i: int, o: int):
    return [(f"{name}.kernel", (i, o), "kernel"), (f"{name}.bias", (o,), "bias")]


def _gat(name: str, i: int, o: int, heads: int):
    return [(f"{name}.layer0.heads.W", (heads, i, o), "gat_W"), (f"{name}.layer0.heads.a_src", (heads, o), "gat_a"),
            (f"{name}.layer0.heads.a_dst", (heads, o), "gat_a")]


def pipeline_spec(a: dict):
    """The MinGraph-UNet's leaves for the constructor arguments ``a`` (one
    GAT layer each, the pooled single-box head)."""
    init, gat_out, heads = a["init_features"], a["gat_output_dim"], a["gat_num_heads"]
    if a.get("gat_num_layers", 1) != 1:
        raise ValueError("the reference pipeline has one GAT layer per graph stage")
    spec = unet_spec("unet.", a.get("in_channels", 3), a["num_classes"], init, a["depth"])
    spec += _dense("patch_feature_proj", init, a["unet_patch_feature_dim"])
    spec += _gat("patch_gat", a["unet_patch_feature_dim"] + 4, gat_out, heads)
    spec += _dense("feature_consistency_proj", init, gat_out)
    spec += _gat("mincut.segment_predictor.gnn_predictor", gat_out, a["num_segments"], max(1, heads // 2))
    spec += _gat("region_gat", gat_out, gat_out, heads)
    c = init + gat_out
    fc = a["fc_hidden_dim"]
    spec += [("detection_head.conv1.kernel", (3, 3, c, c // 2), "kernel"), ("detection_head.conv1.bias", (c // 2,), "bias")]
    spec += [(f"detection_head.bn1.{x}", (c // 2,), f"bn_{x}") for x in ("scale", "bias", "mean", "var")]
    spec += [("detection_head.conv2.kernel", (3, 3, c // 2, c // 4), "kernel"),
             ("detection_head.conv2.bias", (c // 4,), "bias")]
    spec += [(f"detection_head.bn2.{x}", (c // 4,), f"bn_{x}") for x in ("scale", "bias", "mean", "var")]
    spec += _dense("detection_head.fc1", c // 4, fc) + _dense("detection_head.fc2", fc, fc // 2)
    spec += _dense("detection_head.fc_bbox", fc // 2, 4) + _dense("detection_head.fc_confidence", fc // 2, 1)
    return spec


# ---------------------------------------------------------------------------
# Products
# ---------------------------------------------------------------------------


def conv2d(x: torch.Tensor, k: torch.Tensor, b: Optional[torch.Tensor], prec: Precision, pad: int = 1):
    """'SAME' (pad 1 for 3×3, 0 for 1×1) conv of NHWC x with HWIO k."""
    y = F.conv2d(prec.q(x).permute(0, 3, 1, 2), prec.q(k).permute(3, 2, 0, 1), b, padding=pad)
    return y.permute(0, 2, 3, 1)


def conv_transpose2x2(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    """flax ConvTranspose(2×2, stride 2, VALID): output pixel (2i + a, 2j + c)
    is x[i, j] times the kernel tap (1 − a, 1 − c)."""
    n, h, w, _ = x.shape
    kf = prec.q(k).flip(0, 1)
    y = torch.einsum("nijc,abco->niajbo", prec.q(x), kf).reshape(n, 2 * h, 2 * w, k.shape[-1])
    return y + b


def dense(x: torch.Tensor, p: Params, name: str, prec: Precision) -> torch.Tensor:
    return prec.q(x) @ prec.q(p[f"{name}.kernel"]) + p[f"{name}.bias"]


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def patch_mean(x: torch.Tensor, p: int) -> torch.Tensor:
    n, h, w, c = x.shape
    return x.reshape(n, h // p, p, w // p, p, c).mean(dim=(2, 4))


# ---------------------------------------------------------------------------
# U-Net
# ---------------------------------------------------------------------------


def _bn_affine(p: Params, pre: str, mean: torch.Tensor, var: torch.Tensor):
    a = p[f"{pre}.scale"] * torch.rsqrt(var + BN_EPS)
    return a, p[f"{pre}.bias"] - mean * a


def _block(p: Params, pre: str, x: torch.Tensor, prec: Precision, stats: Optional[Params]) -> torch.Tensor:
    """(conv 3×3 → BN → ReLU) × 2. ``stats`` None: eval, BN folded into the
    conv; a dict: train, batch statistics, the new running ones put in it."""
    for i in (1, 2):
        k, b = p[f"{pre}.conv{i}.kernel"], p[f"{pre}.conv{i}.bias"]
        bn = f"{pre}.bn{i}"
        if f"{bn}.scale" not in p:
            x = torch.relu(conv2d(x, k, b, prec))
        elif stats is None:
            a, c = _bn_affine(p, bn, p[f"{bn}.mean"], p[f"{bn}.var"])
            x = torch.relu(conv2d(x, k * a, b * a + c, prec))
        else:
            z = conv2d(x, k, b, prec)
            mean = z.mean(dim=(0, 1, 2))
            var = torch.clamp((z * z).mean(dim=(0, 1, 2)) - mean * mean, min=0.0)
            with torch.no_grad():
                stats[f"{bn}.mean"] = BN_MOMENTUM * p[f"{bn}.mean"] + (1 - BN_MOMENTUM) * mean
                stats[f"{bn}.var"] = BN_MOMENTUM * p[f"{bn}.var"] + (1 - BN_MOMENTUM) * var
            a, c = _bn_affine(p, bn, mean, var)
            x = torch.relu(z * a + c)
    return x


def unet(p: Params, x: torch.Tensor, depth: int, prec: Precision, prefix: str = "",
         stats: Optional[Params] = None) -> Dict[str, torch.Tensor]:
    """``{"logits", "skip0", "f_u0"}``: the logits, level 0's encoder output
    and the last decoder output, all at full resolution."""
    skips = []
    for i in range(depth):
        x = _block(p, f"{prefix}encoder.block{i}", x, prec, stats)
        skips.append(x)
        x = max_pool2(x)
    x = _block(p, f"{prefix}encoder.bottleneck", x, prec, stats)
    for j, i in enumerate(reversed(range(depth))):
        pre = f"{prefix}decoder.block{j}"
        up = conv_transpose2x2(x, p[f"{pre}.upsample.kernel"], p[f"{pre}.upsample.bias"], prec)
        x = _block(p, f"{pre}.conv_block", torch.cat([skips[i], up], dim=-1), prec, stats)
    logits = conv2d(x, p[f"{prefix}decoder.final_conv.kernel"], p[f"{prefix}decoder.final_conv.bias"], prec, pad=0)
    return {"logits": logits, "skip0": skips[0], "f_u0": x}


# ---------------------------------------------------------------------------
# Patch features
# ---------------------------------------------------------------------------


def sobel_patch_mean(rgb255: torch.Tensor, p: int) -> torch.Tensor:
    """Per-patch mean of the 3×3 Sobel magnitude of the gray image (reflect-101
    border), min-max normalized per image to [0, 1]: (B, H/p, W/p, 1)."""
    gray = 0.299 * rgb255[..., 0] + 0.587 * rgb255[..., 1] + 0.114 * rgb255[..., 2]
    kx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], device=gray.device)
    k = torch.stack([kx, kx.t()])[:, None]
    g = F.conv2d(F.pad(gray[:, None], (1, 1, 1, 1), mode="reflect"), k)
    mag = torch.sqrt(g[:, 0] ** 2 + g[:, 1] ** 2)
    mn, mx = mag.amin(dim=(1, 2)), mag.amax(dim=(1, 2))
    mean = patch_mean(mag[..., None], p)[..., 0]
    return ((mean - mn[:, None, None]) / torch.clamp(mx - mn, min=1e-12)[:, None, None])[..., None]


def equalize_luma(rgb_u8: torch.Tensor) -> torch.Tensor:
    """OpenCV ``equalizeHist`` on the luma of (B, H, W, 3) uint8 in YUV space
    (analog coefficients), back to uint8 RGB."""
    rgb = rgb_u8.float()
    r, g, b = rgb.unbind(-1)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.14713 * r - 0.28886 * g + 0.436 * b
    v = 0.615 * r - 0.51499 * g - 0.10001 * b
    y8 = torch.clamp(torch.round(y), 0, 255).long().reshape(y.shape[0], -1)
    n = y8.shape[1]
    hist = torch.zeros((y8.shape[0], 256), dtype=torch.int64, device=y8.device).scatter_add_(1, y8, torch.ones_like(y8))
    cdf = torch.cumsum(hist, dim=1).float()
    cdf_min = torch.where(hist > 0, cdf, torch.full_like(cdf, n + 1.0)).amin(dim=1, keepdim=True)
    lut = torch.clamp(torch.round((cdf - cdf_min) / torch.clamp(n - cdf_min, min=1.0) * 255.0), 0.0, 255.0)
    ye = torch.gather(lut, 1, y8).reshape(y.shape)
    out = torch.stack([ye + 1.13983 * v, ye - 0.39465 * u - 0.58060 * v, ye + 2.03211 * u], dim=-1)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# Graph branch and heads
# ---------------------------------------------------------------------------


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, GAT_ALPHA * x)


def _shift(x: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """(..., R, C, D) with (r, c) holding (r + dr, c + dc); zeros off the grid."""
    r, c = x.shape[-3], x.shape[-2]
    out = torch.zeros_like(x)
    rs, rd = (slice(dr, r), slice(0, r - dr)) if dr >= 0 else (slice(0, r + dr), slice(-dr, r))
    cs, cd = (slice(dc, c), slice(0, c - dc)) if dc >= 0 else (slice(0, c + dc), slice(-dc, c))
    out[..., rd, cd, :] = x[..., rs, cs, :]
    return out


def lattice_gat(p: Params, name: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """One averaging GAT layer over the 4-connected lattice of (B, R, C, D):
    per head the softmax over the incoming neighbours of ``LeakyReLU(a_src·
    Wh_j + a_dst·Wh_i)`` less the head's maximum over every edge, 1e-10
    added to the denominator, ELU, mean over heads."""
    w, a_src, a_dst = (p[f"{name}.layer0.heads.{k}"] for k in ("W", "a_src", "a_dst"))
    h = torch.einsum("brcd,hdo->bhrco", prec.q(x), prec.q(w))
    s_src = torch.einsum("bhrco,ho->bhrc", prec.q(h), prec.q(a_src))
    s_dst = torch.einsum("bhrco,ho->bhrc", prec.q(h), prec.q(a_dst))
    ones = torch.ones(x.shape[1:3] + (1,), device=x.device)
    nh = torch.stack([_shift(h, dr, dc) for dr, dc in DIRECTIONS], dim=-2)  # (b, h, r, c, 4, o)
    ns = torch.stack([_shift(s_src[..., None], dr, dc)[..., 0] for dr, dc in DIRECTIONS], dim=-1)
    valid = torch.stack([_shift(ones, dr, dc)[..., 0] for dr, dc in DIRECTIONS], dim=-1) > 0
    e = _leaky(ns + s_dst[..., None])
    gmax = torch.where(valid, e, torch.full_like(e, float("-inf"))).amax(dim=(-3, -2, -1), keepdim=True)
    ex = torch.where(valid, torch.exp(e - gmax), torch.zeros_like(e))
    attn = ex / (ex.sum(dim=-1, keepdim=True) + 1e-10)
    out = F.elu(torch.einsum("bhrck,bhrcko->bhrco", prec.q(attn), prec.q(nh)))
    return out.mean(dim=1)


def dense_gat_all_pairs(p: Params, name: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """One averaging GAT layer over the complete graph without self-loops
    of (B, N, D)."""
    w, a_src, a_dst = (p[f"{name}.layer0.heads.{k}"] for k in ("W", "a_src", "a_dst"))
    n = x.shape[1]
    h = torch.einsum("bnd,hdo->bhno", prec.q(x), prec.q(w))
    s_src = torch.einsum("bhno,ho->bhn", prec.q(h), prec.q(a_src))
    s_dst = torch.einsum("bhno,ho->bhn", prec.q(h), prec.q(a_dst))
    e = _leaky(s_src[..., None, :] + s_dst[..., :, None])  # (b, h, target, source)
    mask = ~torch.eye(n, dtype=torch.bool, device=x.device)
    gmax = torch.where(mask, e, torch.full_like(e, float("-inf"))).amax(dim=(-2, -1), keepdim=True)
    ex = torch.where(mask, torch.exp(e - gmax), torch.zeros_like(e))
    attn = ex / (ex.sum(dim=-1, keepdim=True) + 1e-10)
    return F.elu(torch.einsum("bhji,bhio->bhjo", prec.q(attn), prec.q(h))).mean(dim=1)


def detection_head(p: Params, x: torch.Tensor, prec: Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv → ReLU → BN, twice; global mean; two ReLU FCs; sigmoid box (B, 4)
    and confidence (B, 1)."""
    for i in (1, 2):
        z = torch.relu(conv2d(x, p[f"detection_head.conv{i}.kernel"], p[f"detection_head.conv{i}.bias"], prec))
        pre = f"detection_head.bn{i}"
        a, c = _bn_affine(p, pre, p[f"{pre}.mean"], p[f"{pre}.var"])
        x = z * a + c
    x = x.mean(dim=(1, 2))
    x = torch.relu(dense(x, p, "detection_head.fc1", prec))
    x = torch.relu(dense(x, p, "detection_head.fc2", prec))
    return (torch.sigmoid(dense(x, p, "detection_head.fc_bbox", prec)),
            torch.sigmoid(dense(x, p, "detection_head.fc_confidence", prec)))


def pipeline(p: Params, images_u8: torch.Tensor, a: dict, mean: Sequence[float], std: Sequence[float],
             prec: Precision, labels: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The serving forward of (B, H, W, 3) uint8 tiles in eval mode, with the
    detection head on the patch-pooled features (``detection_pre_pool`` ==
    H / patch_size). Returns the compared outputs and ``hard_patch_labels``,
    the argmax of the soft assignments. ``labels`` (B, H/p, W/p), when
    given, replace that argmax in the region pooling: the discrete decision
    of the run being judged, replayed."""
    ps, k = a["patch_size"], a["num_segments"]
    m = torch.tensor(mean, device=images_u8.device)
    s = torch.tensor(std, device=images_u8.device)
    images = (images_u8.float() / 255.0 - m) / s
    u = unet(p, images, a["depth"], prec, prefix="unet.")
    unet_patch = dense(patch_mean(u["skip0"], ps), p, "patch_feature_proj", prec)
    rgb255 = torch.clamp(images * s + m, 0.0, 1.0) * 255.0
    histeq = equalize_luma(torch.clamp(torch.round(rgb255), 0, 255).to(torch.uint8)).float() / 255.0
    feats = torch.cat([unet_patch, sobel_patch_mean(rgb255, ps), patch_mean(histeq, ps)], dim=-1)
    gat = lattice_gat(p, "patch_gat", feats, prec)
    seg_logits = lattice_gat(p, "mincut.segment_predictor.gnn_predictor", gat, prec)
    soft = torch.softmax(seg_logits, dim=-1)
    b, r, c, d = gat.shape
    hard = torch.argmax(soft, dim=-1)
    labels = (hard if labels is None else labels.to(hard.device)).reshape(b, r * c)
    onehot = (labels[..., None] == torch.arange(k, device=labels.device)).float()  # (b, n, k)
    sums = torch.einsum("bnk,bnd->bkd", onehot, gat.reshape(b, r * c, d))
    region_feats = sums / torch.clamp(onehot.sum(dim=1), min=1.0)[..., None]
    region = dense_gat_all_pairs(p, "region_gat", region_feats, prec)
    f_g = torch.einsum("bnk,bkd->bnd", onehot, region).reshape(b, r, c, d)
    det_in = torch.cat([patch_mean(u["f_u0"], ps), f_g], dim=-1)
    bbox, conf = detection_head(p, det_in, prec)
    return {"logits": u["logits"], "gat_feats": gat, "soft_assignments": soft, "region_embeddings": region,
            "pred_bboxes": bbox, "pred_confidence": conf, "hard_patch_labels": hard}
