"""Image transforms: normalization and the trainer's synced geometric
augmentation. Counterpart of ``mingraph_unet_tpu/ops/image.py`` (the port
keeps its own copy of the constants).

Every random transform of the JAX package is split in two: a draw of its
parameters, per image, from an explicit ``torch.Generator`` (``draw_*``),
and a deterministic warp that takes them. The JAX package draws from its
own PRNG, so the two streams never match; the tests feed both frameworks
the same flip, angle and crop window instead.

| JAX function | draw | warp |
|---|---|---|
| ``random_horizontal_flip`` | :func:`draw_flip` | :func:`hflip` |
| ``random_rotation`` | :func:`draw_angle` | :func:`rotate` |
| ``random_resized_crop`` | :func:`draw_crop` | :func:`resized_crop` |
| ``augment_image`` / ``augment_pair`` | :func:`draw_augment` | :func:`augment_image` / :func:`augment_pair` |

The warps are batched: images (B, H, W, C) and masks (B, H, W) with one
parameter per image. Resampling is a two-tap linear (or rounded-nearest)
gather along one axis with zero fill outside the image, which gives the
values of the JAX package's banded (rows, out, in) weight matrices (a TPU
lowering) without building them.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "normalize",
    "denormalize",
    "rgb_to_gray",
    "AugmentDraw",
    "draw_flip",
    "draw_angle",
    "draw_crop",
    "draw_augment",
    "hflip",
    "rotate",
    "resized_crop",
    "augment_image",
    "augment_pair",
]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_GRAY_WEIGHTS = (0.299, 0.587, 0.114)  # OpenCV RGB→gray


@lru_cache(maxsize=None)
def _channel_vector(values: Tuple[float, ...], dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Cached per device: a host-to-card copy inside the forward would
    synchronize the stream."""
    return torch.tensor(values, dtype=dtype, device=device)


def normalize(img: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Channel-wise normalize an image in [0, 1]: ``(img − mean) / std``."""
    return (img - _channel_vector(tuple(mean), img.dtype, img.device)) / _channel_vector(
        tuple(std), img.dtype, img.device
    )


def denormalize(img: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Invert channel-wise normalization: ``img * std + mean`` (NHWC / HWC)."""
    std_t = _channel_vector(tuple(std), img.dtype, img.device)
    return img * std_t + _channel_vector(tuple(mean), img.dtype, img.device)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """RGB→gray with OpenCV weights: (…, H, W, 3) → (…, H, W)."""
    w = _GRAY_WEIGHTS
    return w[0] * img[..., 0] + w[1] * img[..., 1] + w[2] * img[..., 2]


# ---------------------------------------------------------------------------
# Synced geometric augmentation
# ---------------------------------------------------------------------------


class AugmentDraw(NamedTuple):
    """One batch's augmentation parameters: ``flip`` (B,) bool; ``angle``
    (B,) f32 radians, the angle the three shears realize (the negated
    drawn angle, as in the JAX package); ``crop`` (B, 4) f32 windows
    ``(y0, x0, crop_h, crop_w)``, or None when cropping is off."""

    flip: torch.Tensor
    angle: torch.Tensor
    crop: Optional[torch.Tensor]


def _uniform(gen: torch.Generator, b: int, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(b, generator=gen, device=gen.device) * (hi - lo) + lo


def draw_flip(gen: torch.Generator, b: int, prob: float = 0.5) -> torch.Tensor:
    """One coin per image, heads with probability ``prob``."""
    return torch.rand(b, generator=gen, device=gen.device) < prob


def draw_angle(gen: torch.Generator, b: int, degrees: float = 15.0) -> torch.Tensor:
    """The shear angle of a rotation by U(−degrees, degrees), in radians."""
    return -_uniform(gen, b, -degrees, degrees) * (math.pi / 180.0)


def draw_crop(
    gen: torch.Generator,
    b: int,
    h: int,
    w: int,
    prob: float = 0.5,
    scale: Tuple[float, float] = (0.8, 1.0),
    ratio: Tuple[float, float] = (0.75, 4.0 / 3.0),
) -> torch.Tensor:
    """RandomResizedCrop windows (B, 4) = (y0, x0, crop_h, crop_w): area
    fraction U(scale), log aspect U(log ratio), offset uniform in what is
    left; the whole image where the coin (``prob``) says no."""
    apply = draw_flip(gen, b, prob)
    area = _uniform(gen, b, *scale)
    aspect = torch.exp(_uniform(gen, b, math.log(ratio[0]), math.log(ratio[1])))
    crop_h = torch.clamp(torch.sqrt(area / aspect) * h, 1.0, float(h))
    crop_w = torch.clamp(torch.sqrt(area * aspect) * w, 1.0, float(w))
    y0 = _uniform(gen, b, 0.0, 1.0) * (h - crop_h)
    x0 = _uniform(gen, b, 0.0, 1.0) * (w - crop_w)
    # Scalars, not a host tensor: a copy to the card would wait for its stream.
    window = [torch.where(apply, v, float(whole)) for v, whole in ((y0, 0), (x0, 0), (crop_h, h), (crop_w, w))]
    return torch.stack(window, dim=1)


def draw_augment(
    gen: torch.Generator,
    b: int,
    h: int,
    w: int,
    flip_prob: float = 0.5,
    rotation_degrees: float = 15.0,
    crop_prob: float = 0.0,
) -> AugmentDraw:
    """Flip, rotation and (when ``crop_prob > 0``) crop parameters for a
    batch of ``b`` images of ``h × w``, on the generator's device."""
    crop = draw_crop(gen, b, h, w, crop_prob) if crop_prob > 0.0 else None
    return AugmentDraw(draw_flip(gen, b, flip_prob), draw_angle(gen, b, rotation_degrees), crop)


def _resample_w(t: torch.Tensor, src: torch.Tensor, nearest: bool) -> torch.Tensor:
    """Resample (B, R, W, C) along W at positions ``src`` (B, R, W_out):
    ``Σ_u max(0, 1 − |src − u|)·t[u]`` over the valid u (two taps), or
    ``t[round(src)]``; zero outside [0, W − 1]."""
    w = t.shape[2]
    taps = [torch.round(src)] if nearest else [torch.floor(src), torch.floor(src) + 1]
    out = None
    for idx in taps:
        weight = 1.0 if nearest else torch.clamp(1.0 - torch.abs(src - idx), min=0.0)
        weight = weight * ((idx >= 0) & (idx <= w - 1))
        i = idx.clamp(0, w - 1).long()[..., None].expand(-1, -1, -1, t.shape[3])
        term = torch.gather(t, 2, i) * weight[..., None].to(t.dtype)
        out = term if out is None else out + term
    return out


def _resample_h(t: torch.Tensor, src: torch.Tensor, nearest: bool) -> torch.Tensor:
    """Resample (B, H, W, C) along H at ``src`` (B, W, H_out)."""
    return _resample_w(t.transpose(1, 2), src, nearest).transpose(1, 2)


def hflip(img: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Mirror the images (B, H, W, ...) whose ``flip`` is set."""
    sel = flip.reshape(-1, *([1] * (img.dim() - 1)))
    return torch.where(sel, img.flip(2), img)


def rotate(img: torch.Tensor, angle: torch.Tensor, nearest: bool = False) -> torch.Tensor:
    """Rotation about the center by three shears, ``Sx(tan θ/2)·Sy(−sin θ)·
    Sx(tan θ/2)``, each a 1-D linear (or nearest) resampling with zero
    fill: (B, H, W, C), ``angle`` θ (B,) as :func:`draw_angle` gives it."""
    b, h, w, _ = img.shape
    dev = img.device
    ar_h = torch.arange(h, dtype=torch.float32, device=dev)
    ar_w = torch.arange(w, dtype=torch.float32, device=dev)
    alpha = torch.tan(angle / 2.0)[:, None]
    beta = -torch.sin(angle)[:, None]
    # Row y is resampled at x + alpha·(y − cy); column x at y + beta·(x − cx).
    cols = ar_w[None, None, :] + (alpha * (ar_h - (h - 1) / 2.0))[:, :, None]
    rows = ar_h[None, None, :] + (beta * (ar_w - (w - 1) / 2.0))[:, :, None]
    img = _resample_w(img, cols, nearest)
    img = _resample_h(img, rows, nearest)
    return _resample_w(img, cols, nearest)


def resized_crop(img: torch.Tensor, window: torch.Tensor, nearest: bool = False) -> torch.Tensor:
    """Resample each image's window (y0, x0, crop_h, crop_w) back to the
    full size, bilinear (separable: rows, then columns) or nearest, zero
    fill: (B, H, W, C)."""
    b, h, w, _ = img.shape
    dev = img.device
    y0, x0, ch, cw = window.unbind(1)
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h * ch[:, None] + y0[:, None] - 0.5
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w * cw[:, None] + x0[:, None] - 0.5
    img = _resample_h(img, ys[:, None, :].expand(b, w, h), nearest)
    return _resample_w(img, xs[:, None, :].expand(b, h, w), nearest)


def augment_image(img: torch.Tensor, draw: AugmentDraw) -> torch.Tensor:
    """Flip, rotation and optional crop, every channel of (B, H, W, C)
    resampled linearly: the binary-mask path packs the mask as an extra
    channel and rounds it afterwards."""
    img = rotate(hflip(img, draw.flip), draw.angle)
    return img if draw.crop is None else resized_crop(img, draw.crop)


def augment_pair(img: torch.Tensor, mask: torch.Tensor, draw: AugmentDraw) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`augment_image` for images (B, H, W, C) with the same geometry
    on label masks (B, H, W), which are resampled nearest."""
    m = hflip(mask, draw.flip)[..., None].float()
    m = rotate(m, draw.angle, nearest=True)
    if draw.crop is not None:
        m = resized_crop(m, draw.crop, nearest=True)
    return augment_image(img, draw), torch.round(m[..., 0]).to(mask.dtype)
