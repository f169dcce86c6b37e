"""Auxiliary patch features: Sobel magnitude and histogram equalization.
Counterpart of ``mingraph_unet_tpu/ops/filters.py`` for the functions the
model runs.

- :func:`sobel_patch_mean` computes the Sobel patch feature the direct way:
  gray, reflect-101 pad, 3×3 stencil, magnitude, per-image min/max, patch
  mean (the JAX package's lane-flattened form is a TPU layout device). Other
  odd sizes (and :func:`sobel_magnitude`) take OpenCV's derivative kernels
  (:func:`sobel_kernels`) as a depthwise 'VALID' conv after a reflect-101
  pad, as JAX's XLA conv.
- :func:`equalize_histogram_rgb_batched` is OpenCV ``equalizeHist`` on the
  luma in YUV space, bit-exact with the JAX package's nibble-factored form.
  The luma goes as uint8 to ``ops/kernels/histeq.py::equalize_channel``,
  the K6 kernel on the card and its plain version on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mingraph_unet_tpu_torch.ops.image import rgb_to_gray
from mingraph_unet_tpu_torch.ops.kernels.histeq import equalize_channel

__all__ = ["sobel_kernels", "sobel_magnitude", "sobel_patch_mean", "equalize_histogram_rgb_batched"]

# OpenCV RGB↔YUV (analog, 8-bit offset 128) coefficients.
_RGB2YUV = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.14713, -0.28886, 0.436],
        [0.615, -0.51499, -0.10001],
    ]
)
_YUV2RGB = np.array(
    [
        [1.0, 0.0, 1.13983],
        [1.0, -0.39465, -0.58060],
        [1.0, 2.03211, 0.0],
    ]
)


def sobel_kernels(ksize: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's Sobel derivative kernels ``(kx, ky)`` of size ``ksize`` (odd,
    at least 3), as ``cv2.getDerivKernels`` builds them: the binomial
    smoothing row outer the binomial first difference, in f64."""
    if ksize % 2 == 0 or ksize < 3:
        raise ValueError("ksize must be odd and >= 3")

    def deriv(order: int) -> np.ndarray:
        k = np.array([1.0])
        for _ in range(ksize - 1 - order):
            k = np.convolve(k, [1.0, 1.0])
        for _ in range(order):
            k = np.convolve(k, [1.0, -1.0])
        return k[::-1].copy()  # increasing x: [-1, 0, 1]

    d, sm = deriv(1), deriv(0)
    return np.outer(sm, d), np.outer(d, sm)


def _sobel_stencil3(gray: torch.Tensor) -> torch.Tensor:
    """The 3×3 Sobel magnitude of (B, H, W) gray by its eight shifted views."""
    h, w = gray.shape[-2:]
    g = F.pad(gray[:, None], (1, 1, 1, 1), mode="reflect")[:, 0]  # reflect-101

    def sh(dy: int, dx: int) -> torch.Tensor:
        return g[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    tl, t, tr = sh(-1, -1), sh(-1, 0), sh(-1, 1)
    l, r = sh(0, -1), sh(0, 1)
    bl, bo, br = sh(1, -1), sh(1, 0), sh(1, 1)
    gx = (tr + 2.0 * r + br) - (tl + 2.0 * l + bl)
    gy = (bl + 2.0 * bo + br) - (tl + 2.0 * t + tr)
    return torch.sqrt(gx * gx + gy * gy)


def _sobel_raw(gray: torch.Tensor, ksize: int) -> torch.Tensor:
    """The Sobel magnitude of (B, H, W) f32 gray, unnormalized."""
    if ksize == 3:
        return _sobel_stencil3(gray)
    kx, ky = sobel_kernels(ksize)
    pad = ksize // 2
    k = torch.from_numpy(np.stack([kx, ky])[:, None]).to(gray)  # (2, 1, k, k)
    g = F.conv2d(F.pad(gray[:, None], (pad, pad, pad, pad), mode="reflect"), k)  # reflect-101, VALID
    return torch.sqrt(g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1])


def sobel_magnitude(rgb: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """The Sobel edge magnitude of RGB images in [0, 255] (HWC or NHWC,
    float or uint8), min-max normalized per image to [0, 255]: f32 HW or
    NHW, as OpenCV's gray → CV_64F Sobel → ``NORM_MINMAX``."""
    single = rgb.dim() == 3
    gray = rgb_to_gray((rgb[None] if single else rgb).float())
    mag = _sobel_raw(gray, ksize)
    mn = mag.amin(dim=(-2, -1), keepdim=True)
    mx = mag.amax(dim=(-2, -1), keepdim=True)
    out = (mag - mn) / torch.clamp(mx - mn, min=1e-12) * 255.0
    return out[0] if single else out


def sobel_patch_mean(rgb: torch.Tensor, patch_size: int, ksize: int = 3) -> torch.Tensor:
    """Per-patch mean of the min-max-normalized Sobel magnitude of kernel
    size ``ksize``, in [0, 1]: (B, H, W, 3) in [0, 255] → (B, H/p, W/p, 1)
    f32. The normalization folds through the patch mean, exactly."""
    b, h, w, _ = rgb.shape
    mag = _sobel_raw(rgb_to_gray(rgb.float()), ksize)  # (B, H, W)
    mn = mag.amin(dim=(1, 2))
    mx = mag.amax(dim=(1, 2))
    p = patch_size
    mean = mag.reshape(b, h // p, p, w // p, p).mean(dim=(2, 4))
    # mean((m − mn)/(mx − mn)·255)/255 = (mean(m) − mn)/(mx − mn)
    out = (mean - mn[:, None, None]) / torch.clamp(mx - mn, min=1e-12)[:, None, None]
    return out[..., None]


def equalize_histogram_rgb_batched(rgb_u8: torch.Tensor) -> torch.Tensor:
    """Equalize the luma of (B, H, W, 3) uint8 images in YUV space →
    (B, H, W, 3) uint8."""
    rgb = rgb_u8.float()
    r, g, bl = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    m = _RGB2YUV
    y = float(m[0, 0]) * r + float(m[0, 1]) * g + float(m[0, 2]) * bl
    u = float(m[1, 0]) * r + float(m[1, 1]) * g + float(m[1, 2]) * bl
    v = float(m[2, 0]) * r + float(m[2, 1]) * g + float(m[2, 2]) * bl
    y_u8 = torch.clamp(torch.round(y), 0, 255).to(torch.uint8)
    y_eq = equalize_channel(y_u8).float()
    mi = _YUV2RGB
    r2 = float(mi[0, 0]) * y_eq + float(mi[0, 2]) * v
    g2 = float(mi[1, 0]) * y_eq + float(mi[1, 1]) * u + float(mi[1, 2]) * v
    b2 = float(mi[2, 0]) * y_eq + float(mi[2, 1]) * u
    rgb_eq = torch.stack([r2, g2, b2], dim=-1)
    return torch.clamp(torch.round(rgb_eq), 0, 255).to(torch.uint8)
