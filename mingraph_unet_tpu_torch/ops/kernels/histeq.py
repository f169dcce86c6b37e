"""Histogram equalization of the luma as a hand-written CUDA kernel (K6),
with its plain PyTorch version. Counterpart of
``mingraph_unet_tpu/ops/pallas/histeq.py``.

:func:`equalize_channel` replaces ``equalize_channel_pallas``: OpenCV
``equalizeHist`` per image on (B, H, W) uint8 luma → (B, H, W) uint8. The
kernel (``csrc/histeq.cu``) is one launch with one thread block cluster per
image: each block counts its slice of the image into shared memory, the
cluster sums the counts through distributed shared memory, and every block
builds the image's LUT and maps its slice, bit-exact with the plain
version; nothing but y and the output touches device memory. It takes the
luma as one byte per pixel and any H·W up to 2^24 (its CDF is exact in f32
up to there).
"""

from __future__ import annotations

import torch

from mingraph_unet_tpu_torch.ops.kernels.build import check_cuda_input, library, require, stream_ptr
from mingraph_unet_tpu_torch.utils.profiling import span

__all__ = ["MAX_PIXELS", "equalize_channel", "equalize_channel_plain"]

MAX_PIXELS = 1 << 24  # counts, and so the f32 CDF, are exact up to here


def equalize_channel_plain(y_u8: torch.Tensor) -> torch.Tensor:
    """OpenCV ``equalizeHist`` per image on (B, H, W) uint8 → uint8: the
    LUT ``round((cdf − cdf_min) / max(N − cdf_min, 1) · 255)`` in f32 with
    round-half-even, clipped to [0, 255]."""
    b = y_u8.shape[0]
    flat = y_u8.reshape(b, -1).long()
    n = flat.shape[1]
    hist = torch.zeros((b, 256), dtype=torch.int64, device=flat.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat))
    cdf = torch.cumsum(hist, dim=1).float()  # exact: counts < 2^24
    total = float(n)
    cdf_min = torch.where(hist > 0, cdf, torch.full_like(cdf, total + 1.0)).amin(dim=1, keepdim=True)
    denom = torch.clamp(total - cdf_min, min=1.0)
    lut = torch.clamp(torch.round((cdf - cdf_min) / denom * 255.0), 0.0, 255.0).to(torch.uint8)
    return torch.gather(lut, 1, flat).reshape(y_u8.shape)


def equalize_channel(y_u8: torch.Tensor) -> torch.Tensor:
    """``equalizeHist`` per image; a CPU tensor runs
    :func:`equalize_channel_plain`, a CUDA tensor the kernel (which raises
    on what it does not take: another dtype, a non-contiguous or unaligned
    tensor, more than :data:`MAX_PIXELS` pixels per image)."""
    if y_u8.device.type == "cpu":
        return equalize_channel_plain(y_u8)
    with span("kernel.equalize_channel", (y_u8,)):
        check_cuda_input("y_u8", y_u8, torch.uint8, ndim=3)
        b, h, w = y_u8.shape
        n = h * w
        require(n <= MAX_PIXELS, f"equalize_channel: {n} pixels per image exceed {MAX_PIXELS} (the f32 CDF is inexact)")
        out = torch.empty_like(y_u8)
        if b == 0 or n == 0:
            return out
        rc = library("histeq").mgu_histeq(y_u8.data_ptr(), out.data_ptr(), b, n, stream_ptr(y_u8))
    if rc != 0:
        raise RuntimeError(f"equalize_channel launch failed: cudaError {rc}")
    equalize_channel.launches += 1
    return out


equalize_channel.launches = 0
