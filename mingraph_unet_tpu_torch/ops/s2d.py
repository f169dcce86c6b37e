"""Space-to-depth (s2d) reparameterization of the U-Net's full-resolution
levels, in PyTorch. Counterpart of ``mingraph_unet_tpu/ops/s2d.py``.

Layout convention: **phase-major** — s2d channel index ``ph * C + c`` with
``ph = py * 2 + px`` the phase inside the 2×2 block, so a channel concat of
two s2d tensors keeps each input a contiguous group. Every transform below
is an exact reparameterization (same multiply-adds, other association
order) of the full-resolution op with 'SAME' zero padding.

Tensors are NHWC; kernels are flax HWIO ``(kh, kw, Cin, Cout)``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from mingraph_unet_tpu_torch.ops.conv import conv2d_nhwc

__all__ = [
    "space_to_depth",
    "depth_to_space",
    "s2d_conv3x3_kernel",
    "s2d_conv3x3_kernel_adjoint",
    "s2d_vector",
    "s2d_convt2x2_kernel",
    "s2d_1x1_kernel",
    "phase_max_pool",
    "patch_reduce_mean_s2d",
    "conv3x3_s2d",
    "conv3x3_s2d_const",
    "windowed_down_kernel",
    "conv3x3_windowed_down",
]

_R = 2  # block size; the U-Net only needs 2×2


def space_to_depth(x: torch.Tensor, r: int = _R) -> torch.Tensor:
    """(B, H, W, C) → (B, H/r, W/r, r²·C), phase-major channel order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // r, w // r, r * r * c)


def depth_to_space(y: torch.Tensor, r: int = _R) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    b, hh, ww, cc = y.shape
    c = cc // (r * r)
    y = y.reshape(b, hh, ww, r, r, c)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(b, hh * r, ww * r, c)


@lru_cache(maxsize=None)
def _tap_select(r: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """0/1 tap map ``S[dI, dJ, pyo, pxo, pyi, pxi, u, v]``: output pixel
    (r·I + pyo) reads input pixel (r·(I+dI) + pyi) through full-res tap
    ``u = r·dI + pyi − pyo`` of the 3×3 kernel (row ``u + 1``), where
    |u|, |v| ≤ 1. A product with it picks one kernel entry or zero, so it
    is exact in any dtype, and its gradient is a matmul, which sums in a
    fixed order (the backward of a gather accumulates in whatever order
    the threads reach it). Cached per device: a host-to-card copy inside
    the forward would synchronize the stream."""
    s = np.zeros((3, 3, r, r, r, r, 3, 3), np.float32)
    for di, dj, pyo, pxo, pyi, pxi in np.ndindex(3, 3, r, r, r, r):
        uu = r * (di - 1) + pyi - pyo
        vv = r * (dj - 1) + pxi - pxo
        if abs(uu) <= 1 and abs(vv) <= 1:
            s[di, dj, pyo, pxo, pyi, pxi, uu + 1, vv + 1] = 1.0
    return torch.from_numpy(s).to(device=device, dtype=dtype)


def s2d_conv3x3_kernel(
    kernel: torch.Tensor, in_groups: Sequence[int] = (), r: int = _R
) -> torch.Tensor:
    """(3, 3, Cin, Cout) 'SAME' kernel → its s2d form (3, 3, r²·Cin, r²·Cout).

    ``in_groups``: full-res widths of the separately transformed tensors
    when the s2d input is their channel concat (decoder [skip ‖ up])."""
    cin, cout = kernel.shape[2], kernel.shape[3]
    groups = tuple(in_groups) if in_groups else (cin,)
    if sum(groups) != cin:
        raise ValueError(f"groups {groups} do not sum to Cin={cin}")
    sel = _tap_select(r, kernel.device, kernel.dtype)
    parts = []
    off = 0
    for g in groups:
        kg = kernel[:, :, off : off + g, :]
        off += g
        # (3, 3, pyi, pxi, g, pyo, pxo, Cout)
        parts.append(torch.einsum("ijabcduv,uvgo->ijcdgabo", sel, kg).reshape(3, 3, r * r * g, r * r * cout))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)


def s2d_conv3x3_kernel_adjoint(kernel_s2d: torch.Tensor, r: int = _R) -> torch.Tensor:
    """Adjoint of :func:`s2d_conv3x3_kernel` (one input group): pulls an s2d
    kernel gradient (3, 3, r²·Cin, r²·Cout) back to the full-res
    (3, 3, Cin, Cout) gradient, each tap summed over the s2d entries that
    hold it, in the dtype of ``kernel_s2d``."""
    cin, cout = kernel_s2d.shape[2] // (r * r), kernel_s2d.shape[3] // (r * r)
    sel = _tap_select(r, kernel_s2d.device, kernel_s2d.dtype)
    k = kernel_s2d.reshape(3, 3, r, r, cin, r, r, cout)
    return torch.einsum("ijabcduv,ijcdgabo->uvgo", sel, k)


def s2d_vector(vec: torch.Tensor, r: int = _R) -> torch.Tensor:
    """Tile a per-channel vector to phase-major s2d channels: (C,) → (r²·C,)."""
    return vec.repeat(r * r)


def s2d_convt2x2_kernel(kernel: torch.Tensor, r: int = _R) -> torch.Tensor:
    """(r, r, Cin, Cout) stride-r ConvTranspose kernel (flax) → the
    (Cin, r²·Cout) matmul producing the s2d output directly. flax applies
    the kernel spatially flipped, hence the flip."""
    rr, rr2, cin, cout = kernel.shape
    if rr != r or rr2 != r:
        raise ValueError(f"expected a {r}x{r} kernel, got {tuple(kernel.shape)}")
    k = kernel.flip(0, 1)
    return k.reshape(r * r, cin, cout).permute(1, 0, 2).reshape(cin, r * r * cout)


def s2d_1x1_kernel(kernel: torch.Tensor, r: int = _R) -> torch.Tensor:
    """(1, 1, Cin, Cout) → block-diagonal (r²·Cin, r²·Cout) per-phase matmul."""
    cin, cout = kernel.shape[2], kernel.shape[3]
    eye = torch.eye(r * r, dtype=kernel.dtype, device=kernel.device)
    return torch.einsum("pq,io->piqo", eye, kernel[0, 0]).reshape(r * r * cin, r * r * cout)


def phase_max_pool(y_s2d: torch.Tensor, r: int = _R) -> torch.Tensor:
    """MaxPool(r, r) of the full-res tensor in s2d layout: the pool window is
    the phase block, so a channelwise max over the phase groups.
    (B, H/r, W/r, r²·C) → (B, H/r, W/r, C)."""
    b, hh, ww, cc = y_s2d.shape
    return y_s2d.reshape(b, hh, ww, r * r, cc // (r * r)).amax(dim=3)


def patch_reduce_mean_s2d(x_s2d: torch.Tensor, patch: int, r: int = _R) -> torch.Tensor:
    """Per-patch mean of the full-res tensor, computed from its s2d form:
    (B, H/r, W/r, r²·C) → (B, H/patch, W/patch, C), summed in f32."""
    if patch % r:
        raise ValueError(f"patch {patch} is not a multiple of {r}")
    p = patch // r
    b, hh, ww, cc = x_s2d.shape
    c = cc // (r * r)
    x = x_s2d.to(torch.promote_types(x_s2d.dtype, torch.float32)).reshape(b, hh // p, p, ww // p, p, r * r, c).sum(dim=(2, 4, 5))
    return (x / (patch * patch)).to(x_s2d.dtype)


def conv3x3_s2d(x_s2d: torch.Tensor, kernel_s2d: torch.Tensor) -> torch.Tensor:
    """3×3 'SAME' conv on the s2d grid (NHWC, HWIO), in x's dtype."""
    return conv2d_nhwc(x_s2d, kernel_s2d, padding=1)


def conv3x3_s2d_const(
    v: torch.Tensor, kernel_s2d: torch.Tensor, hh: int, ww: int
) -> torch.Tensor:
    """``conv3x3_s2d`` of a spatially constant map, computed analytically:
    ``out[y, x] = Σ_{dy∈valid(y), dx∈valid(x)} T[dy, dx]`` with
    ``T[dy, dx, o] = Σ_i K[dy, dx, i, o]·v[i]``. Returns (hh, ww, Cout) f32."""
    t = torch.einsum("yxio,i->yxo", kernel_s2d.float(), v.float())
    dev = kernel_s2d.device
    iy = torch.arange(hh, device=dev)
    ix = torch.arange(ww, device=dev)
    ry = torch.stack([iy >= 1, torch.ones_like(iy, dtype=torch.bool), iy < hh - 1], 1).float()
    cx = torch.stack([ix >= 1, torch.ones_like(ix, dtype=torch.bool), ix < ww - 1], 1).float()
    return torch.einsum("yd,xe,deo->yxo", ry, cx, t)


def windowed_down_kernel(kernel: torch.Tensor, r: int = _R) -> torch.Tensor:
    """(3, 3, Cin, Cout) 'SAME' kernel → the windowed (4, 4, Cin, r²·Cout)
    stride-r form whose output is the phase-major s2d conv output: the four
    outputs of each r×r block share one 4×4 input window."""
    parts = []
    for pyo in range(r):
        for pxo in range(r):
            # pad (kh: pyo before, 1-pyo after; kw: pxo before, 1-pxo after)
            parts.append(
                torch.nn.functional.pad(
                    kernel.permute(2, 3, 0, 1), (pxo, 1 - pxo, pyo, 1 - pyo)
                ).permute(2, 3, 0, 1)
            )
    return torch.cat(parts, dim=3)


def conv3x3_windowed_down(x_full: torch.Tensor, kernel_win: torch.Tensor) -> torch.Tensor:
    """Windowed 3×3 'SAME' conv: full-res NHWC in, phase-major s2d out,
    (B, H, W, Cin) → (B, H/2, W/2, 4·Cout). The JAX form pads (1, 2) per
    side; the second trailing pad row is never read at stride 2 on an even
    size, so a symmetric pad of 1 is the same conv."""
    if x_full.shape[1] % 2 or x_full.shape[2] % 2:
        raise ValueError(f"windowed conv needs even H, W; got {tuple(x_full.shape)}")
    return conv2d_nhwc(x_full, kernel_win, stride=2, padding=1)
