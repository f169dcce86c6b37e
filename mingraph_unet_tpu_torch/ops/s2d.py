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
def _tap_map(r: int, device: torch.device):
    """Index maps ``(dI, dJ, pyo, pxo, pyi, pxi) -> (u, v, valid)``: output
    pixel (r·I + pyo) reads input pixel (r·(I+dI) + pyi), full-res tap
    ``u = r·dI + pyi − pyo`` of the 3×3 kernel, valid iff |u|, |v| ≤ 1.
    Cached per device: a host-to-card copy inside the forward would
    synchronize the stream."""
    shape = (3, 3, r, r, r, r)
    u = np.zeros(shape, np.int64)
    v = np.zeros(shape, np.int64)
    valid = np.zeros(shape, np.float32)
    for idx in np.ndindex(*shape):
        di, dj, pyo, pxo, pyi, pxi = idx
        uu = r * (di - 1) + pyi - pyo
        vv = r * (dj - 1) + pxi - pxo
        valid[idx] = float(abs(uu) <= 1 and abs(vv) <= 1)
        u[idx] = min(max(uu + 1, 0), 2)
        v[idx] = min(max(vv + 1, 0), 2)
    return tuple(torch.from_numpy(a).to(device) for a in (u, v, valid))


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
    u, v, valid = _tap_map(r, kernel.device)
    valid = valid.to(kernel.dtype)[..., None, None]
    parts = []
    off = 0
    for g in groups:
        kg = kernel[:, :, off : off + g, :]
        off += g
        gathered = kg[u, v] * valid  # (3, 3, pyo, pxo, pyi, pxi, g, Cout)
        parts.append(
            gathered.permute(0, 1, 4, 5, 6, 2, 3, 7).reshape(3, 3, r * r * g, r * r * cout)
        )
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)


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
    x = x_s2d.float().reshape(b, hh // p, p, ww // p, p, r * r, c).sum(dim=(2, 4, 5))
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
