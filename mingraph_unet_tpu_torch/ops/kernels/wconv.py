"""The windowed 3×3 s2d conv as a hand-written CUDA kernel, with its plain
PyTorch version. Counterpart of ``mingraph_unet_tpu/ops/pallas/wconv.py``.

:func:`wconv3x3_s2d` replaces ``wconv3x3_s2d``: ``relu?(conv3x3(x) + bias)``
of a phase-major s2d tensor, where the four outputs of every 2×2 block are
one (16·Cin → 4·Cout) contraction of the 4×4 full-resolution window around
it, with the weights of :func:`wconv3x3_weights`. The input may be the
channel concat of separately transformed groups (``groups``, the decoder's
[skip ‖ up]).

The kernel (``csrc/wconv.cu``) stages each tile's s2d halo in shared memory
and contracts the 16 taps from there, so no patch matrix is written: on
tensor cores (``mma.sync`` bf16, f32 accumulation) where x is bf16, every
group width a multiple of 16 and Cout a multiple of 8; in SIMT f32 FMA
otherwise (f32, the RGB input's Cin = 3). Both round once, after the f32
bias and ReLU. Memory bounds it at the U-Net's s2d sites. It takes any
number of groups and any Cin: the halo is staged in channel chunks where
it does not fit in shared memory at once.

No entry point of the port calls it, as none in the JAX package does; it
has no backward. ``launches`` counts kernel launches.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mingraph_unet_tpu_torch.ops.kernels.build import (
    KERNEL_DTYPES,
    check_cuda_input,
    library,
    require,
    require_no_grad,
    stream_ptr,
)
from mingraph_unet_tpu_torch.ops.kernels.psconv import mma_b_fragments

__all__ = ["wconv3x3_weights", "wconv3x3_s2d", "wconv3x3_s2d_plain", "wconv_uses_mma"]

# Window tap d ∈ 0..3 reads s2d row (col) I − 1 + _POS[d] at intra-block
# phase _PHASE[d].
_POS = (0, 1, 1, 2)
_PHASE = (1, 0, 1, 0)
_SIMT_N = 16          # the SIMT path's column pass; its weights are padded to it


def wconv3x3_weights(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) 'SAME' conv kernel → (16·Cin, 4·Cout) windowed form.

    Rows are tap-major ((dy·4 + dx)·Cin + ci, full-res channel order),
    columns output-phase-major ((py·2 + px)·Cout + co), so the product is
    the s2d output block. The same gather and 0/1 mask as the JAX package,
    so the result is the same bit for bit."""
    cin, cout = kernel.shape[2], kernel.shape[3]
    u = np.zeros((4, 2), np.int64)
    valid = np.zeros((4, 2), bool)
    for d in range(4):
        for p in range(2):
            valid[d, p] = 0 <= d - p <= 2
            u[d, p] = np.clip(d - p, 0, 2)
    uy = torch.from_numpy(np.broadcast_to(u[:, None, :, None], (4, 4, 2, 2)).copy()).to(kernel.device)
    vx = torch.from_numpy(np.broadcast_to(u[None, :, None, :], (4, 4, 2, 2)).copy()).to(kernel.device)
    mask = torch.from_numpy((valid[:, None, :, None] & valid[None, :, None, :]).astype(np.float32))
    gathered = kernel[uy, vx] * mask.to(kernel.device, kernel.dtype)[..., None, None]
    return gathered.permute(0, 1, 4, 2, 3, 5).reshape(16 * cin, 4 * cout)


def _groups(cin: int, groups: Sequence[int]) -> Tuple[int, ...]:
    groups = tuple(int(g) for g in groups) if groups else (cin,)
    if sum(groups) != cin:
        raise ValueError(f"groups {groups} do not sum to Cin={cin}")
    return groups


@lru_cache(maxsize=None)
def _group_table(groups: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The kernel's (ngroups,) int32 group table on ``device``, cached: a
    host-to-card copy per call would wait on the stream."""
    return torch.tensor(groups, dtype=torch.int32).to(device)


def _windows(x_s2d: torch.Tensor, groups: Tuple[int, ...]) -> torch.Tensor:
    """(B, Hh, Ww, 4·Cin) → the (B, Hh, Ww, 16·Cin) window matrix: tap d
    of every s2d pixel, each group's channels of that tap's phase, zero
    outside the image."""
    _, hh, ww, _ = x_s2d.shape
    xp = F.pad(x_s2d, (0, 0, 1, 1, 1, 1))
    cols = []
    for dy in range(4):
        for dx in range(4):
            sl = xp[:, _POS[dy] : _POS[dy] + hh, _POS[dx] : _POS[dx] + ww]
            ph = _PHASE[dy] * 2 + _PHASE[dx]
            off = 0
            for g in groups:
                cols.append(sl[..., off + ph * g : off + (ph + 1) * g])
                off += 4 * g
    return torch.cat(cols, dim=-1)


def wconv3x3_s2d_plain(
    x_s2d: torch.Tensor, w2: torch.Tensor, bias: torch.Tensor, groups: Sequence[int] = (), relu: bool = True
) -> torch.Tensor:
    """The windowed contraction in PyTorch: gather every 2×2 block's 4×4
    window, multiply by ``w2`` cast to x's dtype with the products summed
    in f32 (at least), add the bias tiled to the four phases, ReLU, and
    cast once to x's dtype."""
    dt = x_s2d.dtype
    acc = torch.promote_types(dt, torch.float32)
    groups = _groups(x_s2d.shape[-1] // 4, groups)
    patches = _windows(x_s2d, groups)
    y = patches.to(acc) @ w2.to(device=x_s2d.device, dtype=dt).to(acc)
    y = y + bias.to(device=x_s2d.device, dtype=acc).repeat(4)
    if relu:
        y = torch.relu(y)
    return y.to(dt)


def wconv_uses_mma(dtype: torch.dtype, groups: Sequence[int], cout: int) -> bool:
    """Whether the kernel runs on tensor cores for these widths: bf16,
    every group width a multiple of 16 and Cout a multiple of 8."""
    return dtype == torch.bfloat16 and all(g % 16 == 0 for g in groups) and cout % 8 == 0


def wconv3x3_s2d(
    x_s2d: torch.Tensor, w2: torch.Tensor, bias: torch.Tensor, groups: Sequence[int] = (), relu: bool = True
) -> torch.Tensor:
    """Fused conv3x3 (+bias, optional ReLU) on s2d-layout tensors.

    x_s2d: (B, Hh, Ww, 4·Cin) phase-major s2d input; w2: (16·Cin, 4·Cout)
    from :func:`wconv3x3_weights` (cast to x's dtype); bias: (Cout,)
    full-res (the BN-folded bias for inference); groups: full-res widths
    when x is a concat of separately transformed tensors (any number).
    Returns (B, Hh, Ww, 4·Cout) in x's dtype. A CPU tensor runs
    :func:`wconv3x3_s2d_plain`; a CUDA tensor launches the kernel (bf16 or
    f32, contiguous, 16-byte aligned, any Hh and Ww) or raises."""
    if x_s2d.device.type == "cpu":
        return wconv3x3_s2d_plain(x_s2d, w2, bias, groups, relu)
    require_no_grad("wconv3x3_s2d", x_s2d, w2, bias)
    dt = x_s2d.dtype
    require(dt in KERNEL_DTYPES, f"wconv3x3_s2d: unsupported dtype {dt}")
    check_cuda_input("x_s2d", x_s2d, dt)
    b, hh, ww, c4 = x_s2d.shape
    require(c4 % 4 == 0, f"x has {c4} s2d channels, not a multiple of 4")
    cin = c4 // 4
    groups = _groups(cin, groups)
    require(w2.dim() == 2 and w2.shape[0] == 16 * cin and w2.shape[1] % 4 == 0,
            f"w2 must be (16*{cin}, 4*Cout), got {tuple(w2.shape)}")
    cout = w2.shape[1] // 4
    require(tuple(bias.shape) == (cout,), f"bias must be ({cout},), got {tuple(bias.shape)}")
    dev = x_s2d.device
    use_mma = wconv_uses_mma(dt, groups, cout)
    w = w2.to(device=dev, dtype=dt)
    if use_mma:
        w, npad = mma_b_fragments(w), 4 * cout
    else:
        npad = -(-4 * cout // _SIMT_N) * _SIMT_N
        w = F.pad(w.float(), (0, npad - 4 * cout)).contiguous()
    bias = bias.to(device=dev, dtype=torch.float32).contiguous()
    y = torch.empty((b, hh, ww, 4 * cout), dtype=dt, device=dev)
    table = _group_table(groups, dev)
    rc = library("wconv").mgu_wconv3x3(
        x_s2d.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(), b, hh, ww, cin, cout, npad,
        len(groups), table.data_ptr(), int(dt == torch.bfloat16), int(relu), int(use_mma), stream_ptr(x_s2d),
    )
    if rc != 0:
        raise RuntimeError(f"wconv3x3_s2d launch failed: cudaError {rc}")
    wconv3x3_s2d.launches += 1
    return y


wconv3x3_s2d.launches = 0
