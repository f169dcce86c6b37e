"""The fused inference ConvBlock as a hand-written CUDA kernel, with its plain
PyTorch version. Counterpart of ``mingraph_unet_tpu/ops/pallas/conv_block.py``.

:func:`fused_conv_block` replaces ``fused_conv_block``:
``relu(conv3x3(relu(conv3x3(x, w1)·s1 + b1), w2)·s2 + b2)`` with 'SAME'
padding, NHWC, in one device-memory round trip (``csrc/conv_block.cu``).
The function is f32 inside, as in JAX: taps and weights widened to f32,
the scale/shift applied to the f32 accumulator, the intermediate h kept in
f32, only the output cast to x's dtype. The kernel is SIMT f32 FMA, so the
f32 operation rate bounds it at every U-Net width. It takes any C: above
512 output channels a block computes one 512-channel tile of conv2 (and
all of conv1 for it).

:func:`fold_bn` folds inference BatchNorm into the (s, b) pairs it takes.
No entry point of the port calls the kernel, as none in the JAX package
does; it has no backward. ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from mingraph_unet_tpu_torch.ops.conv import conv2d_nhwc
from mingraph_unet_tpu_torch.ops.kernels.build import (
    KERNEL_DTYPES,
    check_cuda_input,
    library,
    require,
    require_no_grad,
    stream_ptr,
)

__all__ = ["fold_bn", "fused_conv_block", "fused_conv_block_plain"]

# csrc/conv_block.cu: h is padded to a multiple of every tile's h chunk (16,
# 32 or 64 channels), y to a multiple of the 8 channels a thread writes.
_H_PAD, _Y_PAD = 64, 8


def fold_bn(conv_bias, bn_scale, bn_bias, bn_mean, bn_var, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold inference-mode BatchNorm into per-channel (scale, shift):
    ``s = γ/√(σ² + ε)``, ``b = β + (bias − μ)·s``."""
    s = bn_scale / torch.sqrt(bn_var + eps)
    b = bn_bias + (conv_bias - bn_mean) * s
    return s, b


def fused_conv_block_plain(x, w1, s1, b1, w2, s2, b2) -> torch.Tensor:
    """The two convs through ``F.conv2d`` in f32 (f64 for an f64 input), the
    counterpart of JAX ``conv_block_reference``; the output in x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)

    def stage(inp, w, s, b):
        y = conv2d_nhwc(inp.to(acc), w.to(device=inp.device, dtype=acc), padding=1)
        return torch.relu(y * s.to(y) + b.to(y))

    return stage(stage(x, w1, s1, b1), w2, s2, b2).to(x.dtype)


def _pad(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``t`` zero-padded along ``dim`` to ``size``, f32 and contiguous."""
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, size - t.shape[dim]]
    return F.pad(t.float(), pad).contiguous()


def fused_conv_block(x, w1, s1, b1, w2, s2, b2) -> torch.Tensor:
    """Fused (conv3x3 → scale/shift → ReLU) ×2.

    x: (B, H, W, Cin) NHWC; w1: (3, 3, Cin, C); w2: (3, 3, C, C); s1, b1,
    s2, b2: (C,) folded BN scale/shift (:func:`fold_bn`). Returns
    (B, H, W, C) in x's dtype. A CPU tensor runs
    :func:`fused_conv_block_plain`; a CUDA tensor launches the kernel (x
    bf16 or f32, contiguous, 16-byte aligned, any C, H, W and Cin) or
    raises."""
    if x.device.type == "cpu":
        return fused_conv_block_plain(x, w1, s1, b1, w2, s2, b2)
    require_no_grad("fused_conv_block", x, w1, s1, b1, w2, s2, b2)
    dt = x.dtype
    require(dt in KERNEL_DTYPES, f"fused_conv_block: unsupported dtype {dt}")
    check_cuda_input("x", x, dt)
    bn, h, w, cin = x.shape
    c = w1.shape[-1]
    require(tuple(w1.shape) == (3, 3, cin, c), f"w1 must be (3, 3, {cin}, C), got {tuple(w1.shape)}")
    require(tuple(w2.shape) == (3, 3, c, c), f"w2 must be (3, 3, {c}, {c}), got {tuple(w2.shape)}")
    for name, v in (("s1", s1), ("b1", b1), ("s2", s2), ("b2", b2)):
        require(tuple(v.shape) == (c,), f"{name} must be ({c},), got {tuple(v.shape)}")
    dev = x.device
    c1p, c2p = -(-c // _H_PAD) * _H_PAD, -(-c // _Y_PAD) * _Y_PAD
    w1p = _pad(w1.to(dev).reshape(9, cin, c), 2, c1p)
    w2p = _pad(_pad(w2.to(dev).reshape(9, c, c), 1, c1p), 2, c2p)
    s1p, b1p = _pad(s1.to(dev), 0, c1p), _pad(b1.to(dev), 0, c1p)
    s2p, b2p = _pad(s2.to(dev), 0, c2p), _pad(b2.to(dev), 0, c2p)
    y = torch.empty((bn, h, w, c), dtype=dt, device=dev)
    rc = library("conv_block").mgu_conv_block(
        x.data_ptr(), w1p.data_ptr(), s1p.data_ptr(), b1p.data_ptr(), w2p.data_ptr(), s2p.data_ptr(),
        b2p.data_ptr(), y.data_ptr(), bn, h, w, cin, c, c1p, c2p, int(dt == torch.bfloat16), stream_ptr(x),
    )
    if rc != 0:
        raise RuntimeError(f"fused_conv_block launch failed: cudaError {rc}")
    fused_conv_block.launches += 1
    return y


fused_conv_block.launches = 0
