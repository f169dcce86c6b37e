"""The fused inference ConvBlock as a hand-written CUDA kernel, with its plain
PyTorch version. Counterpart of ``mingraph_unet_tpu/ops/pallas/conv_block.py``.

:func:`fused_conv_block` replaces ``fused_conv_block``:
``relu(conv3x3(relu(conv3x3(x, w1)·s1 + b1), w2)·s2 + b2)`` with 'SAME'
padding, NHWC, in one device-memory round trip (``csrc/conv_block.cu``).
The function is f32 inside, as in JAX: taps and weights widened to f32,
the scale/shift applied to the f32 accumulator, the intermediate h kept in
f32, only the output cast to x's dtype. The kernel runs both convs on the
tensor cores (``wgmma``) with each f32 operand split into a bf16 pair
``hi = bf16(a)``, ``lo = bf16(a − hi)`` and each product taken as
``hi·hi + hi·lo + lo·hi`` (two products where x is bf16, whose lo is 0).
:func:`pack_weights` splits and packs the weights once a call into the
stream of 16 KB stages the kernel consumes. It takes any C, Cin, H and W:
above 256 output channels a block computes one channel tile of conv2 (and
all of conv1 for it).

:func:`fold_bn` folds inference BatchNorm into the (s, b) pairs it takes.
``models/unet.py::ConvBlock`` calls it for every standard-layout block of
an f32 eval forward (no entry point of the JAX package calls its kernel);
it has no backward. ``launches`` counts kernel launches.
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
from mingraph_unet_tpu_torch.utils.profiling import span

__all__ = ["channel_tile", "fold_bn", "fused_conv_block", "fused_conv_block_plain", "pack_stream", "pack_weights",
           "split_bf16"]

# csrc/conv_block.cu: h in chunks of 64 channels, x in chunks of 64 input
# channels, the weight stream in stages of 16 KB.
CHUNK, STAGE_BYTES = 64, 16384


def channel_tile(c: int) -> int:
    """Output channels a block computes (N of conv2's wgmma): 64, 128 or
    256; a wider C runs in several tiles."""
    return 64 if c <= 64 else 128 if c <= 128 else 256


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


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


def split_bf16(w: torch.Tensor) -> torch.Tensor:
    """f32 values as the bf16 pair (hi, lo) stacked on a new first axis:
    ``hi = bf16(w)``, ``lo = bf16(w − hi)``; each rounding keeps 8 significant
    bits, so ``hi + lo`` is ``w`` within 2^-16 of |w|."""
    w = w.float()
    hi = w.to(torch.bfloat16)
    return torch.stack([hi, (w - hi.float()).to(torch.bfloat16)])


def pack_stream(wp: torch.Tensor, nt: int) -> torch.Tensor:
    """A (9, K, N) f32 weight (K a multiple of 64, N of ``nt``) as
    (N / nt, K / 64, bytes / 2) bf16: for each ``nt``-column tile and
    64-row chunk of K, per tap its 4 k-steps, each the hi then the lo
    16 × nt slab in wgmma's K-major B layout (``psconv.wgmma_b_layout``):
    element (k, n) at ``[n // 8, k // 8, n % 8, k % 8]``."""
    kc, ntl = wp.shape[1] // CHUNK, wp.shape[2] // nt
    # (hl, tap, kc, ks, k1, k0, ntl, n1, n0) -> (ntl, kc, tap, ks, hl, n1, k1, n0, k0)
    packed = split_bf16(wp).reshape(2, 9, kc, 4, 2, 8, ntl, nt // 8, 8).permute(6, 2, 1, 3, 0, 7, 4, 8, 5)
    return packed.reshape(ntl, kc, -1)


def pack_weights(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The weight stream of ``csrc/conv_block.cu``: (channel tiles, h
    chunks, bytes) as bf16, for ``channel_tile(C)`` output channels a tile.

    Input channels are padded with zeros to a multiple of 64 (x chunks), h
    channels to C1p = 64·ceil(C/64), output channels to the tile. For each
    channel tile and h chunk: conv1's stages, one per (x chunk, tap): its 64
    input rows as 4 k-steps, each the hi then the lo 16 × 64 slab; then
    conv2's, one per tap: the chunk's 64 h rows as 4 k-steps, each the hi
    then the lo 16 × NT slab (16 KB stages of 1, 2 or 4 k-steps). A slab is
    in wgmma's K-major B layout (``psconv.wgmma_b_layout``): element (k, n)
    at ``[n // 8, k // 8, n % 8, k % 8]``."""
    cin, c = w1.shape[2], w1.shape[3]
    nt = channel_tile(c)
    xc, hc, ntl = -(-cin // CHUNK), _up(c, CHUNK) // CHUNK, -(-c // nt)
    w1p = F.pad(w1.float().reshape(9, cin, c), (0, hc * CHUNK - c, 0, xc * CHUNK - cin))
    w2p = F.pad(w2.float().reshape(9, c, c), (0, ntl * nt - c, 0, hc * CHUNK - c))
    one = pack_stream(w1p, CHUNK).reshape(1, hc, -1).expand(ntl, hc, -1)  # conv1's N tiles are the h chunks
    return torch.cat([one, pack_stream(w2p, nt)], dim=2).contiguous()


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
    with span("kernel.fused_conv_block", (x, w1, s1, b1, w2, s2, b2)):
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
        nt = channel_tile(c)
        c1p, c2p = _up(c, CHUNK), _up(c, nt)
        with span("weights"):
            stream = pack_weights(w1.to(dev), w2.to(dev))
            s1p, b1p, s2p, b2p = (F.pad(v.to(dev).float(), (0, n - c))
                                  for v, n in ((s1, c1p), (b1, c1p), (s2, c2p), (b2, c2p)))
        y = torch.empty((bn, h, w, c), dtype=dt, device=dev)
        rc = library("conv_block").mgu_conv_block(
            x.data_ptr(), stream.data_ptr(), s1p.data_ptr(), b1p.data_ptr(), s2p.data_ptr(), b2p.data_ptr(),
            y.data_ptr(), bn, h, w, cin, c, nt, int(dt == torch.bfloat16), stream_ptr(x),
        )
    if rc != 0:
        raise RuntimeError(f"fused_conv_block launch failed: cudaError {rc}")
    fused_conv_block.launches += 1
    return y


fused_conv_block.launches = 0
