"""U-Net encoder / decoder. Counterpart of
``mingraph_unet_tpu/models/unet.py``.

- ``ConvBlock``: (Conv3x3 → BN → ReLU) ×2. ``model.eval()``: BN folded into
  the conv in f32 and the folded weights cast to the compute dtype; a
  standard-layout block of an f32 model runs instead as one fused-ConvBlock
  call (K8) on the raw kernels, BN applied as the scale/shift after each
  conv.
  ``model.train()``: conv + bias → BN over the batch statistics (which
  updates the running ones) → ReLU, differentiable. ``use_batchnorm=False``
  drops both BNs (and their parameters): conv + bias → ReLU, the raw
  weights at every site. ``remat=True`` recomputes each block's train-mode
  forward in the backward instead of keeping its activations
  (``torch.utils.checkpoint``, JAX's ``nn.remat`` of every ``ConvBlock``):
  the recompute restores the norm groups its forward ran under and leaves
  the BN running statistics alone (``models/layers.py::recomputing``), and
  it launches the block's kernels (K4) and collectives again.
- The full-resolution levels 0 and 1 run in 2×2 space-to-depth (s2d)
  layout, phase-major ``(B, H/2, W/2, 4C)``, with the JAX package's
  lowering: conv1 of an encoder level is the windowed stride-2 conv from the
  full-res input; conv1 of an s2d decoder level has the ConvTranspose folded
  into x_prev's taps. At inference conv2 of every s2d block is the
  phase-select conv kernel (K1), decoder conv1 the fused decoder-conv1
  kernel (K2), the encoder's pool the phase-max-pool kernel (K3) and each
  decoder output's turn to full resolution the depth-to-space kernel (K5,
  ``decoder_d2s``; the skips and the logits keep the plain relayout, as in
  JAX); in training conv2 is the raw conv kernel with its backward (K4),
  and conv1, the pool and the relayouts are differentiable PyTorch (K1–K3
  and K5 have no backward).
- The standard-layout ConvBlocks (the deeper levels and the bottleneck) run
  the fused-ConvBlock kernel (K8, :func:`fused_conv_block`) at inference in
  f32. In f32 training on the card, unsharded, each of their convs is the
  split-form conv kernel (K10: forward and dx on the kernel, the kernel and
  bias gradients from cuDNN's weight-gradient call); in bf16, on an H-shard
  and on the CPU their convs use cuDNN through ``F.conv2d``
  (``conv2d_nhwc``), as the JAX package leaves them to XLA. The 2×2
  ConvTransposes and the final 1×1 conv use cuDNN (``F.conv_transpose2d``,
  ``F.conv2d``) in every mode.

Who decides. The model calls one op a site, and the op's module in
``ops/kernels/`` picks the kernel or the plain version from the tensor's
device, dtype and widths: ``psconv.py`` (``conv2_s2d``,
``conv2_s2d_train``, ``dec_conv1``), ``pool.py`` (``encoder_pool``,
``decoder_d2s``, given the training flag) and ``conv3x3.py``
(``conv3x3_same``). The model chooses only between an op and its sharded
form, a method of the shard.

Full-resolution tensors that nothing downstream reads (the encoder skips of
the s2d levels and the last decoder output) are built only when the caller
asks for them (``full_res_outputs=True``); under ``jit`` XLA drops them,
eager PyTorch would write them.

``UNet.forward(x, spatial=shard)`` runs on one H-shard of the input,
``shard`` a ``parallel/spatial.py::SpatialShard``: every conv site
exchanges the rows it reads with the neighbouring shards, and the rest
(pools, the 2×2 ConvTranspose, the final 1×1 conv) is local. At inference
the s2d conv2s run K9 and the decoder conv1s K2's sharded entry
(``parallel/spatial.py::spatial_sharded_apply`` drives it); in training
the s2d conv2s run K4 on the shard, every exchange is differentiable (its
backward returns the halo rows' cotangents to their shards) and BN sums
its statistics over the spatial group as well
(``parallel/spatial.py::spatial_sharded_unet`` drives it).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mingraph_unet_tpu_torch.models.layers import ConvParams, FoldableBatchNorm, recomputing
from mingraph_unet_tpu_torch.ops import s2d as s2d_ops
from mingraph_unet_tpu_torch.ops.conv import conv2d_nhwc, conv_transpose2x2_nhwc
from mingraph_unet_tpu_torch.ops.kernels.conv3x3 import conv3x3_same
from mingraph_unet_tpu_torch.ops.kernels.conv_block import fused_conv_block
from mingraph_unet_tpu_torch.ops.kernels.pool import decoder_d2s, encoder_pool
from mingraph_unet_tpu_torch.ops.kernels.psconv import (
    conv2_s2d,
    conv2_s2d_train,
    dec_conv1,
    dec_conv1_bias_table,
    dec_conv1_preact,
    dec_conv1_weights,
)
from mingraph_unet_tpu_torch.parallel import data as dp
from mingraph_unet_tpu_torch.utils.profiling import span

__all__ = ["ConvBlock", "FoldableBatchNorm", "UNetEncoder", "DecoderBlock", "UNetDecoder", "UNet"]

FusedUp = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (x_prev, wt, bias_up)


def _remat(fn: Callable[..., torch.Tensor], *args) -> torch.Tensor:
    """``fn(*args)`` with its activations recomputed in the backward. The
    recompute runs after the step's contexts have closed, on the autograd
    engine's thread: it restores the norm groups this forward runs under
    and keeps BN from updating its running statistics a second time."""
    ctx = dp.norm_context()
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), recomputing(ctx)))


class ConvBlock(nn.Module):
    """(Conv3x3 'SAME' → BN → ReLU) ×2 with the flax tree
    ``conv{1,2}/{kernel,bias}``, ``bn{1,2}/{scale,bias,mean,var}`` (no
    ``bn{1,2}`` without BatchNorm)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        gen: torch.Generator,
        dtype: torch.dtype = torch.float32,
        use_batchnorm: bool = True,
        remat: bool = False,
    ):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.conv1 = ConvParams(in_features, features, (3, 3), gen)
        self.conv2 = ConvParams(features, features, (3, 3), gen)
        if use_batchnorm:
            self.bn1 = FoldableBatchNorm(features)
            self.bn2 = FoldableBatchNorm(features)

    def _conv_bn(self, i: int) -> Tuple[ConvParams, Optional[FoldableBatchNorm]]:
        return getattr(self, f"conv{i}"), getattr(self, f"bn{i}", None)

    def scale_shift(self, i: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(kernel, scale, shift) of conv ``i`` (1 or 2), f32: the raw kernel,
        and BN's eval affine ``a·z + c`` on its output with the conv bias,
        ``scale = a``, ``shift = bias·a + c`` (1 and the conv bias without
        BN). K8's arguments."""
        conv, bn = self._conv_bn(i)
        if bn is None:
            return conv.kernel, torch.ones_like(conv.bias), conv.bias
        a, c = bn.eval_affine()
        return conv.kernel, a, conv.bias * a + c

    def folded(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(kernel, bias) of conv ``i`` with its BN folded in, f32 (the raw
        values without BN)."""
        conv, bn = self._conv_bn(i)
        if bn is None:
            return conv.kernel, conv.bias
        k, s, b = self.scale_shift(i)
        return k * s, b

    def forward(self, x: torch.Tensor, spatial=None) -> torch.Tensor:
        """Standard NHWC path; ``spatial``: x is one H-shard."""
        if self.training and self.remat:
            return _remat(self._forward, x, spatial)
        return self._forward(x, spatial)

    def _forward(self, x: torch.Tensor, spatial) -> torch.Tensor:
        if not self.training and spatial is None and self.dtype == torch.float32:
            args = []
            for i in (1, 2):
                with span("weights"):
                    args += self.scale_shift(i)
            return fused_conv_block(x.to(self.dtype).contiguous(), *args)
        for i in (1, 2):
            if self.training:
                conv, bn = self._conv_bn(i)
                x = x.to(self.dtype)
                z = (conv3x3_same if spatial is None else spatial.conv_same)(x, conv.kernel, conv.bias)
                x = torch.relu(z if bn is None else bn(z))
            else:
                with span("weights"):
                    k, b = self.folded(i)
                    k, b = k.to(self.dtype), b.to(self.dtype)
                x = x.to(self.dtype)
                x = torch.relu(conv2d_nhwc(x, k, b, padding=1) if spatial is None else spatial.conv_same(x, k, b))
        return x

    def forward_s2d(self, x: torch.Tensor, fused_up: Optional[FusedUp] = None, spatial=None) -> torch.Tensor:
        """s2d path; returns a phase-major (B, H/2, W/2, 4·features) tensor.

        Encoder level (``fused_up`` None): x is full-res NHWC and conv1 is
        the windowed stride-2 conv. Decoder level: x is the s2d skip,
        ``fused_up = (x_prev, wt, bias_up)``, and conv1 runs as
        ``dec_conv1_fused`` over [skip ‖ upsample of x_prev]. ``spatial``:
        x is one H-shard, and each conv runs in its sharded form."""
        if self.training:
            if self.remat:
                return _remat(self._forward_s2d_train, x, fused_up, spatial)
            return self._forward_s2d_train(x, fused_up, spatial)
        dt = self.dtype
        x = x.to(dt)
        if fused_up is None:
            with span("weights"):
                k, b = self.folded(1)
                kw, bs = s2d_ops.windowed_down_kernel(k), s2d_ops.s2d_vector(b).to(dt)
            x = s2d_ops.conv3x3_windowed_down(x, kw) if spatial is None else spatial.windowed_down(x, kw)
            x = torch.relu(x + bs)
        else:
            x_prev, wt, bias_up = fused_up
            x_prev, skip_c = x_prev.to(dt), x.shape[-1] // 4
            with span("weights"):
                k, b = self.folded(1)
                k_skip, k_prev = dec_conv1_weights(k, skip_c, wt)
                t9 = dec_conv1_bias_table(k, skip_c, bias_up, b)
            x = (dec_conv1 if spatial is None else spatial.dec_conv1)(x, x_prev, k_skip, k_prev, t9)
        with span("weights"):
            k, b = self.folded(2)
        return (conv2_s2d if spatial is None else spatial.psel)(x, k, b)

    def _forward_s2d_train(self, x: torch.Tensor, fused_up: Optional[FusedUp], spatial=None) -> torch.Tensor:
        """Train mode: each conv is bias → BN over (B, H/2, W/2, 4, C), so the
        statistics are per full-res channel as on the standard path (no BN
        without BatchNorm) → ReLU.
        conv1 is differentiable PyTorch (the windowed conv, or the decoder's
        split form with the upsample-bias field, bias included); conv2 is
        ``conv2_s2d_train`` (K4 where the tile takes it). On an H-shard
        (``spatial``) each runs in its sharded form."""
        dt = self.dtype
        k, b = self.conv1.kernel, self.conv1.bias
        if fused_up is None:
            with span("weights"):
                kw, bs = s2d_ops.windowed_down_kernel(k), s2d_ops.s2d_vector(b).to(dt)
            x = x.to(dt)
            x = s2d_ops.conv3x3_windowed_down(x, kw) if spatial is None else spatial.windowed_down(x, kw)
            x = x + bs
        else:
            x_prev, wt, bias_up = fused_up
            skip_c = x.shape[-1] // 4
            with span("weights"):
                k_skip, k_prev = dec_conv1_weights(k, skip_c, wt)
                t9 = dec_conv1_bias_table(k, skip_c, bias_up, b)
            preact = dec_conv1_preact if spatial is None else spatial.dec_conv1_train
            x = preact(x.to(dt), x_prev.to(dt), k_skip, k_prev, t9)
        x = self._bn_relu_s2d(x, self._conv_bn(1)[1])
        x = (conv2_s2d_train if spatial is None else spatial.psel_train)(x, self.conv2.kernel)
        with span("weights"):
            bs = s2d_ops.s2d_vector(self.conv2.bias).to(dt)
        x = x + bs
        return self._bn_relu_s2d(x, self._conv_bn(2)[1])

    @staticmethod
    def _bn_relu_s2d(x: torch.Tensor, bn: Optional[FoldableBatchNorm]) -> torch.Tensor:
        if bn is None:
            return torch.relu(x)
        b, hh, ww, z = x.shape
        return torch.relu(bn(x.reshape(b, hh, ww, 4, z // 4)).reshape(b, hh, ww, z))


def _max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool(2, 2) on NHWC (floor: an odd trailing row/col is dropped)."""
    b, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


class UNetEncoder(nn.Module):
    """``depth`` ConvBlock+MaxPool stages and a bottleneck (``block{i}``,
    ``bottleneck``)."""

    def __init__(self, in_channels, init_features, depth, gen, dtype=torch.float32, use_batchnorm=True,
                 remat=False):
        super().__init__()
        self.depth = depth
        self.dtype = dtype
        self.level_spans = tuple(f"unet.enc{i}" for i in range(depth))
        cin, f = in_channels, init_features
        for i in range(depth):
            self.add_module(f"block{i}", ConvBlock(cin, f, gen, dtype, use_batchnorm, remat))
            cin, f = f, 2 * f
        self.bottleneck = ConvBlock(cin, f, gen, dtype, use_batchnorm, remat)

    def forward(self, x: torch.Tensor, s2d_levels: Sequence[int], spatial=None):
        """Returns ``(skips, bottleneck, skip_s2d, skip_hw)``: ``skips[i]`` is
        the full-res skip of a standard level (None at s2d levels, whose
        phase-major form is ``skip_s2d[i]``); ``skip_hw[i]`` its (H, W)."""
        skips: List[Optional[torch.Tensor]] = []
        skip_s2d: Dict[int, torch.Tensor] = {}
        skip_hw: List[Tuple[int, int]] = []
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            skip_hw.append((x.shape[1], x.shape[2]))
            with span(self.level_spans[i]):
                if i in s2d_levels:
                    s = block.forward_s2d(x.to(self.dtype), spatial=spatial)
                    skip_s2d[i] = s
                    skips.append(None)
                    x = encoder_pool(s, self.training)
                else:
                    x = block(x, spatial)
                    skips.append(x)
                    x = _max_pool_2x2(x)
        with span("unet.bottleneck"):
            x = self.bottleneck(x, spatial)
        return skips, x, skip_s2d, skip_hw


class DecoderBlock(nn.Module):
    """ConvTranspose(k2, s2) halving channels → pad to the skip's size →
    concat [skip, up] → ConvBlock (``upsample``, ``conv_block``)."""

    def __init__(self, in_features, skip_features, out_features, up_features, gen, dtype=torch.float32,
                 use_batchnorm=True, remat=False):
        super().__init__()
        self.dtype = dtype
        self.upsample = ConvParams(in_features, up_features, (2, 2), gen)
        self.conv_block = ConvBlock(skip_features + up_features, out_features, gen, dtype, use_batchnorm, remat)

    def forward(self, x_prev: torch.Tensor, x_skip: torch.Tensor, spatial=None) -> torch.Tensor:
        x_up = conv_transpose2x2_nhwc(x_prev.to(self.dtype), self.upsample.kernel, self.upsample.bias)
        dh = x_skip.shape[1] - x_up.shape[1]
        dw = x_skip.shape[2] - x_up.shape[2]
        if dh or dw:
            x_up = F.pad(x_up, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv_block(torch.cat([x_skip.to(self.dtype), x_up], dim=-1), spatial)

    def forward_s2d(self, x_prev: torch.Tensor, x_skip_s2d: torch.Tensor, spatial=None) -> torch.Tensor:
        """Whole block in s2d layout: the upsample is folded into conv1."""
        if x_prev.shape[:3] != x_skip_s2d.shape[:3]:
            raise ValueError(
                f"s2d DecoderBlock needs matching grids: skip {tuple(x_skip_s2d.shape)} "
                f"vs prev {tuple(x_prev.shape)}"
            )
        with span("weights"):
            wt = s2d_ops.s2d_convt2x2_kernel(self.upsample.kernel)
        return self.conv_block.forward_s2d(x_skip_s2d, fused_up=(x_prev.to(self.dtype), wt, self.upsample.bias),
                                           spatial=spatial)


class UNetDecoder(nn.Module):
    """Upsampling path (``block{j}``, ``final_conv``)."""

    def __init__(self, num_classes, init_features, depth, gen, dtype=torch.float32, use_batchnorm=True,
                 remat=False):
        super().__init__()
        self.depth = depth
        self.dtype = dtype
        self.level_spans = tuple(f"unet.dec{i}" for i in range(depth))
        prev = init_features * 2**depth
        for j, i in enumerate(reversed(range(depth))):
            out = init_features * 2**i
            self.add_module(f"block{j}", DecoderBlock(prev, out, out, prev // 2, gen, dtype, use_batchnorm, remat))
            prev = out
        self.final_conv = ConvParams(prev, num_classes, (1, 1), gen)

    def forward(self, skips, bottleneck, skip_s2d, skip_hw, spatial=None):
        """Returns ``(logits f32 (f64 in an f64 model), f_u shallow→deep,
        f_u_s2d)``; ``f_u[0]`` is
        None when level 0 ran in s2d (its phase-major form is
        ``f_u_s2d[0]``)."""
        x = bottleneck
        f_u_s2d: Dict[int, torch.Tensor] = {}
        feats: List[Optional[torch.Tensor]] = []
        for j, i in enumerate(reversed(range(self.depth))):
            block = getattr(self, f"block{j}")
            with span(self.level_spans[i]):
                if i in skip_s2d and skip_hw[i] == (2 * x.shape[1], 2 * x.shape[2]):
                    f = block.forward_s2d(x, skip_s2d[i], spatial)
                    f_u_s2d[i] = f
                    x = decoder_d2s(f, self.training) if i > 0 else None
                else:
                    skip = skips[i] if skips[i] is not None else s2d_ops.depth_to_space(skip_s2d[i])
                    x = block(x, skip, spatial)
            feats.append(x)
        with span("unet.head"):
            logits = self._head(x, f_u_s2d)
        return logits.to(torch.promote_types(logits.dtype, torch.float32)), feats[::-1], f_u_s2d

    def _head(self, x: Optional[torch.Tensor], f_u_s2d: Dict[int, torch.Tensor]) -> torch.Tensor:
        """The final 1×1 conv of the last decoder output, in its dtype."""
        dt = self.dtype
        k, b = self.final_conv.kernel, self.final_conv.bias
        if 0 in f_u_s2d:
            # Final 1×1 conv in s2d layout (block-diagonal per-phase matmul),
            # so only the num_classes-wide result goes back to full res.
            with span("weights"):
                k_s2d, b_s2d = s2d_ops.s2d_1x1_kernel(k).to(dt), s2d_ops.s2d_vector(b).to(dt)
            return s2d_ops.depth_to_space(f_u_s2d[0].to(dt) @ k_s2d + b_s2d)
        return conv2d_nhwc(x.to(dt), k, b, padding=0)


class UNet(nn.Module):
    """Encoder∘decoder; ``forward(x) → dict(logits, skips, f_u, skip_s2d,
    f_u_s2d)``.

    The s2d levels follow from the shape alone: level 0 runs in s2d layout
    when H and W are even, level 1 when ``depth ≥ 2`` and H, W are multiples
    of 4 (the JAX package's TPU profitability gate is not carried over).
    ``use_batchnorm`` and ``remat`` apply to every ``ConvBlock``."""

    def __init__(self, gen, in_channels=3, num_classes=2, init_features=32, depth=4,
                 dtype=torch.float32, use_batchnorm=True, remat=False):
        super().__init__()
        self.depth = depth
        self.dtype = dtype
        self.encoder = UNetEncoder(in_channels, init_features, depth, gen, dtype, use_batchnorm, remat)
        self.decoder = UNetDecoder(num_classes, init_features, depth, gen, dtype, use_batchnorm, remat)

    def s2d_levels(self, h: int, w: int) -> Tuple[int, ...]:
        levels = []
        if h % 2 == 0 and w % 2 == 0:
            levels.append(0)
        if self.depth >= 2 and h % 4 == 0 and w % 4 == 0:
            levels.append(1)
        return tuple(levels)

    def forward(self, x: torch.Tensor, full_res_outputs: bool = False, spatial=None) -> Dict[str, object]:
        """``spatial``: a ``parallel/spatial.py::SpatialShard`` when x is one
        H-shard of the input (the shard's height a multiple of
        2^(depth + 1), in eval and in train mode); every output is then this
        shard's rows, and train-mode BN takes the statistics of every shard."""
        if spatial is not None:
            if x.shape[1] % 2 ** (self.depth + 1):
                raise ValueError(f"an H-shard of {x.shape[1]} rows is not a multiple of 2^(depth + 1) = "
                                 f"{2 ** (self.depth + 1)}")
            if x.shape[1] * spatial.count != spatial.h_global:
                raise ValueError(f"{spatial.count} shards of {x.shape[1]} rows do not make the scene's "
                                 f"{spatial.h_global}")
        with span("unet"):
            x = x.to(self.dtype)
            with dp.spatial_norm(None if spatial is None else spatial.mesh):
                skips, bottleneck, skip_s2d, skip_hw = self.encoder(x, self.s2d_levels(x.shape[1], x.shape[2]),
                                                                    spatial)
                logits, f_u, f_u_s2d = self.decoder(skips, bottleneck, skip_s2d, skip_hw, spatial)
            if full_res_outputs:
                skips = [s if s is not None else s2d_ops.depth_to_space(skip_s2d[i]) for i, s in enumerate(skips)]
                f_u = [f if f is not None else decoder_d2s(f_u_s2d[i], self.training) for i, f in enumerate(f_u)]
        return {"logits": logits, "skips": skips, "f_u": f_u, "skip_s2d": skip_s2d, "f_u_s2d": f_u_s2d}
