"""Parameter holders with the flax parameter trees of the JAX package.

Each module stores its parameters under flax's leaf names and in flax's
layouts (conv kernels HWIO, dense kernels (in, out), BatchNorm ``scale`` /
``bias`` with running ``mean`` / ``var`` buffers), so a flax checkpoint maps
onto the port's ``state_dict`` by renaming alone (``convert.py``) and the
s2d kernel transforms work on the same layout as in JAX. Parameters stay
float32; modules cast them to the compute dtype at use, as flax does.

Random init draws from an explicit ``torch.Generator`` (CPU), with flax's
initializers: LeCun-normal kernels (truncated normal), zero biases, unit
BatchNorm scales and variances. :func:`dropout` draws its masks from a
``torch.Generator`` on the tensor's device, passed in by the caller.

Inside ``parallel/data.py::data_parallel`` (data-parallel training) the
batch is this rank's rows of a global batch: train-mode BatchNorm takes
the statistics of the global batch (of every H-shard of it inside
``spatial_norm``), and dropout draws the global batch's mask and keeps
this rank's rows.

Inside :func:`recomputing` (a rematerialized block's recompute in the
backward) train-mode BatchNorm normalizes as in the forward but leaves its
running statistics alone: the forward has updated them once, as flax's
``nn.remat`` does.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Iterator, Optional, Sequence, Tuple

import torch
from torch import nn

from mingraph_unet_tpu_torch.parallel import data as dp

__all__ = ["lecun_normal", "xavier_uniform", "dropout", "recomputing", "ConvParams", "Dense", "FoldableBatchNorm"]

_recomputing: ContextVar[bool] = ContextVar("recomputing", default=False)


@contextmanager
def recomputing(ctx: dp.NormContext) -> Iterator[None]:
    """Within: a recompute of a forward that ran under the norm groups
    ``ctx`` (``parallel/data.py::norm_context``), which it restores; BN
    leaves its running statistics alone."""
    token = _recomputing.set(True)
    try:
        with dp.restored(ctx):
            yield
    finally:
        _recomputing.reset(token)


def lecun_normal(shape: Sequence[int], fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal (±2σ) with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # stddev of N(0,1) cut at ±2
    t = torch.empty(tuple(shape))
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * std


def xavier_uniform(
    shape: Sequence[int], gain: float, fan_in: int, fan_out: int, gen: torch.Generator
) -> torch.Tensor:
    """Xavier-uniform with explicit fans (the GAT's reference init)."""
    limit = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(tuple(shape), generator=gen) * 2.0 - 1.0) * limit


def dropout(x: torch.Tensor, p: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 − p and
    scale the kept ones by 1/(1 − p). The identity when ``p == 0`` or
    ``gen is None`` (eval: modules pass a generator only in train mode).
    The mask is drawn from ``gen``, which must live on x's device; it cannot
    reproduce JAX's random bits, only their distribution."""
    if gen is None or p == 0.0:
        return x
    if not 0.0 < p < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {p}")
    shard = dp.active()
    shape = x.shape if shard is None else (shard.total,) + tuple(x.shape[1:])
    keep = dp.local_rows(torch.rand(shape, generator=gen, device=x.device) < (1.0 - p))
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class ConvParams(nn.Module):
    """``nn.Conv``'s tree: ``kernel (kh, kw, Cin, Cout)``, ``bias (Cout,)``."""

    def __init__(self, in_features: int, features: int, kernel_size: Tuple[int, int], gen: torch.Generator):
        super().__init__()
        kh, kw = kernel_size
        self.kernel = nn.Parameter(lecun_normal((kh, kw, in_features, features), kh * kw * in_features, gen))
        self.bias = nn.Parameter(torch.zeros(features))


class Dense(nn.Module):
    """flax ``nn.Dense``: ``y = x @ kernel + bias`` in the compute dtype."""

    def __init__(self, in_features: int, features: int, gen: torch.Generator, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal((in_features, features), in_features, gen))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ self.kernel.to(self.dtype) + self.bias.to(self.dtype)


class FoldableBatchNorm(nn.Module):
    """flax ``nn.BatchNorm``'s tree (``scale``, ``bias``; running ``mean``
    and ``var`` buffers), normalizing over every axis but the last.

    Eval mode (``model.eval()``): the affine ``BN(z) = a·z + c`` with
    ``a = scale / sqrt(var + eps)``, ``c = bias − mean·a``, in f32, which the
    U-Net folds into its convs. Train mode: the batch statistics in f32 (f64
    for an f64 input) with
    the biased variance ``E[z²] − E[z]²`` (clipped at 0 against rounding,
    as flax does), and the running statistics
    updated as ``0.9·running + 0.1·batch`` (flax's decay, and the biased
    variance, where ``nn.BatchNorm2d`` keeps the unbiased one), but not in
    a :func:`recomputing` pass. Gradients
    flow through the batch mean and variance; the output is in z's dtype.
    In data-parallel training the batch is the global one: Σz and Σz² are
    summed over the ranks through a differentiable all-reduce, over the
    batch group and, inside ``parallel/data.py::spatial_norm`` (the
    H-sharded U-Net), the spatial group first."""

    MOMENTUM = 0.9  # flax's running-average decay

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.epsilon = epsilon

    def eval_affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        a = self.scale * torch.rsqrt(self.var + self.epsilon)
        return a, self.bias - self.mean * a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            a, c = self.eval_affine()
            return x * a.to(x.dtype) + c.to(x.dtype)
        axes = tuple(range(x.dim() - 1))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        groups, parts = dp.norm_groups()
        if not groups:
            mean, mean2 = xf.mean(axes), (xf * xf).mean(axes)
        else:
            sums = dp.all_reduce_sum(torch.stack([xf.sum(axes), (xf * xf).sum(axes)]), *groups)
            mean, mean2 = sums / (xf.numel() // xf.shape[-1] * parts)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        if not _recomputing.get():
            with torch.no_grad():
                m = self.MOMENTUM
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        a = self.scale * torch.rsqrt(var + self.epsilon)
        c = self.bias - mean * a
        return x * a.to(x.dtype) + c.to(x.dtype)
