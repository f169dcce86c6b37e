"""Seeded weights for a configuration, drawn on the device in one call.

One normal draw of every leaf's elements from a ``torch.Generator`` on the
device, then each leaf scaled and shifted by its kind: LeCun-normal conv
and dense kernels (standard deviation 1/sqrt(fan-in)), Xavier-scaled GAT
projections and attention vectors, small biases, BatchNorm scales around
1, shifts and running means around 0 and running variances in [0.5, 1.5],
so that folding BN into the convs is not the identity. The same dict goes
to the program (``load_state_dict``, strict) and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

Spec = Sequence[Tuple[str, Tuple[int, ...], str]]


def _scale_shift(shape: Tuple[int, ...], kind: str) -> Tuple[float, float]:
    if kind == "kernel":
        return 1.0 / math.sqrt(math.prod(shape[:-1])), 0.0
    if kind == "gat_W":
        return 1.414 * math.sqrt(2.0 / (shape[1] + shape[2])), 0.0
    if kind == "gat_a":
        return 1.414 * math.sqrt(2.0 / (2 * shape[1] + 1)), 0.0
    return {"bias": (0.1, 0.0), "bn_scale": (0.1, 1.0), "bn_bias": (0.1, 0.0), "bn_mean": (0.1, 0.0),
            "bn_var": (0.0, 0.0)}[kind]


def draw_weights(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{name: f32 tensor}`` for every leaf of ``spec`` from ``seed``."""
    counts = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(counts), generator=gen, device=device)
    ss = [_scale_shift(shape, kind) for _, shape, kind in spec]
    n = torch.tensor(counts, device=device)
    scale = torch.repeat_interleave(torch.tensor([s for s, _ in ss], device=device), n)
    shift = torch.repeat_interleave(torch.tensor([t for _, t in ss], device=device), n)
    var = torch.repeat_interleave(torch.tensor([kind == "bn_var" for _, _, kind in spec], device=device), n)
    # Running variances: 0.5 + the normal's CDF, in [0.5, 1.5].
    flat = torch.where(var, 0.5 + 0.5 * (1.0 + torch.erf(flat / math.sqrt(2.0))), flat * scale + shift)
    out: Dict[str, torch.Tensor] = {}
    for (name, shape, _), piece in zip(spec, torch.split(flat, counts)):
        out[name] = piece.view(shape)
    return out


def names(spec: Spec) -> List[str]:
    return [name for name, _, _ in spec]
