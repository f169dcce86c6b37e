"""Load a flax checkpoint of the JAX ``MinGraphUNet`` into the port.

The port's modules keep flax's names and layouts (``models/layers.py``), so
a leaf ``params/unet/encoder/block0/conv1/kernel`` is the state_dict entry
``unet.encoder.block0.conv1.kernel`` and ``batch_stats/.../bn1/mean`` the
buffer ``....bn1.mean``, unchanged. ConvTranspose kernels stay in flax
layout too; the spatial flip that torch's transposed conv needs is applied
where the port calls it (``ops/conv.py::conv_transpose2x2_nhwc``) and in
the s2d upsample transform (``ops/s2d.py::s2d_convt2x2_kernel``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["variables_from_jax", "load_jax_variables"]


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def variables_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``{"params": ..., "batch_stats": ...}`` (nested mappings of
    array-likes) → a flat state_dict of f32 CPU tensors."""
    unknown = set(tree) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unexpected variable collections {sorted(unknown)}")
    state: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for key, arr in _flatten(tree.get(collection, {})).items():
            if key in state:
                raise ValueError(f"{key} appears in more than one collection")
            state[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return state


def load_jax_variables(model: nn.Module, tree: Mapping) -> nn.Module:
    """Strictly load a flax variable tree into ``model``: every leaf is
    used, every parameter and buffer of the port is set, shapes must match."""
    state = variables_from_jax(tree)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    unused = sorted(set(state) - set(own))
    if missing or unused:
        raise ValueError(f"checkpoint mismatch: missing {missing}, unused {unused}")
    for key, t in state.items():
        if tuple(t.shape) != tuple(own[key].shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != port shape {tuple(own[key].shape)}")
    model.load_state_dict(state, strict=True)
    return model
