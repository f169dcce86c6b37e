"""Host set-up for the command-line entry points. Counterpart of
``mingraph_unet_tpu/utils/env.py``, which warms XLA's compile cache and
picks JAX's backend; here the device is resolved and, on the card, the
CUDA kernels are built (or found built) before the first step.
"""

from __future__ import annotations

import torch

from mingraph_unet_tpu_torch.device import resolve_device
from mingraph_unet_tpu_torch.ops.kernels import build

__all__ = ["setup_host"]


def setup_host(force_cpu: bool = False) -> torch.device:
    """The device an entry point runs on: the CPU with ``force_cpu``,
    otherwise the CUDA card (``RuntimeError`` where there is none), for
    which every ``csrc/*.cu`` library is built now."""
    device = resolve_device("cpu" if force_cpu else None)
    if device.type == "cuda":
        build.build_all()
    return device
