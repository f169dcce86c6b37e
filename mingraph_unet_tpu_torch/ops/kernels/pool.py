"""The U-Net's two s2d relayout kernels, hand-written in CUDA, with their
plain PyTorch versions. Counterpart of ``mingraph_unet_tpu/ops/pallas/pool.py``.

- :func:`phase_max_pool_kernel` replaces ``phase_max_pool_pallas``:
  ``(B, Hh, Ww, 4C) → (B, Hh, Ww, C)``, the max over the four phase groups,
  which is MaxPool2d(2, 2) of the full-resolution tensor
  (``csrc/phase_pool.cu``).
- :func:`depth_to_space_kernel` replaces ``depth_to_space_pallas``:
  ``(B, Hh, Ww, 4C) → (B, 2Hh, 2Ww, C)``, the decoder's s2d output turned
  to full resolution, a pure permutation (``csrc/d2s.cu``).

Memory bounds both: each kernel reads each input byte once and writes each
output byte once, 16 bytes per thread. Both take the shapes :func:`_fits`
accepts (bf16 or f32, C·itemsize a multiple of 16 bytes), have no
backward, and are exact.

Who decides. The U-Net (``models/unet.py``, ``models/pipeline.py``) calls
:func:`encoder_pool` and :func:`decoder_d2s`: each runs its kernel wrapper
at inference for a CUDA tensor that :func:`_fits`, and
``ops/s2d.py``'s plain (differentiable) version otherwise, without passing
through the wrapper.
"""

from __future__ import annotations

import torch

from mingraph_unet_tpu_torch.ops import s2d as s2d_ops
from mingraph_unet_tpu_torch.ops.kernels.build import (
    KERNEL_DTYPES,
    check_cuda_input,
    library,
    require,
    require_no_grad,
    stream_ptr,
)
from mingraph_unet_tpu_torch.utils.profiling import span

__all__ = ["decoder_d2s", "depth_to_space_kernel", "encoder_pool", "phase_max_pool_kernel"]


def _on_card(y: torch.Tensor) -> bool:
    return y.is_cuda


def _fits(dtype: torch.dtype, c: int) -> bool:
    """Whether both kernels take C channels per phase of this dtype: bf16
    or f32, and C·itemsize a multiple of 16 bytes."""
    return dtype in KERNEL_DTYPES and (c * dtype.itemsize) % 16 == 0


def _kernel(y_s2d: torch.Tensor, training: bool) -> bool:
    """Whether K3 / K5 take ``y_s2d``: not in training (neither kernel has a
    backward), a CUDA tensor that :func:`_fits`."""
    return not training and _on_card(y_s2d) and _fits(y_s2d.dtype, y_s2d.shape[-1] // 4)


def phase_max_pool_kernel(y_s2d: torch.Tensor) -> torch.Tensor:
    """MaxPool(2, 2) in s2d layout; a CPU tensor runs the plain
    ``ops/s2d.py::phase_max_pool``. On CUDA: the shapes :func:`_fits`
    accepts; no backward. Exact (the max selects one of its inputs)."""
    if y_s2d.device.type == "cpu":
        return s2d_ops.phase_max_pool(y_s2d)
    with span("kernel.phase_max_pool_kernel", (y_s2d,)):
        require_no_grad("phase_max_pool_kernel", y_s2d)
        dt = y_s2d.dtype
        require(dt in KERNEL_DTYPES, f"phase_max_pool_kernel: unsupported dtype {dt}")
        check_cuda_input("y_s2d", y_s2d, dt)
        b, hh, ww, cc = y_s2d.shape
        c = cc // 4
        require(cc % 4 == 0 and (c * y_s2d.element_size()) % 16 == 0,
                f"C={c} channels per phase must fill 16-byte vectors")
        out = torch.empty((b, hh, ww, c), dtype=dt, device=y_s2d.device)
        rc = library("phase_pool").mgu_phase_max_pool(
            y_s2d.data_ptr(), out.data_ptr(), b, hh, ww, c,
            int(dt == torch.bfloat16), stream_ptr(y_s2d),
        )
    if rc != 0:
        raise RuntimeError(f"phase_max_pool_kernel launch failed: cudaError {rc}")
    phase_max_pool_kernel.launches += 1
    return out


phase_max_pool_kernel.launches = 0


def depth_to_space_kernel(y_s2d: torch.Tensor) -> torch.Tensor:
    """Depth-to-space of a phase-major s2d tensor; a CPU tensor runs the
    plain ``ops/s2d.py::depth_to_space``. On CUDA: the shapes :func:`_fits`
    accepts; no backward. The output is the same permutation of the input,
    bit for bit."""
    if y_s2d.device.type == "cpu":
        return s2d_ops.depth_to_space(y_s2d)
    with span("kernel.depth_to_space_kernel", (y_s2d,)):
        require_no_grad("depth_to_space_kernel", y_s2d)
        dt = y_s2d.dtype
        require(dt in KERNEL_DTYPES, f"depth_to_space_kernel: unsupported dtype {dt}")
        check_cuda_input("y_s2d", y_s2d, dt)
        b, hh, ww, cc = y_s2d.shape
        c = cc // 4
        require(cc % 4 == 0 and (c * y_s2d.element_size()) % 16 == 0,
                f"C={c} channels per phase must fill 16-byte vectors")
        out = torch.empty((b, 2 * hh, 2 * ww, c), dtype=dt, device=y_s2d.device)
        rc = library("d2s").mgu_depth_to_space(
            y_s2d.data_ptr(), out.data_ptr(), b, hh, ww, c * y_s2d.element_size() // 16, stream_ptr(y_s2d),
        )
    if rc != 0:
        raise RuntimeError(f"depth_to_space_kernel launch failed: cudaError {rc}")
    depth_to_space_kernel.launches += 1
    return out


depth_to_space_kernel.launches = 0


def encoder_pool(y_s2d: torch.Tensor, training: bool) -> torch.Tensor:
    """An s2d encoder level's MaxPool(2, 2), the max over the phases:
    :func:`phase_max_pool_kernel` (K3) where :func:`_kernel` holds, else
    ``ops/s2d.py::phase_max_pool`` (amax splits the gradient evenly among
    ties, as JAX's max does)."""
    if _kernel(y_s2d, training):
        return phase_max_pool_kernel(y_s2d)
    return s2d_ops.phase_max_pool(y_s2d)


def decoder_d2s(f_s2d: torch.Tensor, training: bool) -> torch.Tensor:
    """A decoder level's s2d output at full resolution:
    :func:`depth_to_space_kernel` (K5) where :func:`_kernel` holds, else
    the plain (differentiable) ``ops/s2d.py::depth_to_space``. Counterpart
    of JAX ``models/unet.py::_d2s``."""
    if _kernel(f_s2d, training):
        return depth_to_space_kernel(f_s2d)
    return s2d_ops.depth_to_space(f_s2d)
