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
output byte once, 16 bytes per thread. Both take the shapes their ``_fits``
rule accepts (bf16 or f32, C·itemsize a multiple of 16 bytes), have no
backward, and are exact.
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

__all__ = ["depth_to_space_fits", "depth_to_space_kernel", "phase_max_pool_fits", "phase_max_pool_kernel"]


def phase_max_pool_fits(dtype: torch.dtype, c: int) -> bool:
    """Whether the kernel takes C channels per phase of this dtype: bf16 or
    f32, and C·itemsize a multiple of 16 bytes."""
    return dtype in KERNEL_DTYPES and (c * dtype.itemsize) % 16 == 0


def phase_max_pool_kernel(y_s2d: torch.Tensor) -> torch.Tensor:
    """MaxPool(2, 2) in s2d layout; a CPU tensor runs the plain
    ``ops/s2d.py::phase_max_pool``. On CUDA: the shapes
    :func:`phase_max_pool_fits` accepts; no backward. Exact (the max
    selects one of its inputs)."""
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

# The same rule: 16-byte vectors of one phase group.
depth_to_space_fits = phase_max_pool_fits


def depth_to_space_kernel(y_s2d: torch.Tensor) -> torch.Tensor:
    """Depth-to-space of a phase-major s2d tensor; a CPU tensor runs the
    plain ``ops/s2d.py::depth_to_space``. On CUDA: the shapes
    :func:`depth_to_space_fits` accepts; no backward. The output is the
    same permutation of the input, bit for bit."""
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
