"""MinGraph-UNet in PyTorch for NVIDIA Hopper (H100).

A port of ``mingraph_unet_tpu`` (JAX/Pallas on TPU), which stays beside it
as the reference. Module paths mirror the JAX package's (``ops/s2d.py``,
``models/unet.py``, ...). Public functions keep the JAX layouts at their
boundary: NHWC images, phase-major space-to-depth tensors
``(B, H/2, W/2, 4C)``, and flax-layout kernels (HWIO convs, (in, out)
dense).

The hand-written CUDA kernels live in ``csrc/`` and are built with ``nvcc``
at first use on a CUDA tensor (``ops/kernels/build.py``); importing the
package builds nothing. Entry points run on the card unless the caller
passes ``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version.
"""

from mingraph_unet_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
