"""NHWC / HWIO convolutions through ``torch.nn.functional``.

The port keeps the JAX package's layouts: activations NHWC, conv kernels
HWIO (flax). cuDNN takes NCHW-shaped tensors in any memory format, so these
helpers hand it permuted views: an NHWC-contiguous tensor viewed as NCHW has
channels_last strides, cuDNN then produces a channels_last result, and the
permute back is again NHWC-contiguous. No relayout copy sits between these
convs and the hand-written kernels that read NHWC.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = ["conv2d_nhwc", "conv_transpose2x2_nhwc"]


def conv2d_nhwc(
    x: torch.Tensor,
    kernel_hwio: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: Union[int, Tuple[int, int]] = 1,
) -> torch.Tensor:
    """``conv(x (B, H, W, Cin), K (kh, kw, Cin, Cout)) + bias`` in x's dtype,
    returned NHWC (and NHWC-contiguous)."""
    w = kernel_hwio.to(x.dtype).permute(3, 2, 0, 1)
    b = None if bias is None else bias.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def conv_transpose2x2_nhwc(
    x: torch.Tensor, kernel_hwio: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """flax ``nn.ConvTranspose(kernel_size=(2, 2), strides=(2, 2), 'VALID')``
    on NHWC. flax applies the kernel without the spatial mirror that torch's
    transposed conv applies, so the torch weight is the spatially flipped
    kernel, (Cin, Cout, kh, kw)."""
    w = kernel_hwio.to(x.dtype).flip(0, 1).permute(2, 3, 0, 1)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, bias.to(x.dtype), stride=2)
    return y.permute(0, 2, 3, 1).contiguous()
