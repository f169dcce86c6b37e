"""The f32 3×3 'SAME' train conv of the standard-layout ConvBlocks and the
detection head as a hand-written CUDA kernel (K10), with its plain PyTorch
version.

It replaces no TPU kernel: the JAX package leaves these convs to XLA, and
the port ran them through cuDNN, which in f32 with TF32 off takes its FMA
or FFT routes. :func:`conv3x3_fwd` is ``conv3x3(x, kernel) + bias`` on NHWC
f32 (``csrc/conv3x3.cu``: wgmma with each f32 operand split into a bf16
pair ``hi = bf16(a)``, ``lo = bf16(a − hi)`` and each product taken as
``hi·hi + hi·lo + lo·hi``, the form of K8 in f32); :func:`conv3x3_dgrad` is
the same kernel on the cotangent with the adjoint kernel (taps flipped,
input and output channels swapped), no bias. :func:`pack_weights` splits
and packs a kernel once a call, on its device, into the stream of stages
the kernel consumes. It takes any Cin, Cout, H and W: above 256 output
channels a block computes one channel tile.

:func:`tile` picks the kernel's tile from the widths: N the smallest of
:data:`WIDTHS` that holds Cout. Where Cout is a multiple of 64 (every
standard-block conv and its adjoint) that is K8's channel tile, and every x
chunk runs its 4 k-steps. At the narrow widths (:data:`NARROW`: Cout up to
48 or from 65 to 96, as at the detection head's 96 → 48 → 24 convs and
their adjoints) the narrow tile: no wgmma computes more than 8 padded channels,
the last x chunk stops at Cin's last 16-channel k-step, and two blocks
share an SM.

:func:`conv3x3_train` is the differentiable conv as a
``torch.autograd.Function``: forward and dx through the kernel, the kernel
and bias gradients through cuDNN's weight-gradient call
(:func:`conv3x3_wgrad`), as autograd's backward of ``F.conv2d`` computes
them. On a CPU tensor each wrapper runs its plain version, so the same
Function is testable there. ``launches`` on each wrapper counts kernel
launches, ``narrow`` those that took the narrow tile.

Who decides. ``models/unet.py::ConvBlock`` calls :func:`conv3x3_same` for
every conv of an unsharded standard-layout block in a train forward, and
``models/detection.py::DetectionHead`` for its two convs: it runs
:func:`conv3x3_train` where :func:`split_conv` holds (an f32 tensor on the
card) and ``conv2d_nhwc`` otherwise. The U-Net keeps only the choice of
the sharded form, whose exchange is its own.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mingraph_unet_tpu_torch.ops.conv import conv2d_nhwc
from mingraph_unet_tpu_torch.ops.kernels.build import check_cuda_input, library, require, stream_ptr
from mingraph_unet_tpu_torch.ops.kernels.conv_block import CHUNK, pack_stream
from mingraph_unet_tpu_torch.utils.profiling import span

__all__ = ["NARROW", "WIDTHS", "adjoint", "conv3x3_dgrad", "conv3x3_dgrad_plain", "conv3x3_fwd", "conv3x3_plain",
           "conv3x3_same", "conv3x3_train", "conv3x3_wgrad", "pack_weights", "split_conv", "tile"]

# The widths the kernel is built for (N of its wgmma, ``csrc/conv3x3.cu``),
# and those of them that run the narrow tile.
WIDTHS, NARROW = (24, 48, 64, 96, 128, 256), (24, 48, 96)
KSTEP = 16  # input channels of a k-step


def adjoint(kernel: torch.Tensor) -> torch.Tensor:
    """The 3×3 'SAME' conv's adjoint kernel: spatially flipped, in/out
    transposed, (3, 3, Cin, Cout) → (3, 3, Cout, Cin)."""
    return kernel.flip(0, 1).transpose(2, 3)


def conv3x3_plain(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``conv2d_nhwc(x, kernel, bias, padding=1)`` in x's dtype."""
    return conv2d_nhwc(x, kernel, bias, padding=1)


def conv3x3_dgrad_plain(g: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """dx of the conv for cotangent ``g``: the same conv with the adjoint
    kernel, no bias, in g's dtype."""
    return conv2d_nhwc(g, adjoint(kernel), None, padding=1)


def tile(cin: int, cout: int) -> Tuple[int, int]:
    """(NT, KL): the output channels a block computes, the smallest of
    :data:`WIDTHS` that holds Cout (256 above: several channel tiles), and
    the k-steps of the last x chunk. With the narrow tile (NT in
    :data:`NARROW`) KL stops at Cin's last 16-channel step; elsewhere it is
    4, and NT is K8's ``channel_tile(Cout)``."""
    nt = next((n for n in WIDTHS if n >= cout), WIDTHS[-1])
    if nt not in NARROW:
        return nt, CHUNK // KSTEP
    left = cin - (-(-cin // CHUNK) - 1) * CHUNK  # input channels of the last x chunk
    return nt, -(-left // KSTEP)


def pack_weights(kernel: torch.Tensor) -> torch.Tensor:
    """The weight stream of ``csrc/conv3x3.cu``: (channel tiles, bytes / 2)
    as bf16, for the channel tile NT of :func:`tile`.

    Input channels are padded with zeros to a multiple of 64 (x chunks),
    output channels to whole tiles. For each channel tile, x chunk and tap:
    the chunk's k-steps (4; in the last chunk KL of :func:`tile`), each the
    hi then the lo 16 × NT slab (:func:`conv_block.pack_stream`, K8's conv2
    layout); the kernel reads them in stages of whole k-steps. Where NT is
    not narrow the stream is ``pack_stream``'s as it is."""
    cin, c = kernel.shape[2], kernel.shape[3]
    nt, last = tile(cin, c)
    xc, ntl = -(-cin // CHUNK), -(-c // nt)
    wp = F.pad(kernel.float().reshape(9, cin, c), (0, ntl * nt - c, 0, xc * CHUNK - cin))
    stream = pack_stream(wp, nt)
    if last == CHUNK // KSTEP:
        return stream.reshape(ntl, -1)
    steps = stream.reshape(ntl, xc, 9, CHUNK // KSTEP, -1)  # a k-step's hi and lo slabs
    return torch.cat([steps[:, :-1].reshape(ntl, -1), steps[:, -1, :, :last].reshape(ntl, -1)], dim=1)


def _launch(name: str, x: torch.Tensor, kernel: torch.Tensor,
            bias: Optional[torch.Tensor]) -> Tuple[torch.Tensor, bool]:
    """The kernel on x (B, H, W, Cin) f32 with ``kernel`` (3, 3, Cin, Cout)
    as it is given (the caller passes the adjoint for dx) and ``bias``
    (Cout,) or None: (y, whether the narrow tile ran); raises on what it
    does not take."""
    check_cuda_input("x", x, torch.float32)
    b, h, w, cin = x.shape
    cout = kernel.shape[-1]
    require(tuple(kernel.shape) == (3, 3, cin, cout), f"{name}: kernel must be (3, 3, {cin}, Cout), "
                                                       f"got {tuple(kernel.shape)}")
    require(kernel.dtype == torch.float32 and kernel.device == x.device,
            f"{name}: kernel must be f32 on {x.device}, got {kernel.dtype} on {kernel.device}")
    if bias is not None:
        require(tuple(bias.shape) == (cout,) and bias.dtype == torch.float32 and bias.device == x.device,
                f"{name}: bias must be ({cout},) f32 on {x.device}, got {tuple(bias.shape)} {bias.dtype}")
        bias = bias.contiguous()
    with span("weights"):
        stream = pack_weights(kernel)
    nt, _ = tile(cin, cout)
    y = torch.empty((b, h, w, cout), dtype=torch.float32, device=x.device)
    rc = library("conv3x3").mgu_conv3x3(x.data_ptr(), stream.data_ptr(), None if bias is None else bias.data_ptr(),
                                        y.data_ptr(), b, h, w, cin, cout, nt, stream_ptr(x))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    return y, nt in NARROW


def conv3x3_fwd(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``conv3x3(x, kernel) + bias``, 'SAME', f32: x (B, H, W, Cin) NHWC,
    kernel (3, 3, Cin, Cout), bias (Cout,); returns (B, H, W, Cout)
    NHWC-contiguous. A CPU tensor runs :func:`conv3x3_plain`; a CUDA tensor
    launches the kernel (x f32, contiguous, 16-byte aligned) or raises."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, kernel, bias)
    with span("kernel.conv3x3_fwd", (x, kernel, bias)):
        y, narrow = _launch("conv3x3_fwd", x, kernel, bias)
    conv3x3_fwd.launches += 1
    conv3x3_fwd.narrow += narrow
    return y


conv3x3_fwd.launches = conv3x3_fwd.narrow = 0


def conv3x3_dgrad(g: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """dx of :func:`conv3x3_fwd` for cotangent g (B, H, W, Cout):
    (B, H, W, Cin) f32, the kernel on g with :func:`adjoint` of ``kernel``
    packed on its device. A CPU tensor runs :func:`conv3x3_dgrad_plain`."""
    if g.device.type == "cpu":
        return conv3x3_dgrad_plain(g, kernel)
    with span("kernel.conv3x3_dgrad", (g, kernel)):
        dx, narrow = _launch("conv3x3_dgrad", g, adjoint(kernel), None)
    conv3x3_dgrad.launches += 1
    conv3x3_dgrad.narrow += narrow
    return dx


conv3x3_dgrad.launches = conv3x3_dgrad.narrow = 0


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor, kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dkernel (3, 3, Cin, Cout), dbias (Cout,)) of the conv for cotangent
    g: cuDNN's weight-gradient call (``aten.convolution_backward`` with
    ``output_mask`` (False, True, True)) on the NCHW views that
    :func:`conv2d_nhwc` gives ``F.conv2d``, under the backend's TF32 flags,
    as autograd's backward of the conv makes it."""
    cout = kernel.shape[-1]
    _, dw, db = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), kernel.to(x.dtype).permute(3, 2, 0, 1), [cout],
        [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [False, True, True])
    return dw.permute(2, 3, 1, 0), db


class _Conv3x3Train(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, bias):
        ctx.save_for_backward(x, kernel)
        return conv3x3_fwd(x, kernel, bias)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        g = g.contiguous()  # autograd may hand the cotangent over strided or expanded
        dx = conv3x3_dgrad(g, kernel) if ctx.needs_input_grad[0] else None
        dk, db = conv3x3_wgrad(x, g, kernel) if ctx.needs_input_grad[1] or ctx.needs_input_grad[2] else (None, None)
        return dx, dk, db


def conv3x3_train(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Differentiable ``conv3x3(x, kernel) + bias`` ('SAME', NHWC): forward
    through :func:`conv3x3_fwd`, dx through :func:`conv3x3_dgrad`, the
    kernel and bias gradients through :func:`conv3x3_wgrad`."""
    return _Conv3x3Train.apply(x, kernel, bias)


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def split_conv(x: torch.Tensor) -> bool:
    """Whether the conv of ``x`` runs the kernel: an f32 tensor on the
    card."""
    return x.dtype == torch.float32 and _on_card(x)


def conv3x3_same(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """A 3×3 conv, 'SAME' + bias, NHWC (a standard-layout ConvBlock's in a
    train forward, the detection head's): :func:`conv3x3_train` (K10)
    where :func:`split_conv` holds, else ``conv2d_nhwc`` (cuDNN on the
    card)."""
    if split_conv(x):
        return conv3x3_train(x.contiguous(), kernel, bias)
    return conv2d_nhwc(x, kernel, bias, padding=1)
