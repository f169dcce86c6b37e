"""The s2d U-Net convs as hand-written CUDA kernels, with their plain
PyTorch versions. Counterpart of ``mingraph_unet_tpu/ops/pallas/psconv.py``.

- :func:`psel_conv3x3` replaces ``conv3x3_s2d_psel``: ReLU of a 3×3 'SAME'
  conv + bias of a phase-major s2d tensor (the s2d ConvBlock's conv2).
- :func:`dec_conv1_fused` replaces ``dec_conv1_fused``: the s2d decoder's
  conv1, ``relu(conv3x3([skip ‖ ConvTranspose2x2(x_prev)]) + bias)``, with
  the upsample folded into x_prev's tap weights and the border-attenuated
  upsample-bias field applied as a (3, 3) class table.

Both kernels are one tile design (``csrc/conv_tile.cuh``): an implicit GEMM
over a staged s2d input halo that reads the layout as full-resolution
pixels, so it does the conv's useful FLOPs (not the TPU form's 16/9× or the
dense s2d form's 4×), on tensor cores in bf16. Memory bounds psel on the
H100; dec-conv1 is bound by memory at level 0 and by operations at level 1
(see the header). In bf16 the kernels take their weights in mma.sync
B-fragment order (:func:`mma_b_fragments`) and are instantiated for the
U-Net's two s2d widths: Cout = Cin (psel), Cout = Cs and Cp = 2·Cs
(dec-conv1), with Cin, Cs in {32, 64}.

- :func:`psconv_train` replaces ``psconv_train``: the raw 3×3 s2d conv
  (no bias, no ReLU) of the training path as a ``torch.autograd.Function``.
  Its forward (:func:`psconv_fwd`) and its dgrad (:func:`psconv_dgrad`, the
  same conv on the cotangent with the flipped, in/out-transposed kernel) are
  the psel tile with the ReLU epilogue compiled out; its kernel gradient
  (:func:`psconv_wgrad`) is PyTorch, as the JAX package computes it in XLA.

Each wrapper dispatches on the device of its input: a CPU tensor runs the
plain version, a CUDA tensor launches the kernel (or raises). ``launches``
on each wrapper counts kernel launches. psel, dec-conv1 and the pool have
no backward: on the card they refuse inputs that require a gradient while
autograd records. Callers choose between a kernel and its plain version
from the shapes alone, with :func:`psel_fits` and :func:`dec_conv1_fits`.
"""

from __future__ import annotations

from typing import Optional, Tuple

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

__all__ = [
    "BF16_WIDTHS",
    "psel_fits",
    "dec_conv1_fits",
    "mma_b_fragments",
    "psel_conv3x3",
    "psel_conv3x3_plain",
    "dec_conv1_weights",
    "dec_conv1_bias_table",
    "dec_conv1_fused",
    "dec_conv1_fused_plain",
    "dec_conv1_preact",
    "psconv_train",
    "psconv_train_plain",
    "psconv_fwd",
    "psconv_dgrad",
    "psconv_dgrad_plain",
    "psconv_wgrad",
]

# Channel widths with a bf16 kernel instantiation (csrc/conv_tile.cuh).
BF16_WIDTHS = (32, 64)


def psel_fits(dtype: torch.dtype, cin: int, cout: int) -> bool:
    """Whether the psel tile has an instantiation for this conv: f32 with
    Cin and Cout multiples of 16, or bf16 with Cout = Cin in
    :data:`BF16_WIDTHS`. The same rule serves psconv_train's forward and
    dgrad (whose adjoint conv swaps Cin and Cout)."""
    if dtype == torch.float32:
        return cin % 16 == 0 and cout % 16 == 0
    return dtype == torch.bfloat16 and cin == cout and cin in BF16_WIDTHS


def dec_conv1_fits(dtype: torch.dtype, cs: int, cp: int, cout: int) -> bool:
    """Whether the dec-conv1 tile has an instantiation: f32 with Cs, Cp,
    Cout multiples of 16, or bf16 with Cout = Cs in :data:`BF16_WIDTHS` and
    Cp = 2·Cs."""
    if dtype == torch.float32:
        return cs % 16 == 0 and cp % 16 == 0 and cout % 16 == 0
    return dtype == torch.bfloat16 and cout == cs and cp == 2 * cs and cs in BF16_WIDTHS


def mma_b_fragments(w2d: torch.Tensor) -> torch.Tensor:
    """(K, N) weights → mma.sync m16n8k16 B-fragment order
    (K/16, N/8, 8, 4, 2, 2): lane ``4g + t`` of a warp finds
    ``B[16s + 8h + 2t + e, 8j + g]`` at ``[s, j, g, t, h, e]``, its four
    values of k-step ``s`` and column tile ``j`` as one 8-byte load."""
    k, n = w2d.shape
    return w2d.reshape(k // 16, 2, 4, 2, n // 8, 8).permute(0, 4, 5, 2, 1, 3).contiguous()


def _kernel_weights(w: torch.Tensor, dev: torch.device, dt: torch.dtype) -> torch.Tensor:
    """(3, 3, K, N) weights as the kernel reads them: HWIO in f32, packed
    B fragments over (9·K, N) in bf16."""
    w = w.to(device=dev, dtype=dt)
    if dt == torch.bfloat16:
        return mma_b_fragments(w.reshape(-1, w.shape[-1]))
    return w.contiguous()


# ---------------------------------------------------------------------------
# K1: phase-select conv (s2d ConvBlock conv2)
# ---------------------------------------------------------------------------


def psel_conv3x3_plain(x_s2d: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``relu(conv3x3_s2d(x, s2d_conv3x3_kernel(k)) + s2d_vector(b))`` in x's
    dtype: the dense s2d form the kernel is held against."""
    y = s2d_ops.conv3x3_s2d(x_s2d, s2d_ops.s2d_conv3x3_kernel(kernel))
    return torch.relu(y + s2d_ops.s2d_vector(bias).to(y.dtype))


def _psel_launch(name: str, x_s2d: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
                 relu: bool) -> torch.Tensor:
    """Launch the psel tile on CUDA tensors after checking what it takes;
    ``bias`` None adds none."""
    dt = x_s2d.dtype
    require(dt in KERNEL_DTYPES, f"{name}: unsupported dtype {dt}")
    check_cuda_input("x_s2d", x_s2d, dt)
    b, hh, ww, zin = x_s2d.shape
    require(tuple(kernel.shape[:2]) == (3, 3) and kernel.dim() == 4, f"kernel must be (3, 3, Cin, Cout), got {tuple(kernel.shape)}")
    cin, cout = kernel.shape[2], kernel.shape[3]
    require(zin == 4 * cin, f"x has {zin} s2d channels, kernel expects 4*{cin}")
    require(cin % 16 == 0 and cout % 16 == 0, f"Cin={cin}, Cout={cout} must be multiples of 16")
    if bias is not None:
        require(tuple(bias.shape) == (cout,), f"bias must be ({cout},), got {tuple(bias.shape)}")
        bias = bias.to(device=x_s2d.device, dtype=torch.float32).contiguous()
    if dt == torch.bfloat16:
        require(cin == cout and cin in BF16_WIDTHS, f"bf16 kernel needs Cout = Cin in {BF16_WIDTHS}, got {cin} -> {cout}")
    w = _kernel_weights(kernel, x_s2d.device, dt)
    y = torch.empty((b, hh, ww, 4 * cout), dtype=dt, device=x_s2d.device)
    rc = library("psel_conv").mgu_psel_conv3x3(
        x_s2d.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(),
        b, hh, ww, cin, cout, int(dt == torch.bfloat16), int(relu), stream_ptr(x_s2d),
    )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    return y


def psel_conv3x3(x_s2d: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """ReLU of a 3×3 'SAME' conv + bias of a phase-major s2d tensor.

    x_s2d: (B, Hh, Ww, 4·Cin); kernel: full-res (3, 3, Cin, Cout) HWIO
    (BN-folded); bias: (Cout,). Returns (B, Hh, Ww, 4·Cout) in x's dtype.
    On CUDA: the shapes :func:`psel_fits` accepts; f32 accumulation.
    """
    if x_s2d.device.type == "cpu":
        return psel_conv3x3_plain(x_s2d, kernel, bias)
    require_no_grad("psel_conv3x3", x_s2d, kernel, bias)
    y = _psel_launch("psel_conv3x3", x_s2d, kernel, bias, relu=True)
    psel_conv3x3.launches += 1
    return y


psel_conv3x3.launches = 0


# ---------------------------------------------------------------------------
# K2: fused decoder conv1
# ---------------------------------------------------------------------------


def _k2b(kernel: torch.Tensor, skip_c: int) -> torch.Tensor:
    up_c = kernel.shape[2] - skip_c
    return s2d_ops.s2d_conv3x3_kernel(kernel, (skip_c, up_c))[:, :, 4 * skip_c :, :]


def dec_conv1_weights(
    kernel: torch.Tensor, skip_c: int, wt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weights for :func:`dec_conv1_fused` from conv1's (3, 3, skip_c + up_c,
    Cout) full-res kernel (BN-folded) and the s2d ConvTranspose matmul ``wt``
    (Cin_prev, 4·up_c): ``(k_skip (3, 3, skip_c, Cout), k_prev (3, 3,
    Cin_prev, 4·Cout))`` with the ConvTranspose contracted into x_prev's
    taps (the ``k2b_x`` of the XLA ``fused_up`` path)."""
    k_prev = torch.einsum("cq,yxqo->yxco", wt.to(kernel.dtype), _k2b(kernel, skip_c))
    return kernel[:, :, :skip_c, :], k_prev


def dec_conv1_bias_table(
    kernel: torch.Tensor, skip_c: int, bias_up: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """(3, 3, 4·Cout) f32 table: conv1's bias plus the upsample-bias field
    for each (row class, col class) in {first, interior, last}²."""
    t = torch.einsum(
        "yxio,i->yxo", _k2b(kernel, skip_c).float(), s2d_ops.s2d_vector(bias_up).float()
    )
    rsel = torch.ones((3, 3), device=t.device)  # rows of the class table a tap reaches
    rsel[0, 0] = rsel[2, 2] = 0.0
    field = torch.einsum("ad,be,deo->abo", rsel, rsel, t)
    return field + s2d_ops.s2d_vector(bias).float()


def bias_table_field(t9: torch.Tensor, hh: int, ww: int) -> torch.Tensor:
    """Expand the class table to the (hh, ww, 4·Cout) f32 field. Row (and
    column) weights are (first, 1 − first − last, last): on a grid one pixel
    high a row is first and last, and (1, −1, 1) gives the both-taps-invalid
    value, as the kernel's epilogue does."""
    def weights(n: int) -> torch.Tensor:
        i = torch.arange(n, device=t9.device)
        f = (i == 0).float()
        l = (i == n - 1).float()
        return torch.stack([f, 1.0 - f - l, l], dim=1)

    return torch.einsum("yd,xe,deo->yxo", weights(hh), weights(ww), t9.float())


def dec_conv1_preact(
    x_skip_s2d: torch.Tensor,
    x_prev: torch.Tensor,
    k_skip: torch.Tensor,
    k_prev: torch.Tensor,
    t9: torch.Tensor,
) -> torch.Tensor:
    """The XLA ``fused_up`` branch before its ReLU: ``conv3x3_s2d(skip, K_a)
    + conv3x3_s2d(x_prev, K_prev) + field`` in the inputs' dtype.
    Differentiable: the training path's decoder conv1."""
    _, hh, ww, _ = x_skip_s2d.shape
    dt = x_skip_s2d.dtype
    return (
        s2d_ops.conv3x3_s2d(x_skip_s2d, s2d_ops.s2d_conv3x3_kernel(k_skip))
        + s2d_ops.conv3x3_s2d(x_prev, k_prev)
        + bias_table_field(t9, hh, ww)[None].to(dt)
    )


def dec_conv1_fused_plain(
    x_skip_s2d: torch.Tensor,
    x_prev: torch.Tensor,
    k_skip: torch.Tensor,
    k_prev: torch.Tensor,
    t9: torch.Tensor,
) -> torch.Tensor:
    """``relu`` of :func:`dec_conv1_preact`: the plain version of
    :func:`dec_conv1_fused`."""
    return torch.relu(dec_conv1_preact(x_skip_s2d, x_prev, k_skip, k_prev, t9))


def dec_conv1_fused(
    x_skip_s2d: torch.Tensor,
    x_prev: torch.Tensor,
    k_skip: torch.Tensor,
    k_prev: torch.Tensor,
    t9: torch.Tensor,
) -> torch.Tensor:
    """relu(conv1([skip ‖ ConvTranspose(x_prev)]) + bias) for the s2d
    decoder block, from :func:`dec_conv1_weights` and
    :func:`dec_conv1_bias_table`.

    x_skip_s2d: (B, Hh, Ww, 4·Cs); x_prev: (B, Hh, Ww, Cp); returns
    (B, Hh, Ww, 4·Cout). On CUDA: f32 with Cs, Cp, Cout multiples of 16, or
    bf16 with Cout = Cs in :data:`BF16_WIDTHS` and Cp = 2·Cs.
    """
    if x_skip_s2d.device.type == "cpu":
        return dec_conv1_fused_plain(x_skip_s2d, x_prev, k_skip, k_prev, t9)
    require_no_grad("dec_conv1_fused", x_skip_s2d, x_prev, k_skip, k_prev, t9)
    dt = x_skip_s2d.dtype
    require(dt in KERNEL_DTYPES, f"dec_conv1_fused: unsupported dtype {dt}")
    check_cuda_input("x_skip_s2d", x_skip_s2d, dt)
    check_cuda_input("x_prev", x_prev, dt)
    b, hh, ww, zs = x_skip_s2d.shape
    cs, cout = k_skip.shape[2], k_skip.shape[3]
    cp = x_prev.shape[3]
    require(tuple(x_prev.shape[:3]) == (b, hh, ww), f"x_prev grid {tuple(x_prev.shape)} != skip grid {tuple(x_skip_s2d.shape)}")
    require(zs == 4 * cs and tuple(k_skip.shape[:2]) == (3, 3), f"k_skip {tuple(k_skip.shape)} does not fit skip {tuple(x_skip_s2d.shape)}")
    require(tuple(k_prev.shape) == (3, 3, cp, 4 * cout), f"k_prev must be (3, 3, {cp}, {4 * cout}), got {tuple(k_prev.shape)}")
    require(tuple(t9.shape) == (3, 3, 4 * cout), f"t9 must be (3, 3, {4 * cout}), got {tuple(t9.shape)}")
    require(cs % 16 == 0 and cp % 16 == 0 and cout % 16 == 0, f"Cs={cs}, Cp={cp}, Cout={cout} must be multiples of 16")
    if dt == torch.bfloat16:
        require(cout == cs and cp == 2 * cs and cs in BF16_WIDTHS,
                f"bf16 kernel needs Cout = Cs in {BF16_WIDTHS} and Cp = 2·Cs, got Cs={cs}, Cp={cp}, Cout={cout}")
    dev = x_skip_s2d.device
    ws = _kernel_weights(k_skip, dev, dt)
    wp = _kernel_weights(k_prev, dev, dt)
    tf = t9.to(device=dev, dtype=torch.float32).contiguous()
    y = torch.empty((b, hh, ww, 4 * cout), dtype=dt, device=dev)
    rc = library("dec_conv1").mgu_dec_conv1(
        x_skip_s2d.data_ptr(), x_prev.data_ptr(), ws.data_ptr(), wp.data_ptr(),
        tf.data_ptr(), y.data_ptr(), b, hh, ww, cs, cp, cout,
        int(dt == torch.bfloat16), stream_ptr(x_skip_s2d),
    )
    if rc != 0:
        raise RuntimeError(f"dec_conv1_fused launch failed: cudaError {rc}")
    dec_conv1_fused.launches += 1
    return y


dec_conv1_fused.launches = 0


# ---------------------------------------------------------------------------
# K4: the training conv (raw s2d conv2 with its backward)
# ---------------------------------------------------------------------------


def _adjoint(kernel: torch.Tensor) -> torch.Tensor:
    """The 3×3 'SAME' conv's adjoint kernel: spatially flipped, in/out
    transposed, (3, 3, Cin, Cout) → (3, 3, Cout, Cin)."""
    return kernel.flip(0, 1).transpose(2, 3)


def psconv_train_plain(x_s2d: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``conv3x3_s2d(x, s2d_conv3x3_kernel(kernel))`` in x's dtype, no bias,
    no ReLU: the dense s2d form. Under ordinary autograd it is the plain
    version of :func:`psconv_train`, forward and backward."""
    return s2d_ops.conv3x3_s2d(x_s2d, s2d_ops.s2d_conv3x3_kernel(kernel))


def psconv_dgrad_plain(g_s2d: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """dx of the raw conv for cotangent ``g_s2d``: the same conv with the
    adjoint kernel, in g's dtype."""
    return psconv_train_plain(g_s2d, _adjoint(kernel))


def psconv_fwd(x_s2d: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """K4 forward: the raw 3×3 'SAME' conv of a phase-major s2d tensor,
    (B, Hh, Ww, 4·Cin) → (B, Hh, Ww, 4·Cout) in x's dtype; kernel full-res
    (3, 3, Cin, Cout). On CUDA: the psel tile without ReLU or bias, for
    the shapes :func:`psel_fits` accepts."""
    if x_s2d.device.type == "cpu":
        return psconv_train_plain(x_s2d, kernel)
    y = _psel_launch("psconv_fwd", x_s2d, kernel, None, relu=False)
    psconv_fwd.launches += 1
    return y


psconv_fwd.launches = 0


def psconv_dgrad(g_s2d: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """K4 dgrad: dx = the raw conv of the cotangent (B, Hh, Ww, 4·Cout) with
    the adjoint kernel, (B, Hh, Ww, 4·Cin) in g's dtype. On CUDA: the psel
    tile without ReLU (the sites are square, so the bf16 instantiations
    fit)."""
    if g_s2d.device.type == "cpu":
        return psconv_dgrad_plain(g_s2d, kernel)
    y = _psel_launch("psconv_dgrad", g_s2d, _adjoint(kernel), None, relu=False)
    psconv_dgrad.launches += 1
    return y


psconv_dgrad.launches = 0


def psconv_wgrad(x_s2d: torch.Tensor, g_s2d: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The full-res kernel gradient of the raw conv, (3, 3, Cin, Cout) in at
    least f32, summed in f32 from the exact products of bf16 inputs, as the
    JAX package's ``preferred_element_type=f32`` does. PyTorch, as the JAX
    package computes it outside Pallas: the dense s2d weight gradient (one
    convolution backward on the s2d tensors as they lie, no relayout) on
    the inputs widened to f32, so that its output is not rounded to bf16
    (a bf16 value is exact in TF32, so cuDNN's TF32 path loses nothing),
    pulled back through ``s2d_conv3x3_kernel``'s tap map by its adjoint."""
    cin, cout = kernel.shape[2], kernel.shape[3]
    dt = torch.promote_types(kernel.dtype, torch.float32)
    dw = torch.nn.grad.conv2d_weight(
        x_s2d.to(dt).permute(0, 3, 1, 2), (4 * cout, 4 * cin, 3, 3), g_s2d.to(dt).permute(0, 3, 1, 2), padding=1
    )
    return s2d_ops.s2d_conv3x3_kernel_adjoint(dw.permute(2, 3, 1, 0))


class _PsconvTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_s2d, kernel):
        ctx.save_for_backward(x_s2d, kernel)
        return psconv_fwd(x_s2d, kernel)

    @staticmethod
    def backward(ctx, g):
        x_s2d, kernel = ctx.saved_tensors
        g = g.contiguous()  # autograd may hand the cotangent over strided or expanded
        dx = psconv_dgrad(g, kernel).to(x_s2d.dtype) if ctx.needs_input_grad[0] else None
        dk = psconv_wgrad(x_s2d, g, kernel).to(kernel.dtype) if ctx.needs_input_grad[1] else None
        return dx, dk


def psconv_train(x_s2d: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Differentiable raw 3×3 'SAME' s2d conv (no bias, no ReLU): forward
    through :func:`psconv_fwd`, dx through :func:`psconv_dgrad`, the kernel
    gradient through :func:`psconv_wgrad`. On the CPU the two wrappers run
    their plain versions, so the same backward is testable there."""
    return _PsconvTrain.apply(x_s2d, kernel)
