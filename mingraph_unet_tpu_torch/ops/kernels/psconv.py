"""The s2d U-Net convs as hand-written CUDA kernels, with their plain
PyTorch versions, and the one place that picks between them for each of
the U-Net's s2d conv sites. Counterpart of
``mingraph_unet_tpu/ops/pallas/psconv.py``.

- :func:`psel_conv3x3` replaces ``conv3x3_s2d_psel``: ReLU of a 3×3 'SAME'
  conv + bias of a phase-major s2d tensor (the s2d ConvBlock's conv2).
- :func:`dec_conv1_fused` replaces ``dec_conv1_fused``: the s2d decoder's
  conv1, ``relu(conv3x3([skip ‖ ConvTranspose2x2(x_prev)]) + bias)``, with
  the upsample folded into x_prev's tap weights and the border-attenuated
  upsample-bias field applied as a (3, 3) class table.

Both kernels are implicit GEMMs over a staged s2d input halo that read the
layout as full-resolution pixels, so they do the conv's useful FLOPs (not
the TPU form's 16/9× or the dense s2d form's 4×), on the tensor cores.
Both are instantiated for the U-Net's two s2d widths, in bf16 and in f32
(:data:`WIDTHS`): Cout = Cin (psel), Cout = Cs and Cp = 2·Cs (dec-conv1),
with Cin, Cs in {32, 64}. The f32 instantiations (the configured
precision's K1, K2, K4 and K9) run the bf16 design with a bf16 hi/lo
split: three bf16 products a term (hi·hi + hi·lo + lo·hi) into f32. psel's
from two B images it lays out itself (``split`` in
:func:`psel_b_image_index`); dec-conv1's a block computes all four output
phases of a share of the output columns, with hi and lo images of W_skip
and the live x_prev blocks laid out from the raw f32 weights as they lie
(:func:`dec_conv1_image_index`). The bf16 kernels are Hopper designs:
persistent warp-specialised blocks, weights resident in shared memory in
wgmma's B layout (:func:`wgmma_b_layout`), halos staged by TMA through
rings of stages. psel takes the conv's raw HWIO kernel and lays that image
out itself (:func:`psel_b_image_index`), so a launch is its one device
operation. psel (``csrc/psel_conv.cu``) runs ``wgmma`` over all four
output phases at once; dec-conv1 (``csrc/dec_conv1.cu``) one output phase
per ``wgmma``, so its x_prev term multiplies only the phase's four live
taps of the folded weights (:func:`dec_conv1_live_weights`), and at level
1 a cluster of four blocks, one a phase, shares each halo by TMA
multicast. Memory bounds psel on the H100 at level 0 and puts it on the
ridge at level 1; dec-conv1 is bound by memory at level 0 and by
operations at level 1.

- :func:`psel_conv3x3_halo` (K9) replaces
  ``mingraph_unet_tpu/parallel/halo.py::sharded_psconv``'s kernel call: K1
  on one H-shard of the s2d grid, given the rows just above and below the
  shard (None at a global border). :func:`dec_conv1_halo` is K2 on a shard
  in the same way, with the bias field's border rows taken from the global
  row. Both are the same tile as the unsharded launch with the two rows
  staged in place of the zero padding, so stitched shards equal the
  unsharded kernel bit for bit.
- :func:`psconv_train` replaces ``psconv_train``: the raw 3×3 s2d conv
  (no bias, no ReLU) of the training path as a ``torch.autograd.Function``.
  Its forward (:func:`psconv_fwd`) and its dgrad (:func:`psconv_dgrad`, the
  same conv on the cotangent with the flipped, in/out-transposed kernel) are
  the psel tile with the ReLU epilogue compiled out; its kernel gradient
  (:func:`psconv_wgrad`) is PyTorch, as the JAX package computes it in XLA.
- :func:`psconv_train_halo` is K4 on one H-shard (spatial-parallel
  training), its own ``torch.autograd.Function``: the forward
  (:func:`psconv_fwd_halo`) and the dgrad (:func:`psconv_dgrad_halo`) are
  K9's entry without bias or ReLU, given the x rows (forward) and the
  cotangent's rows (dgrad) from the neighbouring shards, so stitched shards
  equal :func:`psconv_fwd` and :func:`psconv_dgrad` bit for bit; the kernel
  gradient is :func:`psconv_wgrad` over the shard extended by its x rows.

Each wrapper dispatches on the device of its input: a CPU tensor runs the
plain version, a CUDA tensor launches the kernel (or raises, also at a
width without an instantiation). ``launches`` on each wrapper counts kernel
launches. psel, dec-conv1 and the pool have no backward: on the card they
refuse inputs that require a gradient while autograd records.

Who decides. The U-Net (``models/unet.py``, ``parallel/spatial.py``,
``parallel/halo.py``) calls one op a site: :func:`conv2_s2d`,
:func:`conv2_s2d_halo`, :func:`conv2_s2d_train`,
:func:`conv2_s2d_train_shard`, :func:`dec_conv1` and
:func:`dec_conv1_shard`. Each runs its kernel wrapper for a CUDA tensor at
widths the tile is instantiated for, and its plain version otherwise,
without passing through the wrapper; the rule is the tile's
(:func:`_psel_fits`, :func:`_dec_conv1_fits`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from mingraph_unet_tpu_torch.ops import s2d as s2d_ops
from mingraph_unet_tpu_torch.ops.conv import conv2d_nhwc
from mingraph_unet_tpu_torch.ops.kernels.build import (
    KERNEL_DTYPES,
    check_cuda_input,
    cuda_input_ok,
    library,
    require,
    require_no_grad,
    stream_ptr,
)
from mingraph_unet_tpu_torch.utils.profiling import span

__all__ = [
    "WIDTHS",
    "conv2_s2d",
    "conv2_s2d_halo",
    "conv2_s2d_train",
    "conv2_s2d_train_shard",
    "dec_conv1",
    "dec_conv1_shard",
    "wgmma_b_layout",
    "psel_b_image_index",
    "psel_conv3x3",
    "psel_conv3x3_plain",
    "dec_conv1_weights",
    "dec_conv1_live_weights",
    "dec_conv1_image_index",
    "dec_conv1_bias_table",
    "dec_conv1_fused",
    "dec_conv1_fused_plain",
    "dec_conv1_preact",
    "dec_conv1_halo",
    "dec_conv1_halo_plain",
    "dec_conv1_halo_preact",
    "psel_conv3x3_halo",
    "psel_conv3x3_halo_plain",
    "extend_rows",
    "psconv_train",
    "psconv_train_plain",
    "psconv_fwd",
    "psconv_dgrad",
    "psconv_dgrad_plain",
    "psconv_wgrad",
    "psconv_train_halo",
    "psconv_halo_plain",
    "psconv_fwd_halo",
    "psconv_dgrad_halo",
]

# Channel widths with a kernel instantiation, bf16 and f32 (csrc/psel_conv.cu, csrc/dec_conv1.cu).
WIDTHS = (32, 64)


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def _psel_fits(dtype: torch.dtype, cin: int, cout: int) -> bool:
    """Whether the psel tile has an instantiation for this conv: bf16 or
    f32, Cout = Cin in :data:`WIDTHS`. The same rule serves psconv_train's
    forward and dgrad (whose adjoint conv swaps Cin and Cout) and the
    sharded entries."""
    return dtype in KERNEL_DTYPES and cin == cout and cin in WIDTHS


def _dec_conv1_fits(dtype: torch.dtype, cs: int, cp: int, cout: int) -> bool:
    """Whether the dec-conv1 tile has an instantiation: bf16 or f32, Cout =
    Cs in :data:`WIDTHS` and Cp = 2·Cs."""
    return dtype in KERNEL_DTYPES and cout == cs and cp == 2 * cs and cs in WIDTHS


def _psel_kernel(x_s2d: torch.Tensor, kernel: torch.Tensor) -> bool:
    """Whether the psel tile runs the conv of ``x_s2d`` with ``kernel``
    (3, 3, Cin, Cout): a CUDA tensor at widths :func:`_psel_fits` takes."""
    return _on_card(x_s2d) and _psel_fits(x_s2d.dtype, kernel.shape[2], kernel.shape[3])


def _dec_conv1_kernel(x_skip_s2d: torch.Tensor, x_prev: torch.Tensor, k_skip: torch.Tensor) -> bool:
    """Whether the dec-conv1 tile runs this decoder conv1: a CUDA tensor at
    widths :func:`_dec_conv1_fits` takes."""
    return _on_card(x_skip_s2d) and _dec_conv1_fits(x_skip_s2d.dtype, x_skip_s2d.shape[-1] // 4, x_prev.shape[-1],
                                                    k_skip.shape[-1])


def wgmma_b_layout(w2d: torch.Tensor) -> torch.Tensor:
    """(K, N) weights → wgmma's K-major B layout without swizzle
    (K/16, N/8, 2, 8, 8): ``B[16s + 8h + kk, 8j + r]`` at ``[s, j, h, r, kk]``.
    Each 16-row slab ``s`` is N/8 × 2 core matrices of 8 columns × 8 k, one
    contiguous 128-byte line each (``csrc/hopper.cuh``)."""
    k, n = w2d.shape
    return w2d.reshape(k // 16, 2, 8, n // 8, 8).permute(0, 3, 1, 4, 2).contiguous()


# The split kernel's channel of each row of a 16-row slab: the lanes' A
# fragments take channels 4t … 4t + 3 as fragment columns 2t, 2t + 1, 2t + 8,
# 2t + 9, so slab row 8h + e holds channel 4·(e // 2) + 2h + e % 2.
SPLIT_SLAB_ROWS = np.array([4 * (e // 2) + 2 * h + e % 2 for h in range(2) for e in range(8)])


def psel_b_image_index(c: int, adjoint: bool = False, split: bool = False) -> np.ndarray:
    """The map the psel kernel's prologue lays its weights out by
    (``csrc/psel_conv.cu::lay_tap``): element i of the B image it writes
    to shared memory (9·C·C bf16, in the order of :func:`wgmma_b_layout`'s
    output flattened) is element ``index[i]`` of the raw HWIO (3, 3, C, C)
    kernel flattened; with ``adjoint``, of the kernel whose adjoint the
    image is. Chunk q of the image is B's rows 8·k8 … 8·k8 + 7 of column
    n, 16 bytes, from 8 weights C apart (direct, q = (k8, n)) or
    consecutive (adjoint, q = (tap, n, i // 8)). With ``split`` the map of
    the f32 kernel's hi and lo images (``lay_tap_split``): each 16-row slab
    of B holds its 16 channels in the order :data:`SPLIT_SLAB_ROWS`."""
    rows = np.arange(9 * c)
    if split:
        rows = rows // 16 * 16 + SPLIT_SLAB_ROWS[rows % 16]
    q = np.arange(9 * c * c // 8)
    if adjoint:  # B[tap·C + i][n] = W[8 − tap][n][i]
        tap, rem = q // (c * c // 8), q % (c * c // 8)
        n, k8 = rem // (c // 8), tap * (c // 8) + rem % (c // 8)
    else:  # B[r][n] = W as (9C, C)[r][n]
        k8, n = q // c, q % c
    e = np.arange(8)
    r = rows[8 * k8[:, None] + e]  # the channel row of the raw kernel each chunk element holds
    if adjoint:
        tap = r // c
        at = (8 - tap) * c * c + n[:, None] * c + r % c
    else:
        at = r * c + n[:, None]
    pos = (k8 >> 1) * 16 * c + ((n >> 3) * 2 + (k8 & 1)) * 64 + (n & 7) * 8  # the chunk's first element
    index = np.empty(9 * c * c, dtype=np.int64)
    index[(pos[:, None] + e).ravel()] = at.ravel()
    return index


def _kernel_weights(w: torch.Tensor, dev: torch.device, dt: torch.dtype) -> torch.Tensor:
    """(..., K, N) weights as K2's bf16 kernel reads them (f32: contiguous):
    :func:`wgmma_b_layout` over (rows, N) in bf16."""
    w = w.to(device=dev, dtype=dt)
    if dt == torch.bfloat16:
        return wgmma_b_layout(w.reshape(-1, w.shape[-1]))
    return w.contiguous()


# ---------------------------------------------------------------------------
# K1: phase-select conv (s2d ConvBlock conv2)
# ---------------------------------------------------------------------------


def psel_conv3x3_plain(x_s2d: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``relu(conv3x3_s2d(x, s2d_conv3x3_kernel(k)) + s2d_vector(b))`` in x's
    dtype: the dense s2d form the kernel is held against."""
    y = s2d_ops.conv3x3_s2d(x_s2d, s2d_ops.s2d_conv3x3_kernel(kernel))
    return torch.relu(y + s2d_ops.s2d_vector(bias).to(y.dtype))


def _rows_ok(row: Optional[torch.Tensor], x: torch.Tensor) -> bool:
    if row is None:
        return True
    b, _, ww, z = x.shape
    return cuda_input_ok(row, x.dtype) and row.shape == (b, 1, ww, z) and row.get_device() == x.get_device()


def _check_rows(name: str, row: Optional[torch.Tensor], x: torch.Tensor) -> None:
    """A halo row of ``x`` as the sharded kernels take it: None, or
    (B, 1, Ww, channels) of x's dtype on x's device, contiguous."""
    if _rows_ok(row, x):
        return
    check_cuda_input(name, row, x.dtype)
    want = (x.shape[0], 1, x.shape[2], x.shape[3])
    require(tuple(row.shape) == want, f"{name} must be {want}, got {tuple(row.shape)}")
    require(row.device == x.device, f"{name} is on {row.device}, x on {x.device}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


_PSEL_WEIGHT_DTYPES = (torch.float32, torch.bfloat16)
_NO_ROWS = (None, None)


def _psel_check(name: str, x_s2d: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
                top: Optional[torch.Tensor], bottom: Optional[torch.Tensor], adjoint: bool) -> None:
    """Raise ``ValueError`` unless the psel tile takes this launch: x a CUDA
    (B, Hh, Ww, 4·Cin) tensor of a kernel dtype, the kernel (3, 3, ·, ·)
    (the conv's (Cin, Cout) swapped when ``adjoint``), widths
    :func:`_psel_fits` takes, bias (Cout,) or None, the rows as
    :func:`_check_rows` takes them. One test when all is well; the
    messages are built only for a refusal."""
    ks = kernel.shape
    dt = x_s2d.dtype
    if len(ks) == 4 and dt in KERNEL_DTYPES and cuda_input_ok(x_s2d, dt):
        cin, cout = (ks[3], ks[2]) if adjoint else (ks[2], ks[3])
        if (ks[0] == 3 and ks[1] == 3 and x_s2d.shape[3] == 4 * cin and _psel_fits(dt, cin, cout)
                and (bias is None or bias.shape == (cout,)) and _rows_ok(top, x_s2d) and _rows_ok(bottom, x_s2d)):
            return
    require(dt in KERNEL_DTYPES, f"{name}: unsupported dtype {dt}")
    check_cuda_input("x_s2d", x_s2d, dt)
    require(tuple(ks[:2]) == (3, 3) and kernel.dim() == 4, f"kernel must be (3, 3, Cin, Cout), got {tuple(ks)}")
    cin, cout = (ks[3], ks[2]) if adjoint else (ks[2], ks[3])
    zin = x_s2d.shape[3]
    require(zin == 4 * cin, f"x has {zin} s2d channels, kernel expects 4*{cin}")
    require(_psel_fits(dt, cin, cout), f"{name}: the kernel needs Cout = Cin in {WIDTHS}, got {cin} -> {cout}")
    if bias is not None:
        require(tuple(bias.shape) == (cout,), f"bias must be ({cout},), got {tuple(bias.shape)}")
    _check_rows("top", top, x_s2d)
    _check_rows("bottom", bottom, x_s2d)
    raise ValueError(f"{name}: refused")  # not reached: one of the checks above names the fault


def _psel_weights(kernel: torch.Tensor, x_s2d: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(weights as the psel kernel reads them, whether they are f32): the
    raw HWIO kernel as it lies, on x's device, contiguous and 16-byte
    aligned (a copy otherwise), f32 or (for bf16 x) bf16, another dtype
    widened to f32. The kernel lays out its B images itself, the adjoint's
    for the dgrad (bf16 x: rounded to bf16; f32 x: split into hi and lo),
    so a parameter passed as it lies costs no device operation."""
    keep = _PSEL_WEIGHT_DTYPES if x_s2d.dtype == torch.bfloat16 else (torch.float32,)
    w = kernel if kernel.dtype in keep else kernel.float()
    if w.get_device() != x_s2d.get_device():
        w = w.to(x_s2d.device)
    if not w.is_contiguous() or w.data_ptr() % 16:  # the kernel's bulk copies read it from 16-byte bounds
        w = w.clone(memory_format=torch.contiguous_format)
    return w, w.dtype == torch.float32


def _psel_launch(name: str, x_s2d: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
                 relu: bool, rows: Optional[Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]] = None,
                 adjoint: bool = False) -> torch.Tensor:
    """Launch the psel tile on CUDA tensors after checking what it takes;
    ``bias`` None adds none; ``adjoint`` convolves with the kernel's adjoint
    (the dgrad). ``rows`` = (top, bottom) launches the sharded entry (K9)
    with those halo rows (None at a global border). The C call encodes the
    tensor maps and launches; the device's attributes are asked once."""
    top, bottom = _NO_ROWS if rows is None else rows
    _psel_check(name, x_s2d, kernel, bias, top, bottom, adjoint)
    b, hh, ww, _ = x_s2d.shape
    ks = kernel.shape
    cin, cout = (ks[3], ks[2]) if adjoint else (ks[2], ks[3])
    with span("weights"):
        w, w_f32 = _psel_weights(kernel, x_s2d)
        if bias is not None:
            bias = bias.to(device=x_s2d.device, dtype=torch.float32).contiguous()
    y = torch.empty_like(x_s2d)
    flags = (int(x_s2d.dtype is torch.bfloat16), int(relu), int(w_f32), int(adjoint))
    lib = library("psel_conv")
    if rows is None:
        rc = lib.mgu_psel_conv3x3(x_s2d.data_ptr(), w.data_ptr(), _ptr(bias), y.data_ptr(), b, hh, ww, cin, cout,
                                  *flags, stream_ptr(x_s2d))
    else:
        rc = lib.mgu_psel_conv3x3_halo(x_s2d.data_ptr(), _ptr(top), _ptr(bottom), w.data_ptr(), _ptr(bias),
                                       y.data_ptr(), b, hh, ww, cin, cout, *flags, stream_ptr(x_s2d))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    return y


def psel_conv3x3(x_s2d: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """ReLU of a 3×3 'SAME' conv + bias of a phase-major s2d tensor.

    x_s2d: (B, Hh, Ww, 4·Cin); kernel: full-res (3, 3, Cin, Cout) HWIO
    (BN-folded); bias: (Cout,). Returns (B, Hh, Ww, 4·Cout) in x's dtype.
    On CUDA: the widths :func:`_psel_fits` takes; f32 accumulation.
    """
    if x_s2d.device.type == "cpu":
        return psel_conv3x3_plain(x_s2d, kernel, bias)
    with span("kernel.psel_conv3x3", (x_s2d, kernel, bias)):
        require_no_grad("psel_conv3x3", x_s2d, kernel, bias)
        y = _psel_launch("psel_conv3x3", x_s2d, kernel, bias, relu=True)
    psel_conv3x3.launches += 1
    return y


psel_conv3x3.launches = 0


def extend_rows(x: torch.Tensor, top: Optional[torch.Tensor], bottom: Optional[torch.Tensor],
                halo: int = 1) -> torch.Tensor:
    """``x`` (B, H, ...) with ``top`` above and ``bottom`` below it along H,
    ``halo`` zero rows in place of each None (a global border)."""
    zero = lambda: x.new_zeros((x.shape[0], halo) + tuple(x.shape[2:]))  # noqa: E731
    return torch.cat([zero() if top is None else top, x, zero() if bottom is None else bottom], dim=1)


def psel_conv3x3_halo_plain(x_s2d: torch.Tensor, top: Optional[torch.Tensor], bottom: Optional[torch.Tensor],
                            kernel: torch.Tensor, bias: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """The JAX form of K9: the halo rows concatenated to the shard, the
    dense s2d conv + bias (ReLU when ``relu``) over the extended block, and
    its first and last rows dropped."""
    y = s2d_ops.conv3x3_s2d(extend_rows(x_s2d, top, bottom), s2d_ops.s2d_conv3x3_kernel(kernel))
    y = y[:, 1:-1] + s2d_ops.s2d_vector(bias).to(y.dtype)
    return torch.relu(y) if relu else y


def psel_conv3x3_halo(x_s2d: torch.Tensor, top: Optional[torch.Tensor], bottom: Optional[torch.Tensor],
                      kernel: torch.Tensor, bias: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """K9: the psel conv (ReLU when ``relu``) of one H-shard of an s2d
    tensor. x_s2d: the shard (B, Hh_local, Ww, 4·Cin); ``top`` / ``bottom``:
    the s2d row just above / below it (B, 1, Ww, 4·Cin) from the
    neighbouring shards, None at the global top / bottom. Returns the
    shard's (B, Hh_local, Ww, 4·Cout) rows of the unsharded conv. On CUDA:
    the widths :func:`_psel_fits` takes, bit-equal to :func:`psel_conv3x3`
    on the whole tensor once stitched."""
    if x_s2d.device.type == "cpu":
        return psel_conv3x3_halo_plain(x_s2d, top, bottom, kernel, bias, relu)
    with span("kernel.psel_conv3x3_halo", (x_s2d, top, bottom, kernel, bias)):
        require_no_grad("psel_conv3x3_halo", *(t for t in (x_s2d, top, bottom, kernel, bias) if t is not None))
        y = _psel_launch("psel_conv3x3_halo", x_s2d, kernel, bias, relu=relu, rows=(top, bottom))
    psel_conv3x3_halo.launches += 1
    return y


psel_conv3x3_halo.launches = 0


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


def dec_conv1_live_weights(k_prev: torch.Tensor) -> torch.Tensor:
    """The non-zero blocks of :func:`dec_conv1_weights`' ``k_prev`` (3, 3,
    Cp, 4·Cout): (4 phases, 4 taps, Cp, Cout), where phase p = 2·py + px,
    tap u = 2·a + b is ``k_prev[py + a, px + b, :, p·Cout:(p + 1)·Cout]``.
    Every other (tap, phase) block of k_prev is zero (the ConvTranspose
    feeds phase p's 3 × 3 window from 2 × 2 x_prev pixels only), so the
    x_prev term of output phase p is a 2 × 2 conv on x_prev's grid with
    these weights at offset (py − 1, px − 1): 8·C² multiply-adds a
    full-resolution pixel instead of the dense form's 18·C². Views and one
    reshape, so the wrapper's per-call packing stays a few host ops."""
    cp, cout = k_prev.shape[2], k_prev.shape[3] // 4
    # Every 2 x 2 window of taps: (oy, ox, Cp, phase, Cout, a, b).
    win = k_prev.reshape(3, 3, cp, 4, cout).unfold(0, 2, 1).unfold(1, 2, 1)
    # Phase p takes the window at offset (p // 2, p % 2): the diagonal of
    # (phase, window offset).
    win = win.permute(3, 0, 1, 5, 6, 2, 4).reshape(4, 4, 4, cp, cout)
    return torch.diagonal(win, dim1=0, dim2=1).permute(3, 0, 1, 2)


def dec_conv1_bias_table(
    kernel: torch.Tensor, skip_c: int, bias_up: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """(3, 3, 4·Cout) f32 table (f64 for an f64 kernel): conv1's bias plus
    the upsample-bias field for each (row class, col class) in {first,
    interior, last}²."""
    acc = torch.promote_types(kernel.dtype, torch.float32)
    t = torch.einsum(
        "yxio,i->yxo", _k2b(kernel, skip_c).to(acc), s2d_ops.s2d_vector(bias_up).to(acc)
    )
    rsel = torch.ones((3, 3), dtype=acc, device=t.device)  # rows of the class table a tap reaches
    rsel[0, 0] = rsel[2, 2] = 0.0
    field = torch.einsum("ad,be,deo->abo", rsel, rsel, t)
    return field + s2d_ops.s2d_vector(bias).to(acc)


def bias_table_field(t9: torch.Tensor, hh: int, ww: int, row0: int = 0, hh_global: Optional[int] = None
                     ) -> torch.Tensor:
    """Expand the class table to the (hh, ww, 4·Cout) f32 field (f64 for an
    f64 table). Row (and column) weights are (first, 1 − first − last,
    last): on a grid one pixel high a row is first and last, and (1, −1, 1)
    gives the both-taps-invalid value, as the kernel's epilogue does. On an
    H-shard, local row i is global row ``row0 + i`` of ``hh_global``
    (default: the whole grid)."""
    acc = torch.promote_types(t9.dtype, torch.float32)

    def weights(n: int, start: int, total: int) -> torch.Tensor:
        i = torch.arange(start, start + n, device=t9.device)
        f = (i == 0).to(acc)
        l = (i == total - 1).to(acc)
        return torch.stack([f, 1.0 - f - l, l], dim=1)

    rows = weights(hh, row0, hh if hh_global is None else hh_global)
    return torch.einsum("yd,xe,deo->yxo", rows, weights(ww, 0, ww), t9.to(acc))


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


def _f32_weights(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """An f32 weight of K2 on ``dev``: as it lies where its last dimension
    is contiguous (the split kernel reads any strides of the others, so the
    model's sliced k_skip and its einsum's k_prev cost no copy), else
    contiguous."""
    t = t.to(device=dev, dtype=torch.float32)
    return t if t.stride(-1) == 1 else t.contiguous()


def dec_conv1_image_index(c: int, rank: int) -> Tuple[np.ndarray, np.ndarray]:
    """The map by which block ``rank`` of the split kernel's cluster lays
    out its weights (``csrc/dec_conv1.cu::lay_split_weights``): (W_skip
    image, live image), element i of each (bf16, in the order of
    :func:`wgmma_b_layout`'s output flattened; the hi and lo images share
    it) from element ``index[i]`` of the raw k_skip (3, 3, C, C), of the
    dense k_prev (3, 3, 2C, 4C), flattened. The block holds output columns
    rank·NB … rank·NB + NB − 1 of every phase, NB = 1024 // C (a cluster of
    C // NB blocks): W_skip's rows tap·C + ci, then the 16 live (phase p,
    tap u) blocks' rows, each ``k_prev[py + a, px + b, :, p·C + cols]``
    (u = 2a + b, as :func:`dec_conv1_live_weights`), with every 16-row slab
    in :data:`SPLIT_SLAB_ROWS` order."""
    nb, cp = 1024 // c, 2 * c
    cols = rank * nb + np.arange(nb)

    def image(rows_src: np.ndarray) -> np.ndarray:  # rows_src[k, n]: flat source index of B row k, column n
        k = rows_src.shape[0]
        order = np.arange(k) // 16 * 16 + SPLIT_SLAB_ROWS[np.arange(k) % 16]
        return wgmma_b_layout(torch.from_numpy(rows_src[order])).flatten().numpy()

    tap, ci = np.divmod(np.arange(9 * c), c)
    skip = image((tap * c + ci)[:, None] * c + cols[None, :])
    p, rest = np.divmod(np.arange(16 * cp), 4 * cp)
    u, ci = np.divmod(rest, cp)
    ky, kx = p // 2 + u // 2, p % 2 + u % 2
    live = image(((ky * 3 + kx) * cp + ci)[:, None] * (4 * c) + (p * c)[:, None] + cols[None, :])
    return skip, live


def _dec_conv1_launch(name: str, x_skip_s2d, x_prev, k_skip, k_prev, t9, halo=None) -> torch.Tensor:
    """Launch the dec-conv1 tile on CUDA tensors after checking what it
    takes. ``halo`` = (skip_top, skip_bottom, prev_top, prev_bottom, row0,
    hh_global) launches the sharded entry."""
    require_no_grad(name, x_skip_s2d, x_prev, k_skip, k_prev, t9)
    dt = x_skip_s2d.dtype
    require(dt in KERNEL_DTYPES, f"{name}: unsupported dtype {dt}")
    check_cuda_input("x_skip_s2d", x_skip_s2d, dt)
    check_cuda_input("x_prev", x_prev, dt)
    b, hh, ww, zs = x_skip_s2d.shape
    cs, cout = k_skip.shape[2], k_skip.shape[3]
    cp = x_prev.shape[3]
    require(tuple(x_prev.shape[:3]) == (b, hh, ww), f"x_prev grid {tuple(x_prev.shape)} != skip grid {tuple(x_skip_s2d.shape)}")
    require(zs == 4 * cs and tuple(k_skip.shape[:2]) == (3, 3), f"k_skip {tuple(k_skip.shape)} does not fit skip {tuple(x_skip_s2d.shape)}")
    require(tuple(k_prev.shape) == (3, 3, cp, 4 * cout), f"k_prev must be (3, 3, {cp}, {4 * cout}), got {tuple(k_prev.shape)}")
    require(tuple(t9.shape) == (3, 3, 4 * cout), f"t9 must be (3, 3, {4 * cout}), got {tuple(t9.shape)}")
    require(_dec_conv1_fits(dt, cs, cp, cout),
            f"{name}: the kernel needs Cout = Cs in {WIDTHS} and Cp = 2·Cs, got Cs={cs}, Cp={cp}, Cout={cout}")
    dev = x_skip_s2d.device
    with span("weights"):
        if dt == torch.bfloat16:
            ws = _kernel_weights(k_skip, dev, dt)
            wp = _kernel_weights(dec_conv1_live_weights(k_prev), dev, dt)
            tf = t9.to(device=dev, dtype=torch.float32).contiguous()
        else:  # raw f32: the split kernel reads them as they lie
            ws, wp, tf = (_f32_weights(t, dev) for t in (k_skip, k_prev, t9))
    y = torch.empty((b, hh, ww, 4 * cout), dtype=dt, device=dev)
    lib = library("dec_conv1")
    tail = (*ws.stride()[:3], *wp.stride()[:3], *tf.stride()[:2], int(dt == torch.bfloat16), stream_ptr(x_skip_s2d))
    if halo is None:
        rc = lib.mgu_dec_conv1(x_skip_s2d.data_ptr(), x_prev.data_ptr(), ws.data_ptr(), wp.data_ptr(),
                               tf.data_ptr(), y.data_ptr(), b, hh, ww, cs, cp, cout, *tail)
    else:
        skip_top, skip_bottom, prev_top, prev_bottom, row0, hh_global = halo
        for row_name, row, of in (("skip_top", skip_top, x_skip_s2d), ("skip_bottom", skip_bottom, x_skip_s2d),
                                  ("prev_top", prev_top, x_prev), ("prev_bottom", prev_bottom, x_prev)):
            _check_rows(row_name, row, of)
        require(0 <= row0 and row0 + hh <= hh_global, f"rows {row0}..{row0 + hh} outside the grid's {hh_global}")
        rc = lib.mgu_dec_conv1_halo(
            x_skip_s2d.data_ptr(), _ptr(skip_top), _ptr(skip_bottom), x_prev.data_ptr(), _ptr(prev_top),
            _ptr(prev_bottom), ws.data_ptr(), wp.data_ptr(), tf.data_ptr(), y.data_ptr(), b, hh, ww, cs, cp, cout,
            row0, hh_global, *tail)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    return y


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
    (B, Hh, Ww, 4·Cout). On CUDA: the widths :func:`_dec_conv1_fits`
    takes.
    """
    if x_skip_s2d.device.type == "cpu":
        return dec_conv1_fused_plain(x_skip_s2d, x_prev, k_skip, k_prev, t9)
    with span("kernel.dec_conv1_fused", (x_skip_s2d, x_prev, k_skip, k_prev, t9)):
        y = _dec_conv1_launch("dec_conv1_fused", x_skip_s2d, x_prev, k_skip, k_prev, t9)
    dec_conv1_fused.launches += 1
    return y


dec_conv1_fused.launches = 0


def dec_conv1_halo_preact(x_skip_s2d, skip_top, skip_bottom, x_prev, prev_top, prev_bottom, k_skip, k_prev, t9,
                          row0: int, hh_global: int) -> torch.Tensor:
    """:func:`dec_conv1_preact` on one H-shard: both inputs extended by
    their halo rows (zeros for None), the two convs over the extended
    blocks with their first and last rows dropped, and the bias field of
    global rows ``row0 ..`` of ``hh_global``. Differentiable in the inputs,
    the rows and the weights: the sharded training path's decoder conv1."""
    _, hh, ww, _ = x_skip_s2d.shape
    dt = x_skip_s2d.dtype
    y = (s2d_ops.conv3x3_s2d(extend_rows(x_skip_s2d, skip_top, skip_bottom), s2d_ops.s2d_conv3x3_kernel(k_skip))
         + s2d_ops.conv3x3_s2d(extend_rows(x_prev, prev_top, prev_bottom), k_prev))[:, 1:-1]
    return y + bias_table_field(t9, hh, ww, row0, hh_global)[None].to(dt)


def dec_conv1_halo_plain(x_skip_s2d, skip_top, skip_bottom, x_prev, prev_top, prev_bottom, k_skip, k_prev, t9,
                         row0: int, hh_global: int) -> torch.Tensor:
    """``relu`` of :func:`dec_conv1_halo_preact`: the plain version of
    :func:`dec_conv1_halo`."""
    return torch.relu(dec_conv1_halo_preact(x_skip_s2d, skip_top, skip_bottom, x_prev, prev_top, prev_bottom,
                                            k_skip, k_prev, t9, row0, hh_global))


def dec_conv1_halo(x_skip_s2d, skip_top, skip_bottom, x_prev, prev_top, prev_bottom, k_skip, k_prev, t9,
                   row0: int, hh_global: int) -> torch.Tensor:
    """K2 on one H-shard of the s2d grid (the sharded U-Net's decoder
    conv1): as :func:`dec_conv1_fused`, given the rows just above and below
    the shard of the skip (B, 1, Ww, 4·Cs) and of x_prev (B, 1, Ww, Cp),
    None at a global border, and the shard's first global row ``row0`` of
    ``hh_global``, from which the bias field's border rows are read. On
    CUDA: the widths :func:`_dec_conv1_fits` takes; stitched shards equal
    :func:`dec_conv1_fused` on the whole tensor bit for bit."""
    if x_skip_s2d.device.type == "cpu":
        return dec_conv1_halo_plain(x_skip_s2d, skip_top, skip_bottom, x_prev, prev_top, prev_bottom, k_skip,
                                    k_prev, t9, row0, hh_global)
    with span("kernel.dec_conv1_halo", (x_skip_s2d, skip_top, skip_bottom, x_prev, prev_top, prev_bottom, k_skip,
                                         k_prev, t9, row0, hh_global)):
        rows = [t for t in (skip_top, skip_bottom, prev_top, prev_bottom) if t is not None]
        require_no_grad("dec_conv1_halo", *rows)
        y = _dec_conv1_launch("dec_conv1_halo", x_skip_s2d, x_prev, k_skip, k_prev, t9,
                              halo=(skip_top, skip_bottom, prev_top, prev_bottom, row0, hh_global))
    dec_conv1_halo.launches += 1
    return y


dec_conv1_halo.launches = 0


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
    the widths :func:`_psel_fits` takes."""
    if x_s2d.device.type == "cpu":
        return psconv_train_plain(x_s2d, kernel)
    with span("kernel.psconv_fwd", (x_s2d, kernel)):
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
    with span("kernel.psconv_dgrad", (g_s2d, kernel)):
        y = _psel_launch("psconv_dgrad", g_s2d, kernel, None, relu=False, adjoint=True)
    psconv_dgrad.launches += 1
    return y


psconv_dgrad.launches = 0


def psconv_wgrad(x_s2d: torch.Tensor, g_s2d: torch.Tensor, kernel: torch.Tensor,
                 rows: Optional[Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]] = None) -> torch.Tensor:
    """The full-res kernel gradient of the raw conv, (3, 3, Cin, Cout) in at
    least f32, summed in f32 from the exact products of bf16 inputs, as the
    JAX package's ``preferred_element_type=f32`` does. PyTorch, as the JAX
    package computes it outside Pallas: the dense s2d weight gradient (one
    convolution backward on the s2d tensors as they lie, no relayout) on
    the inputs widened to f32, so that its output is not rounded to bf16
    (a bf16 value is exact in TF32, so cuDNN's TF32 path loses nothing),
    pulled back through ``s2d_conv3x3_kernel``'s tap map by its adjoint.

    ``rows`` = (top, bottom): x is one H-shard and g its rows of the
    cotangent; x is extended by the rows just above and below the shard
    (zeros for None, a global border) and the gradient taken VALID in H:
    the shard's share, whose sum over the shards is the whole gradient."""
    cin, cout = kernel.shape[2], kernel.shape[3]
    dt = torch.promote_types(kernel.dtype, torch.float32)
    pad = 1
    with span("kernel.psconv_wgrad", (x_s2d, g_s2d, kernel)):
        if rows is not None and (rows[0] is not None or rows[1] is not None):
            x_s2d, pad = extend_rows(x_s2d, *rows), (0, 1)
        dw = torch.nn.grad.conv2d_weight(
            x_s2d.to(dt).permute(0, 3, 1, 2), (4 * cout, 4 * cin, 3, 3), g_s2d.to(dt).permute(0, 3, 1, 2),
            padding=pad)
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


# ---------------------------------------------------------------------------
# K4 on an H-shard (spatial-parallel training)
# ---------------------------------------------------------------------------


def psconv_halo_plain(x_s2d: torch.Tensor, top: Optional[torch.Tensor], bottom: Optional[torch.Tensor],
                      kernel: torch.Tensor) -> torch.Tensor:
    """The raw s2d conv of one H-shard, given the s2d rows just above and
    below it (None at a global border): the dense s2d conv, VALID in H,
    over the shard extended by them (zeros for None); with no row at all,
    :func:`psconv_train_plain` itself. Differentiable in x, the rows and
    the kernel: the plain version of :func:`psconv_train_halo` (whose rows
    then come from a differentiable exchange) and of its two kernel
    entries (the dgrad's with the adjoint kernel)."""
    if top is None and bottom is None:
        return psconv_train_plain(x_s2d, kernel)
    return conv2d_nhwc(extend_rows(x_s2d, top, bottom), s2d_ops.s2d_conv3x3_kernel(kernel), padding=(0, 1))


def psconv_fwd_halo(x_s2d: torch.Tensor, top: Optional[torch.Tensor], bottom: Optional[torch.Tensor],
                    kernel: torch.Tensor) -> torch.Tensor:
    """K4 forward on one H-shard: the raw conv of the shard (B, Hh_local,
    Ww, 4·Cin) given the row just above and below it (B, 1, Ww, 4·Cin),
    None at a global border. On CUDA: K9's entry with no bias and no ReLU,
    for the widths :func:`_psel_fits` takes; stitched shards equal
    :func:`psconv_fwd` on the whole tensor bit for bit."""
    if x_s2d.device.type == "cpu":
        return psconv_halo_plain(x_s2d, top, bottom, kernel)
    with span("kernel.psconv_fwd_halo", (x_s2d, top, bottom, kernel)):
        y = _psel_launch("psconv_fwd_halo", x_s2d, kernel, None, relu=False, rows=(top, bottom))
    psconv_fwd_halo.launches += 1
    return y


psconv_fwd_halo.launches = 0


def psconv_dgrad_halo(g_s2d: torch.Tensor, g_top: Optional[torch.Tensor], g_bottom: Optional[torch.Tensor],
                      kernel: torch.Tensor) -> torch.Tensor:
    """K4 dgrad on one H-shard: dx of the shard's rows from the cotangent
    (B, Hh_local, Ww, 4·Cout) and its rows just above and below the shard
    (the neighbours' cotangent rows, None at a global border): the same
    conv with the adjoint kernel, so the neighbours' outputs' share in the
    shard's edge rows is in it. On CUDA: K9's entry with no bias and no
    ReLU; stitched shards equal :func:`psconv_dgrad` bit for bit (one tap
    order)."""
    if g_s2d.device.type == "cpu":
        return psconv_halo_plain(g_s2d, g_top, g_bottom, _adjoint(kernel))
    with span("kernel.psconv_dgrad_halo", (g_s2d, g_top, g_bottom, kernel)):
        y = _psel_launch("psconv_dgrad_halo", g_s2d, kernel, None, relu=False, rows=(g_top, g_bottom),
                         adjoint=True)
    psconv_dgrad_halo.launches += 1
    return y


psconv_dgrad_halo.launches = 0


class _PsconvTrainHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_s2d, kernel, top, bottom, exchange):
        ctx.save_for_backward(x_s2d, kernel, top, bottom)
        ctx.exchange = exchange
        return psconv_fwd_halo(x_s2d, top, bottom, kernel)

    @staticmethod
    def backward(ctx, g):
        x_s2d, kernel, top, bottom = ctx.saved_tensors
        g = g.contiguous()  # autograd may hand the cotangent over strided or expanded
        g_top, g_bottom = ctx.exchange(g)  # on every rank, whatever it needs: the neighbours wait for its rows
        dx = psconv_dgrad_halo(g, g_top, g_bottom, kernel).to(x_s2d.dtype) if ctx.needs_input_grad[0] else None
        dk = (psconv_wgrad(x_s2d, g, kernel, rows=(top, bottom)).to(kernel.dtype) if ctx.needs_input_grad[1]
              else None)
        return dx, dk, None, None, None


def psconv_train_halo(x_s2d: torch.Tensor, top: Optional[torch.Tensor], bottom: Optional[torch.Tensor],
                      kernel: torch.Tensor, exchange: Callable[[torch.Tensor], Tuple[Optional[torch.Tensor],
                                                                                       Optional[torch.Tensor]]]
                      ) -> torch.Tensor:
    """K4 on one H-shard, differentiable: the raw 3×3 'SAME' s2d conv of
    the shard's rows of the whole tensor. ``top`` / ``bottom``: the x rows
    just above / below the shard (None at a global border), which get no
    gradient; ``exchange(t)`` returns the rows of the same kind for a
    tensor t shaped as the output (the halo exchange over the spatial
    group, ``parallel/halo.py::halo_exchange_rows(t, 1, mesh)``; the rows
    by hand in one process), and the backward calls it on the cotangent.
    Forward :func:`psconv_fwd_halo`; dx :func:`psconv_dgrad_halo` of the
    cotangent and its exchanged rows, which holds the neighbouring shards'
    outputs' share of the shard's edge rows (so the x rows need no
    gradient of their own); the kernel gradient :func:`psconv_wgrad` over
    the shard extended by its x rows, VALID in H, summed over the ranks by
    the caller. On the CPU the two wrappers run their plain versions."""
    return _PsconvTrainHalo.apply(x_s2d, kernel, top, bottom, exchange)


# ---------------------------------------------------------------------------
# The U-Net's s2d conv sites: the kernel or the plain version
# ---------------------------------------------------------------------------


def conv2_s2d(x_s2d: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """An s2d ConvBlock's conv2 at inference: :func:`psel_conv3x3` (K1)
    where :func:`_psel_kernel` holds, else :func:`psel_conv3x3_plain`."""
    if _psel_kernel(x_s2d, kernel):
        return psel_conv3x3(x_s2d, kernel, bias)
    return psel_conv3x3_plain(x_s2d, kernel, bias)


def conv2_s2d_halo(x_s2d: torch.Tensor, top: Optional[torch.Tensor], bottom: Optional[torch.Tensor],
                   kernel: torch.Tensor, bias: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """:func:`conv2_s2d` on one H-shard, given its halo rows:
    :func:`psel_conv3x3_halo` (K9) under the same rule, else
    :func:`psel_conv3x3_halo_plain`."""
    if _psel_kernel(x_s2d, kernel):
        return psel_conv3x3_halo(x_s2d, top, bottom, kernel, bias, relu)
    return psel_conv3x3_halo_plain(x_s2d, top, bottom, kernel, bias, relu)


def conv2_s2d_train(x_s2d: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """An s2d ConvBlock's conv2 in training (no bias, no ReLU),
    differentiable: :func:`psconv_train` (K4) where :func:`_psel_kernel`
    holds, else :func:`psconv_train_plain`."""
    if _psel_kernel(x_s2d, kernel):
        return psconv_train(x_s2d, kernel)
    return psconv_train_plain(x_s2d, kernel)


Rows = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


def conv2_s2d_train_shard(x_s2d: torch.Tensor, kernel: torch.Tensor, exchange: Callable[[torch.Tensor], Rows],
                          rows: Callable[[torch.Tensor], Rows]) -> torch.Tensor:
    """:func:`conv2_s2d_train` on one H-shard. Under the same rule,
    :func:`psconv_train_halo` (K4 on the shard) with ``exchange(t)``, the
    rows just above and below the shard of a tensor t from the neighbouring
    shards outside autograd, which its backward calls on the cotangent;
    else :func:`psconv_halo_plain` over ``rows(x_s2d)``, the same rows
    through a differentiable exchange (or (None, None) without one)."""
    if _psel_kernel(x_s2d, kernel):
        return psconv_train_halo(x_s2d, *exchange(x_s2d), kernel, exchange)
    return psconv_halo_plain(x_s2d, *rows(x_s2d), kernel)


def dec_conv1(x_skip_s2d: torch.Tensor, x_prev: torch.Tensor, k_skip: torch.Tensor, k_prev: torch.Tensor,
              t9: torch.Tensor) -> torch.Tensor:
    """An s2d decoder's conv1 at inference: :func:`dec_conv1_fused` (K2)
    where :func:`_dec_conv1_kernel` holds, else
    :func:`dec_conv1_fused_plain`."""
    if _dec_conv1_kernel(x_skip_s2d, x_prev, k_skip):
        return dec_conv1_fused(x_skip_s2d, x_prev, k_skip, k_prev, t9)
    return dec_conv1_fused_plain(x_skip_s2d, x_prev, k_skip, k_prev, t9)


def dec_conv1_shard(x_skip_s2d, skip_top, skip_bottom, x_prev, prev_top, prev_bottom, k_skip, k_prev, t9,
                    row0: int, hh_global: int) -> torch.Tensor:
    """:func:`dec_conv1` on one H-shard, given its halo rows:
    :func:`dec_conv1_halo` (K2's sharded entry) under the same rule, else
    :func:`dec_conv1_halo_plain`."""
    fn = dec_conv1_halo if _dec_conv1_kernel(x_skip_s2d, x_prev, k_skip) else dec_conv1_halo_plain
    return fn(x_skip_s2d, skip_top, skip_bottom, x_prev, prev_top, prev_bottom, k_skip, k_prev, t9, row0, hh_global)
