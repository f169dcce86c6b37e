"""The windowed 3×3 s2d conv as a hand-written CUDA kernel, with its plain
PyTorch version. Counterpart of ``mingraph_unet_tpu/ops/pallas/wconv.py``.

:func:`wconv3x3_s2d` replaces ``wconv3x3_s2d``: ``relu?(conv3x3(x) + bias)``
of a phase-major s2d tensor, where the four outputs of every 2×2 block are
one (16·Cin → 4·Cout) contraction of the 4×4 full-resolution window around
it, with the weights of :func:`wconv3x3_weights`. The input may be the
channel concat of separately transformed groups (``groups``, the decoder's
[skip ‖ up]).

The kernel (``csrc/wconv.cu``) never writes a patch matrix. In bf16, at
every width, it is a Hopper kernel: one ``wgmma`` with N = 4·Cout covers
the four output phases, K streams in chunks of 16 channels (each feeding
the four window taps of one input phase) through a ring of shared-memory
stages that a producer warpgroup fills by bulk copies (the weights,
:func:`wgmma_weight_chunks`) and ``cp.async`` (the halo), with zero weight
rows where a chunk's channel is a pad or another phase's, so the RGB
input's Cin 3 runs on tensor cores too. In f32 it is SIMT FMA. Both round once,
after the f32 bias and ReLU. It takes any number of groups and any Cin.

No entry point of the port calls it, as none in the JAX package does; it
has no backward. ``launches`` counts kernel launches.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mingraph_unet_tpu_torch.ops.kernels.build import (
    KERNEL_DTYPES,
    check_cuda_input,
    library,
    require,
    require_no_grad,
    stream_ptr,
)
from mingraph_unet_tpu_torch.utils.profiling import span

__all__ = ["wconv3x3_weights", "wconv3x3_s2d", "wconv3x3_s2d_plain", "wconv_uses_mma", "wgmma_weight_chunks"]

# Window tap d ∈ 0..3 reads s2d row (col) I − 1 + _POS[d] at intra-block
# phase _PHASE[d].
_POS = (0, 1, 1, 2)
_PHASE = (1, 0, 1, 0)
_SIMT_N = 16          # the SIMT path's column pass; its weights are padded to it
_WGMMA_N = (16, 32, 64, 128, 256)   # the wgmma widths the kernel is instantiated for
_KSTEP = 16           # channels of one K chunk (a wgmma k-step)
# The window taps (row or column) that read input phase P: phase(t) = P.
_TAPS_OF_PHASE = ((1, 3), (0, 2))


def wconv3x3_weights(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) 'SAME' conv kernel → (16·Cin, 4·Cout) windowed form.

    Rows are tap-major ((dy·4 + dx)·Cin + ci, full-res channel order),
    columns output-phase-major ((py·2 + px)·Cout + co), so the product is
    the s2d output block. The same gather and 0/1 mask as the JAX package,
    so the result is the same bit for bit."""
    cin, cout = kernel.shape[2], kernel.shape[3]
    u = np.zeros((4, 2), np.int64)
    valid = np.zeros((4, 2), bool)
    for d in range(4):
        for p in range(2):
            valid[d, p] = 0 <= d - p <= 2
            u[d, p] = np.clip(d - p, 0, 2)
    uy = torch.from_numpy(np.broadcast_to(u[:, None, :, None], (4, 4, 2, 2)).copy()).to(kernel.device)
    vx = torch.from_numpy(np.broadcast_to(u[None, :, None, :], (4, 4, 2, 2)).copy()).to(kernel.device)
    mask = torch.from_numpy((valid[:, None, :, None] & valid[None, :, None, :]).astype(np.float32))
    gathered = kernel[uy, vx] * mask.to(kernel.device, kernel.dtype)[..., None, None]
    return gathered.permute(0, 1, 4, 2, 3, 5).reshape(16 * cin, 4 * cout)


def _groups(cin: int, groups: Sequence[int]) -> Tuple[int, ...]:
    groups = tuple(int(g) for g in groups) if groups else (cin,)
    if sum(groups) != cin:
        raise ValueError(f"groups {groups} do not sum to Cin={cin}")
    return groups


@lru_cache(maxsize=None)
def _group_table(groups: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The kernel's (ngroups,) int32 group table on ``device``, cached: a
    host-to-card copy per call would wait on the stream."""
    return torch.tensor(groups, dtype=torch.int32).to(device)


def _windows(x_s2d: torch.Tensor, groups: Tuple[int, ...]) -> torch.Tensor:
    """(B, Hh, Ww, 4·Cin) → the (B, Hh, Ww, 16·Cin) window matrix: tap d
    of every s2d pixel, each group's channels of that tap's phase, zero
    outside the image."""
    _, hh, ww, _ = x_s2d.shape
    xp = F.pad(x_s2d, (0, 0, 1, 1, 1, 1))
    cols = []
    for dy in range(4):
        for dx in range(4):
            sl = xp[:, _POS[dy] : _POS[dy] + hh, _POS[dx] : _POS[dx] + ww]
            ph = _PHASE[dy] * 2 + _PHASE[dx]
            off = 0
            for g in groups:
                cols.append(sl[..., off + ph * g : off + (ph + 1) * g])
                off += 4 * g
    return torch.cat(cols, dim=-1)


def wconv3x3_s2d_plain(
    x_s2d: torch.Tensor, w2: torch.Tensor, bias: torch.Tensor, groups: Sequence[int] = (), relu: bool = True
) -> torch.Tensor:
    """The windowed contraction in PyTorch: gather every 2×2 block's 4×4
    window, multiply by ``w2`` cast to x's dtype with the products summed
    in f32 (at least), add the bias tiled to the four phases, ReLU, and
    cast once to x's dtype."""
    dt = x_s2d.dtype
    acc = torch.promote_types(dt, torch.float32)
    groups = _groups(x_s2d.shape[-1] // 4, groups)
    patches = _windows(x_s2d, groups)
    y = patches.to(acc) @ w2.to(device=x_s2d.device, dtype=dt).to(acc)
    y = y + bias.to(device=x_s2d.device, dtype=acc).repeat(4)
    if relu:
        y = torch.relu(y)
    return y.to(dt)


def wconv_uses_mma(dtype: torch.dtype) -> bool:
    """Whether the kernel runs on tensor cores: in bf16, at every width
    (``wgmma``, each group's phase block zero-padded to 16 channels); never
    in f32 (SIMT FMA)."""
    return dtype == torch.bfloat16


def _wgmma_cols(cout: int) -> Tuple[int, int]:
    """(N of one wgmma, column blocks): 4·Cout padded to a width the kernel
    has, in blocks of 256 columns where it is wider."""
    n = 4 * cout
    if n > 256:
        return 256, -(-n // 256)
    return next(w for w in _WGMMA_N if w >= n), 1


@lru_cache(maxsize=None)
def _chunk_plan(groups: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """The K chunks of the bf16 kernel, in order, as ``(table, rows)``:
    ``table[i]`` = (source s2d channel, valid channels, phase, 0)
    and ``rows[i, j, s]`` the row of w2 that slab j (window tap (dy, dx) =
    (_TAPS_OF_PHASE[py][j // 2], _TAPS_OF_PHASE[px][j % 2]) for the chunk's
    phase (py, px)) holds at k = s, −1 for a zero row.

    Where every group width is a multiple of 16, a chunk is one 16-channel
    step of one (group, phase) block (its halo a TMA box). Otherwise a chunk
    is 16 consecutive s2d channels, once per phase, and a row is non-zero
    only where the channel belongs to that phase (its halo copied 8 bytes at
    a time: an s2d pixel is 8·Cin bytes)."""
    cin = sum(groups)
    owner = []  # s2d channel -> (group's row offset, phase, channel)
    goff = 0
    for gw in groups:
        owner += [(goff, ph, c) for ph in range(4) for c in range(gw)]
        goff += gw
    if all(g % _KSTEP == 0 for g in groups):
        chunks = [(ch, _KSTEP, owner[ch][1], 0) for ch in range(0, 4 * cin, _KSTEP)]
    else:
        chunks = [(ch, min(_KSTEP, 4 * cin - ch), ph, 0) for ch in range(0, 4 * cin, _KSTEP) for ph in range(4)]
    rows = np.full((len(chunks), 4, _KSTEP), -1, np.int64)
    for i, (src, valid, ph, _) in enumerate(chunks):
        for j in range(4):
            d = 4 * _TAPS_OF_PHASE[ph >> 1][j >> 1] + _TAPS_OF_PHASE[ph & 1][j & 1]
            for k in range(valid):
                row0, cph, c = owner[src + k]
                if cph == ph:
                    rows[i, j, k] = d * cin + row0 + c
    return np.array(chunks, np.int32).reshape(-1, 4), rows


@lru_cache(maxsize=None)
def _chunk_gather(groups: Tuple[int, ...], cout: int, device: torch.device) -> torch.Tensor:
    """For every element of :func:`wgmma_weight_chunks`' output, its index
    in w2 flattened with one zero appended (the index of that zero where the
    element is a pad), on ``device``, cached: the packing is one gather."""
    cin = sum(groups)
    np_, ncb = _wgmma_cols(cout)
    rows = _chunk_plan(groups)[1]                                  # (chunks, 4, 16)
    cols = np.arange(ncb * np_).reshape(ncb, np_ // 8, 8)          # (cb, jn, r)
    # (cb, chunk, tap, jn, h, r, kk): row rows[chunk, tap, 8h + kk], column cols[cb, jn, r]
    r = rows.reshape(1, -1, 4, 1, 2, 1, 8)
    c = cols.reshape(ncb, 1, 1, np_ // 8, 1, 8, 1)
    idx = np.where((r >= 0) & (c < 4 * cout), r * (4 * cout) + c, 16 * cin * 4 * cout)
    return torch.from_numpy(idx.reshape(-1)).to(device)


def wgmma_weight_chunks(w2: torch.Tensor, groups: Sequence[int], cout: int) -> torch.Tensor:
    """w2 (16·Cin, 4·Cout) → the bf16 kernel's weight chunks
    (column blocks, chunks, 4 taps, N/8, 2, 8, 8): for each chunk of
    :func:`_chunk_plan`, its four 16-row slabs of w2 (zero rows where the
    plan has none, zero columns past 4·Cout) in wgmma's B layout
    (``B[16s + 8h + kk, 8j + r]`` at ``[s, j, h, r, kk]``, as
    psconv.py::wgmma_b_layout). A chunk of one column block is contiguous:
    the kernel's bulk copy."""
    groups = _groups(w2.shape[0] // 16, groups)
    np_, ncb = _wgmma_cols(cout)
    idx = _chunk_gather(groups, cout, w2.device)
    flat = torch.cat([w2.reshape(-1), w2.new_zeros(1)])
    return flat[idx].reshape(ncb, -1, 4, np_ // 8, 2, 8, 8)


@lru_cache(maxsize=None)
def _chunk_table(groups: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The kernel's (chunks, 4) int32 chunk table on ``device``, cached (a
    host-to-card copy per call would wait on the stream)."""
    return torch.from_numpy(_chunk_plan(groups)[0]).to(device)


def wconv3x3_s2d(
    x_s2d: torch.Tensor, w2: torch.Tensor, bias: torch.Tensor, groups: Sequence[int] = (), relu: bool = True
) -> torch.Tensor:
    """Fused conv3x3 (+bias, optional ReLU) on s2d-layout tensors.

    x_s2d: (B, Hh, Ww, 4·Cin) phase-major s2d input; w2: (16·Cin, 4·Cout)
    from :func:`wconv3x3_weights` (cast to x's dtype); bias: (Cout,)
    full-res (the BN-folded bias for inference); groups: full-res widths
    when x is a concat of separately transformed tensors (any number).
    Returns (B, Hh, Ww, 4·Cout) in x's dtype. A CPU tensor runs
    :func:`wconv3x3_s2d_plain`; a CUDA tensor launches the kernel (bf16 or
    f32, contiguous, 16-byte aligned, any Hh and Ww) or raises."""
    if x_s2d.device.type == "cpu":
        return wconv3x3_s2d_plain(x_s2d, w2, bias, groups, relu)
    with span("kernel.wconv3x3_s2d", (x_s2d, w2, bias)):
        require_no_grad("wconv3x3_s2d", x_s2d, w2, bias)
        dt = x_s2d.dtype
        require(dt in KERNEL_DTYPES, f"wconv3x3_s2d: unsupported dtype {dt}")
        check_cuda_input("x_s2d", x_s2d, dt)
        b, hh, ww, c4 = x_s2d.shape
        require(c4 % 4 == 0, f"x has {c4} s2d channels, not a multiple of 4")
        cin = c4 // 4
        groups = _groups(cin, groups)
        require(w2.dim() == 2 and w2.shape[0] == 16 * cin and w2.shape[1] % 4 == 0,
                f"w2 must be (16*{cin}, 4*Cout), got {tuple(w2.shape)}")
        cout = w2.shape[1] // 4
        require(tuple(bias.shape) == (cout,), f"bias must be ({cout},), got {tuple(bias.shape)}")
        dev = x_s2d.device
        mma = wconv_uses_mma(dt)
        with span("weights"):
            bias = bias.to(device=dev, dtype=torch.float32).contiguous()
            if mma:
                np_, ncb = _wgmma_cols(cout)
                w = wgmma_weight_chunks(w2.to(device=dev, dtype=dt), groups, cout)
                table = _chunk_table(groups, dev)
                bias4 = bias.repeat(4)  # the bias of every output column, phase-major
            else:
                npad = -(-4 * cout // _SIMT_N) * _SIMT_N
                w = F.pad(w2.to(device=dev, dtype=dt), (0, npad - 4 * cout)).contiguous()
                table = _group_table(groups, dev)
        y = torch.empty((b, hh, ww, 4 * cout), dtype=dt, device=dev)
        lib = library("wconv")
        if mma:
            rc = lib.mgu_wconv3x3_wgmma(
                x_s2d.data_ptr(), w.data_ptr(), bias4.data_ptr(), y.data_ptr(), b, hh, ww, cin, cout, np_, ncb,
                table.shape[0], table.data_ptr(), int(all(g % _KSTEP == 0 for g in groups)), int(relu),
                stream_ptr(x_s2d),
            )
        else:
            rc = lib.mgu_wconv3x3_simt(
                x_s2d.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(), b, hh, ww, cin, cout, npad,
                len(groups), table.data_ptr(), int(relu), stream_ptr(x_s2d),
            )
    if rc != 0:
        raise RuntimeError(f"wconv3x3_s2d launch failed: cudaError {rc}")
    wconv3x3_s2d.launches += 1
    return y


wconv3x3_s2d.launches = 0
