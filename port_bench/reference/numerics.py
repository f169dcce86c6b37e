"""How the reference computes its products: in f32 (the reference), or in
a lower precision (the controls that ``correct`` has to reject)."""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

MODES = ("f32", "tf32", "fp8")
FP8_MAX = 448.0  # largest finite float8 e4m3fn


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10 explicit mantissa bits (nearest, ties to even)."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


class Precision:
    """``q(x)`` is what a product sees of an f32 operand; :meth:`active`
    sets the card's TF32 switches for the mode around a reference run."""

    def __init__(self, mode: str = "f32"):
        if mode not in MODES:
            raise ValueError(f"precision {mode!r} is not one of {MODES}")
        self.mode = mode

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """The operand as the mode rounds it; in training the rounding
        passes the gradient straight through."""
        if self.mode == "fp8":
            d = x.detach()
            scale = d.abs().amax().clamp(min=1e-30) / FP8_MAX
            r = (d / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        elif self.mode == "tf32" and x.device.type == "cpu":
            r = _round_tf32(x.detach().float())
        else:
            return x
        return x + (r - x).detach() if x.requires_grad else r

    @contextlib.contextmanager
    def active(self) -> Iterator[None]:
        cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = self.mode == "tf32"
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, matmul
