"""How the reference rounds, so that one implementation serves as both the
plain fp32 reference and the lower-precision control.

``Precision.product`` rounds each operand of every product of the model
(convolutions, linear layers) in the forward pass, and the gradient that
reaches it in the backward pass; ``Precision.post`` rounds the box
coordinates that NMS compares and the operands of the mask product. The
reference is :data:`FP32` (no rounding; TF32 off, :func:`no_tf32`). The
control is :data:`CONTROL`: the step below each stage's stated precision,
fp8 (e4m3 forward, e5m2 backward, one scale per tensor) for the model,
which the configuration states in bf16, and bf16 for NMS and the masks,
which run in fp32.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round_fp8(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``t`` through fp8 and back, scaled so that its largest magnitude maps
    to the format's largest finite value."""
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round_fp8(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, E5M2_MAX)


def fp8(t: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(t)


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    product: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    post: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def p(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.product is None else self.product(t)

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.post is None else self.post(t)


FP32 = Precision("fp32")
CONTROL = Precision("fp8", product=fp8, post=bf16)


@contextlib.contextmanager
def no_tf32():
    """fp32 products in fp32: TF32 off for cuBLAS and cuDNN, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
