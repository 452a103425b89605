"""The reference one precision step below the configuration: the control
that the output comparison has to reject.

``lower(dtype)`` runs every matrix product inside it as the nearest number
format below ``dtype`` would: bfloat16 models as float8 (e4m3, each
operand scaled per tensor to its largest value), float32 models as TF32
(the card's tensor-core float32).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

FP8_MAX = 448.0
_PRODUCTS = {torch.matmul, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
             torch.mm, torch.bmm, torch.einsum, F.linear, torch.addmm,
             torch.baddbmm, F.conv2d}


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with one scale for the tensor."""
    if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
        return x
    xf = x.float()
    scale = xf.abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (xf / scale).to(torch.float8_e4m3fn).float() * scale
    return q.to(x.dtype)


class Fp8Products(TorchFunctionMode):
    """Every matrix product's tensor operands rounded through float8."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = tuple(fp8_round(a) for a in args)
            kwargs = {k: fp8_round(v) for k, v in kwargs.items()}
        return func(*args, **kwargs)


@contextlib.contextmanager
def tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@contextlib.contextmanager
def exact():
    """float32 products without TF32: the reference's own precision."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def lower(dtype: str):
    """The control's context for a part the configuration states in
    ``dtype`` ("bfloat16" or "float32")."""
    if dtype == "bfloat16":
        return Fp8Products()
    if dtype == "float32":
        return tf32()
    raise ValueError(f"no control precision below {dtype!r}")
