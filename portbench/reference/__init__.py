"""The benchmark's plain reference: a frozen copy of the port's model,
association and map code with every hand-written kernel replaced by the
plain PyTorch function it computes, run in float32 (no TF32).

It imports neither the port nor JAX, and takes nothing the program made:
the benchmark hands it the same seeded weights and frames it hands the
program, and the program's outputs only to judge them. Later changes to the
program do not reach it.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "to_device"]


def resolve_device(device="cuda") -> torch.device:
    return torch.device(device)


def to_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    """Host array (or tensor) -> tensor on ``device``."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    t = t.to(device)
    return t if dtype is None else t.to(dtype)
