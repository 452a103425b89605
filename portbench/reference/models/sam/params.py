"""Parameter trees of the SAM2 model.

The JAX package keeps a model's parameters as nested dicts and lists of
arrays (``ovo_tpu/models/layers.py:1-7``). :class:`ParamTree` holds the same
tree as modules, so that ``node["attn"]["qkv"]["w"]``, ``node.get("b")``
and ``"proj" in node`` read as they do in JAX, lists index by position, and
``named_parameters()`` yields the JAX paths (``trunk.blocks.3.attn.qkv.w``):
``models/convert_jax.load_jax_params`` fills a tree by path with no
transposes. Matmul and convolution weights (leaves named ``w``, which the
reference always casts to the compute dtype before use) are stored in the
compute dtype; every other leaf stays f32, as the reference keeps it.

:class:`Init` draws the random initial values of the JAX package's
``init_*`` functions (same shapes and stds) from a ``torch.Generator``;
without a generator it gives zeros, the skeleton a converted tree fills.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn


class ParamTree(nn.Module):
    def __init__(self, tree: Dict[str, Any],
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val, compute_dtype))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, nn.ModuleList(
                    ParamTree(v, compute_dtype) for v in val))
            elif val is not None:
                dtype = compute_dtype if key == "w" else torch.float32
                self.register_parameter(key, nn.Parameter(
                    val.to(dtype), requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._modules or key in self._parameters

    def get(self, key: str, default=None):
        return self[key] if key in self else default


class Init:
    """Random (``gen`` given) or zero (``gen=None``) initial leaves on
    ``device``, f32, in the shapes of the JAX package's initializers."""

    def __init__(self, gen: Optional[torch.Generator], device):
        self.gen = gen
        self.device = device

    def normal(self, shape: Tuple[int, ...], std: float) -> torch.Tensor:
        if self.gen is None:
            return torch.zeros(shape, device=self.device)
        return torch.randn(shape, generator=self.gen,
                           device=self.device) * std

    def zeros(self, *shape: int) -> torch.Tensor:
        return torch.zeros(shape, device=self.device)

    def linear(self, d_in: int, d_out: int,
               std: Optional[float] = None) -> Dict[str, torch.Tensor]:
        return {"w": self.normal((d_in, d_out),
                                 std if std is not None else d_in ** -0.5),
                "b": self.zeros(d_out)}

    def layer_norm(self, d: int) -> Dict[str, torch.Tensor]:
        return {"scale": torch.ones(d, device=self.device),
                "bias": self.zeros(d)}
