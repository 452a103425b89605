"""Seeded weights, made by the benchmark on the device and handed to both
the program and the reference.

Shapes and initial scales are the reference's (``portbench/reference``,
the stds of the published models' random initialisers). Every normal leaf
of one model is a slice of one ``torch.randn`` call on the card, drawn from
the run's generator in a fixed order, so the same seed gives the same
weights; each leaf is then rounded once to the type the program serves it
in (a bf16 model's matmul weights are bf16 numbers), so the program's own
cast loses nothing and the reference computes on the same values.
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from .reference.models import layers as ref_layers
from .reference.models import vit as ref_vit
from .reference.models.sam import params as ref_params


class _Spec:
    """A leaf to be made: its shape and (std of a normal draw | constant)."""

    def __init__(self, shape, std=None, const=None, dtype=torch.float32):
        self.shape = tuple(int(s) for s in shape)
        self.std, self.const, self.dtype = std, const, dtype


class SpecInit(ref_params.Init):
    """The reference's ``Init`` recording leaves instead of drawing them."""

    def __init__(self):
        super().__init__(None, "meta")

    def normal(self, shape, std):
        return _Spec(shape, std=float(std))

    def zeros(self, *shape):
        return _Spec(shape, const=0.0)

    def linear(self, d_in, d_out, std=None):
        return {"w": self.normal((d_in, d_out),
                                 std if std is not None else d_in ** -0.5),
                "b": self.zeros(d_out)}

    def layer_norm(self, d):
        return {"scale": _Spec((d,), const=1.0), "bias": _Spec((d,), const=0.0)}


def _leaves(tree, out: List[_Spec]):
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif isinstance(tree, _Spec):
        out.append(tree)


def _draw(specs: List[_Spec], gen: torch.Generator) -> Dict[int, torch.Tensor]:
    """id(spec) -> f32 tensor: one randn for every normal leaf, sliced."""
    dev = gen.device
    normal = [s for s in specs if s.std is not None]
    total = sum(int(torch.Size(s.shape).numel()) for s in normal)
    flat = torch.randn(total, generator=gen, device=dev, dtype=torch.float32)
    out, off = {}, 0
    for s in normal:
        n = int(torch.Size(s.shape).numel())
        out[id(s)] = flat[off:off + n].view(s.shape).mul_(s.std).to(s.dtype)
        off += n
    for s in specs:
        if s.std is None:
            out[id(s)] = torch.full(s.shape, s.const, device=dev,
                                    dtype=s.dtype)
    return out


def _fill(tree, made: Dict[int, torch.Tensor]):
    if isinstance(tree, dict):
        return {k: _fill(v, made) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_fill(v, made) for v in tree]
    return made[id(tree)]


def _typed(tree, w_dtype):
    """Leaves named ``w`` (matmul and convolution weights) in the compute
    dtype, as the port's and the reference's ``ParamTree`` store them."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "w" and isinstance(v, _Spec):
                v.dtype = w_dtype
            else:
                _typed(v, w_dtype)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _typed(v, w_dtype)


def tree_weights(spec_tree, gen: torch.Generator,
                 w_dtype: torch.dtype = torch.float32):
    """A nested dict / list of ``_Spec`` (from a reference ``init_*`` run
    with :class:`SpecInit`) -> the same tree of device tensors, matmul
    weights in ``w_dtype`` and every other leaf in f32."""
    _typed(spec_tree, w_dtype)
    specs: List[_Spec] = []
    _leaves(spec_tree, specs)
    return _fill(spec_tree, _draw(specs, gen))


def module_specs(m: nn.Module, layer_scale=None) -> Dict[str, _Spec]:
    """name -> spec for the parameters of a reference tower or merger, with
    the stds of ``vit.init_vit`` / ``layers.init_block_`` /
    ``merger.init_merger``, each in the dtype ``m`` holds it in."""
    specs: Dict[str, _Spec] = {}
    for mod_name, mod in m.named_modules():
        pre = f"{mod_name}." if mod_name else ""
        if isinstance(mod, ref_layers.LayerNorm):
            specs[pre + "scale"] = _Spec(mod.scale.shape, const=1.0)
            specs[pre + "bias"] = _Spec(mod.bias.shape, const=0.0)
        elif isinstance(mod, ref_layers.Linear):
            specs[pre + "w"] = _Spec(mod.w.shape, std=mod.w.shape[0] ** -0.5)
            if mod.b is not None:
                specs[pre + "b"] = _Spec(mod.b.shape, const=0.0)
        elif isinstance(mod, ref_vit.PatchEmbed):
            specs[pre + "w"] = _Spec(mod.w.shape, std=0.02)
            specs[pre + "b"] = _Spec(mod.b.shape, const=0.0)
        elif isinstance(mod, ref_layers.Block) and mod.ls1 is not None:
            specs[pre + "ls1"] = _Spec(mod.ls1.shape, const=layer_scale)
            specs[pre + "ls2"] = _Spec(mod.ls2.shape, const=layer_scale)
        elif isinstance(mod, ref_vit.AttnPool):
            specs[pre + "probe"] = _Spec(mod.probe.shape, std=0.02)
        elif isinstance(mod, ref_vit.VisionTransformer):
            specs[pre + "proj"] = _Spec(mod.proj.shape,
                                        std=mod.proj.shape[0] ** -0.5)
            for name in ("cls", "pos"):
                if getattr(mod, name) is not None:
                    specs[pre + name] = _Spec(getattr(mod, name).shape,
                                              std=0.02)
    params = dict(m.named_parameters())
    if set(params) != set(specs):
        raise ValueError(f"unmatched parameters: "
                         f"{sorted(set(params) ^ set(specs))}")
    for k, s in specs.items():
        s.dtype = params[k].dtype
    return specs


def module_weights(m: nn.Module, gen: torch.Generator,
                   layer_scale=None) -> Dict[str, torch.Tensor]:
    """name -> device tensor for every parameter of module ``m`` (a
    reference skeleton in the served dtype, on any device)."""
    specs = module_specs(m, layer_scale)
    made = _draw(list(specs.values()), gen)
    return {k: made[id(s)] for k, s in specs.items()}


@torch.no_grad()
def load_module(m: nn.Module, weights: Dict[str, torch.Tensor]) -> nn.Module:
    """Copy ``weights`` into module ``m``'s parameters (each in the dtype
    and on the device ``m`` holds it)."""
    params = dict(m.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"weights do not match the module: "
                         f"{sorted(set(params) ^ set(weights))}")
    for k, p in params.items():
        p.copy_(weights[k].to(p.device, p.dtype))
    return m


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


