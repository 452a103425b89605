"""Carry the JAX package's parameters into the port.

The JAX param tree (``ovo_tpu/models/layers.py:1-7``) is nested dicts and
lists of arrays. The port's modules name their parameters by the same paths
(``blocks.3.attn.qkv.w``) and keep the same layouts -- linear weights
``(d_in, d_out)`` used as ``x @ w``, the patch weight HWIO ``(p, p, 3,
width)``, ``proj`` ``(width, embed_dim)`` -- so a tree loads by path with no
transposes. Leaves arrive as numpy arrays (``np.asarray`` of JAX arrays).

Trees carried this way: a CLIP model's ``visual`` and ``text`` towers with
its ``logit_scale`` / ``logit_bias`` scalars (``models/clip.py``
``CLIPModel.from_jax_params``), the SAM2 model (``models/sam/model.py``) and
the learned merger (:func:`merger_from_jax_params`).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn


def flatten_tree(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted path, leaf) pairs of a nested dict / list tree; None leaves
    (an absent bias) are skipped."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        if tree is not None:
            yield prefix, tree
        return
    for k, v in items:
        yield from flatten_tree(v, f"{prefix}.{k}" if prefix else str(k))


def load_jax_params(module_or_tree: Union[nn.Module, Dict[str, Any]],
                    np_tree: Dict[str, Any], device=None,
                    dtype: Optional[torch.dtype] = None):
    """Fill ``module_or_tree`` from ``np_tree``.

    For an ``nn.Module`` every parameter must have a leaf of the same path
    and shape (and vice versa); leaves are cast to each parameter's own
    dtype (compute-dtype matmul weights, f32 norms) unless ``dtype`` forces
    one, and land on ``device`` (default: where the module lives). Returns
    the module. For a dict (or None) returns the flat ``{path: tensor}``
    map of ``np_tree`` on ``device`` in ``dtype`` (default: the leaf's)."""
    leaves = dict(flatten_tree(np_tree))
    if not isinstance(module_or_tree, nn.Module):
        return {k: torch.as_tensor(np.asarray(v), device=device,
                                   dtype=dtype) for k, v in leaves.items()}
    module = module_or_tree
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(leaves))
    extra = sorted(set(leaves) - set(params))
    if missing or extra:
        raise KeyError(f"param tree mismatch: missing {missing[:8]}, "
                       f"unexpected {extra[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            arr = np.asarray(leaves[name])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape} != "
                                 f"{tuple(p.shape)}")
            p.data = torch.from_numpy(np.array(arr)).to(
                device=device or p.device, dtype=dtype or p.dtype)
    return module


def merger_from_jax_params(np_tree: Dict[str, Any], device=None,
                           n_heads: int = 8):
    """The learned merger (``models/merger.py``) from the JAX
    ``init_merger`` tree (numpy leaves); sizes are read off the tree."""
    from .merger import LearnedMerger, MergerParams

    fc = np.asarray(np_tree["head"]["fc"]["w"])
    d_model, mlp_hidden = fc.shape
    params = MergerParams(d_model, len(np_tree["blocks"]), n_heads,
                          mlp_hidden, device=device)
    return LearnedMerger(load_jax_params(params, np_tree, device), n_heads)
