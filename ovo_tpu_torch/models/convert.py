"""Official torch checkpoints -> the param trees of the port (port of
``ovo_tpu/models/convert.py``).

Covers the CLIP / open_clip towers (``visual.conv1`` /
``transformer.resblocks`` / ``attn.in_proj_weight`` naming, which the
Perception-Encoder repo follows too), timm vision trunks as open_clip exposes
the SigLIP towers, the PE attention-pool probe, and the learned merger
(``torch.nn.TransformerEncoder`` naming).

A converter gives the nested numpy tree of the JAX package's param trees:
``nn.Linear`` (out, in) -> ``w`` (in, out); conv OIHW -> HWIO; merged
in_proj rows [q; k; v] -> qkv columns. ``models/convert_jax.load_jax_params``
fills the port's modules from that tree by path, with no transposes of its
own. A required key that is missing raises ``KeyError`` with its name.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

import numpy as np


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def _lin(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    w = _np(sd[f"{prefix}.weight"]).T
    b = _np(sd[f"{prefix}.bias"]) if f"{prefix}.bias" in sd else None
    return {"w": w, "b": b}


def _ln(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def _attn(sd: Dict, prefix: str) -> Dict[str, Any]:
    """nn.MultiheadAttention: a merged in_proj, or q / k / v projections."""
    if f"{prefix}.in_proj_weight" in sd:
        w = _np(sd[f"{prefix}.in_proj_weight"]).T          # (D, 3D)
        b = (_np(sd[f"{prefix}.in_proj_bias"])
             if f"{prefix}.in_proj_bias" in sd else None)
        return {"qkv": {"w": w, "b": b},
                "out": _lin(sd, f"{prefix}.out_proj")}
    return {"q": _lin(sd, f"{prefix}.q_proj"),
            "k": _lin(sd, f"{prefix}.k_proj"),
            "v": _lin(sd, f"{prefix}.v_proj"),
            "out": _lin(sd, f"{prefix}.out_proj")}


def _count(sd: Dict, pattern: str) -> int:
    """The number of blocks ``n`` for which ``pattern.format(n)`` is a key."""
    n = 0
    while pattern.format(n) in sd:
        n += 1
    return n


def convert_clip_block(sd: Dict, prefix: str) -> Dict[str, Any]:
    p = {
        "ln1": _ln(sd, f"{prefix}.ln_1"),
        "attn": _attn(sd, f"{prefix}.attn"),
        "ln2": _ln(sd, f"{prefix}.ln_2"),
        "mlp": {"fc": _lin(sd, f"{prefix}.mlp.c_fc"),
                "proj": _lin(sd, f"{prefix}.mlp.c_proj")},
    }
    if f"{prefix}.ls_1.gamma" in sd:
        p["ls1"] = _np(sd[f"{prefix}.ls_1.gamma"])
        p["ls2"] = _np(sd[f"{prefix}.ls_2.gamma"])
    return p


def convert_visual_tower(sd: Dict, prefix: str = "visual") -> Dict[str, Any]:
    n_blocks = _count(sd, prefix + ".transformer.resblocks.{}.ln_1.weight")
    if n_blocks == 0:
        raise KeyError(f"no transformer blocks under {prefix}.transformer")
    conv = _np(sd[f"{prefix}.conv1.weight"])               # (W, 3, p, p)
    params: Dict[str, Any] = {
        "patch": {"w": conv.transpose(2, 3, 1, 0),
                  "b": (_np(sd[f"{prefix}.conv1.bias"])
                        if f"{prefix}.conv1.bias" in sd
                        else np.zeros(conv.shape[0], np.float32))},
        "blocks": [convert_clip_block(
            sd, f"{prefix}.transformer.resblocks.{i}")
            for i in range(n_blocks)],
        "ln_post": _ln(sd, f"{prefix}.ln_post"),
        "proj": _np(sd[f"{prefix}.proj"]),
    }
    if f"{prefix}.class_embedding" in sd:
        params["cls"] = _np(sd[f"{prefix}.class_embedding"]).reshape(-1)
    if f"{prefix}.positional_embedding" in sd:
        params["pos"] = _np(sd[f"{prefix}.positional_embedding"])
    if f"{prefix}.ln_pre.weight" in sd:
        params["ln_pre"] = _ln(sd, f"{prefix}.ln_pre")
    if f"{prefix}.attn_pool.probe" in sd:
        params["attn_pool"] = convert_attn_pool(sd, f"{prefix}.attn_pool")
    return params


def convert_attn_pool(sd: Dict, prefix: str) -> Dict[str, Any]:
    attn = _attn(sd, f"{prefix}.attn")
    if "qkv" in attn:
        w, b = attn["qkv"]["w"], attn["qkv"]["b"]
        d = w.shape[0]

        def part(i):
            return {"w": w[:, i * d:(i + 1) * d],
                    "b": None if b is None else b[i * d:(i + 1) * d]}

        q, k, v = part(0), part(1), part(2)
    else:
        q, k, v = attn["q"], attn["k"], attn["v"]
    ln_key = (f"{prefix}.layernorm" if f"{prefix}.layernorm.weight" in sd
              else f"{prefix}.ln")
    return {"probe": _np(sd[f"{prefix}.probe"]).reshape(1, -1),
            "ln": _ln(sd, ln_key), "q": q, "k": k, "v": v,
            "out": attn["out"]}


def convert_text_tower(sd: Dict, prefix: str = "") -> Dict[str, Any]:
    pre = f"{prefix}." if prefix else ""
    n_blocks = _count(sd, pre + "transformer.resblocks.{}.ln_1.weight")
    params = {
        "tok_embed": _np(sd[f"{pre}token_embedding.weight"]),
        "pos": _np(sd[f"{pre}positional_embedding"]),
        "blocks": [convert_clip_block(sd, f"{pre}transformer.resblocks.{i}")
                   for i in range(n_blocks)],
        "ln_final": _ln(sd, f"{pre}ln_final"),
    }
    # a raw (D, E) matrix in OpenAI-CLIP checkpoints, an nn.Linear (with a
    # bias: proj_bias) in open_clip's SigLIP family
    if f"{pre}text_projection.weight" in sd:
        lin = _lin(sd, f"{pre}text_projection")
        params["proj"] = lin["w"]
        if lin["b"] is not None:
            params["proj_bias"] = lin["b"]
    else:
        params["proj"] = _np(sd[f"{pre}text_projection"])
    return params


def convert_timm_trunk(sd: Dict, prefix: str = "visual.trunk"
                       ) -> Dict[str, Any]:
    """timm ViT naming, as open_clip exposes the SigLIP / SigLIP2 vision
    towers (``blocks.N.attn.qkv``, ``mlp.fc1``, ``patch_embed.proj``; the
    MAP head ``attn_pool.{latent, q, kv, proj, norm, mlp}``)."""
    n_blocks = _count(sd, prefix + ".blocks.{}.norm1.weight")
    if n_blocks == 0:
        raise KeyError(f"no timm blocks under {prefix}.blocks")

    def block(i):
        pre = f"{prefix}.blocks.{i}"
        return {"ln1": _ln(sd, f"{pre}.norm1"),
                "attn": {"qkv": _lin(sd, f"{pre}.attn.qkv"),
                         "out": _lin(sd, f"{pre}.attn.proj")},
                "ln2": _ln(sd, f"{pre}.norm2"),
                "mlp": {"fc": _lin(sd, f"{pre}.mlp.fc1"),
                        "proj": _lin(sd, f"{pre}.mlp.fc2")}}

    conv = _np(sd[f"{prefix}.patch_embed.proj.weight"])    # (W, 3, p, p)
    width = conv.shape[0]
    params: Dict[str, Any] = {
        "patch": {"w": conv.transpose(2, 3, 1, 0),
                  "b": _np(sd[f"{prefix}.patch_embed.proj.bias"])},
        "blocks": [block(i) for i in range(n_blocks)],
        "ln_post": _ln(sd, f"{prefix}.norm"),
        # the SigLIP towers embed at trunk width (no projection)
        "proj": np.eye(width, dtype=np.float32),
    }
    if f"{prefix}.pos_embed" in sd:
        params["pos"] = _np(sd[f"{prefix}.pos_embed"]).reshape(-1, width)
    ap = f"{prefix}.attn_pool"
    if f"{ap}.latent" in sd:
        kv = _np(sd[f"{ap}.kv.weight"])                    # (2W, W)
        kvb = (_np(sd[f"{ap}.kv.bias"]) if f"{ap}.kv.bias" in sd
               else np.zeros(kv.shape[0], np.float32))
        k_w, v_w = np.split(kv, 2, axis=0)
        k_b, v_b = np.split(kvb, 2, axis=0)
        params["attn_pool"] = {
            # timm normalizes nothing on the kv input (PE's probe head
            # does); its norm sits after the attention, before the MLP
            "probe": _np(sd[f"{ap}.latent"]).reshape(1, width),
            "ln": None,
            "q": _lin(sd, f"{ap}.q"),
            "k": {"w": k_w.T, "b": k_b},
            "v": {"w": v_w.T, "b": v_b},
            "out": _lin(sd, f"{ap}.proj"),
        }
        if f"{ap}.mlp.fc1.weight" in sd:
            params["attn_pool"]["ln2"] = _ln(sd, f"{ap}.norm")
            params["attn_pool"]["mlp"] = {"fc": _lin(sd, f"{ap}.mlp.fc1"),
                                          "proj": _lin(sd, f"{ap}.mlp.fc2")}
    return params


def convert_clip_state_dict(sd: Dict) -> Dict[str, Any]:
    visual = (convert_timm_trunk(sd)
              if "visual.trunk.patch_embed.proj.weight" in sd
              else convert_visual_tower(sd, "visual"))
    return {
        "visual": visual,
        "text": convert_text_tower(
            sd, "text" if "text.token_embedding.weight" in sd else ""),
        "logit_scale": (_np(sd["logit_scale"]).reshape(())
                        if "logit_scale" in sd
                        else np.float32(np.log(1 / 0.07))),
        "logit_bias": (_np(sd["logit_bias"]).reshape(())
                       if "logit_bias" in sd else np.float32(0.0)),
    }


def infer_vit_config(visual_params: Dict[str, Any], image_size: int,
                     base_cfg):
    """A registry ``ViTConfig`` overridden from the converted shapes."""
    patch = visual_params["patch"]["w"].shape[0]
    return dataclasses.replace(
        base_cfg, patch_size=patch,
        width=visual_params["patch"]["w"].shape[-1],
        depth=len(visual_params["blocks"]),
        embed_dim=visual_params["proj"].shape[-1], image_size=image_size,
        use_cls_token="cls" in visual_params,
        use_abs_pos="pos" in visual_params,
        pool="attn" if "attn_pool" in visual_params else base_cfg.pool,
        ln_pre="ln_pre" in visual_params)


def _load_state_dict(path: str) -> Dict:
    """``torch.load`` as the reference calls it (``weights_only=False``),
    a ``state_dict`` entry unwrapped, ``module.`` prefixes stripped."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.replace("module.", ""): v for k, v in sd.items()}


def load_clip_checkpoint(model_card: str, ckpt_path: str, device="cuda"):
    """An official open_clip / PE checkpoint as a ``CLIPModel`` on
    ``device``: the registry card's configs overridden from the converted
    shapes, the tokenizer from the checkpoint's directory."""
    from .clip import MODEL_REGISTRY, CLIPModel
    from .tokenizers import get_tokenizer

    params = convert_clip_state_dict(_load_state_dict(ckpt_path))
    base = MODEL_REGISTRY[model_card]
    text = params["text"]
    tcfg = dataclasses.replace(
        base.text, vocab_size=text["tok_embed"].shape[0],
        context_length=text["pos"].shape[0],
        width=text["tok_embed"].shape[1], depth=len(text["blocks"]),
        embed_dim=text["proj"].shape[-1])
    cfg = dataclasses.replace(
        base, vision=infer_vit_config(params["visual"],
                                      base.vision.image_size, base.vision),
        text=tcfg)
    tok = get_tokenizer(os.path.dirname(ckpt_path), tcfg.context_length,
                        card=cfg)
    return CLIPModel.from_jax_params(cfg, params, device=device,
                                     tokenizer=tok)


def convert_merger_state_dict(sd: Dict) -> Dict[str, Any]:
    """torch.nn.TransformerEncoder naming, ``layers.N.{self_attn, linear1,
    linear2, norm1, norm2}``, and an MLP head (its first and last weights
    in key order)."""
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    base = ("encoder.layers" if any(k.startswith("encoder.layers")
                                    for k in sd) else "transformer.layers")
    blocks = []
    for i in range(_count(sd, base + ".{}.norm1.weight")):
        p = f"{base}.{i}"
        blocks.append({"ln1": _ln(sd, f"{p}.norm1"),
                       "attn": _attn(sd, f"{p}.self_attn"),
                       "ln2": _ln(sd, f"{p}.norm2"),
                       "mlp": {"fc": _lin(sd, f"{p}.linear1"),
                               "proj": _lin(sd, f"{p}.linear2")}})
    head_names = sorted(k for k in sd if "weight" in k and "layers" not in k
                        and "norm" not in k)
    if len(head_names) < 2:
        raise KeyError(f"cannot locate merger MLP head among {list(sd)[:8]}")
    fc_name = head_names[0].rsplit(".weight", 1)[0]
    proj_name = head_names[-1].rsplit(".weight", 1)[0]
    return {"blocks": blocks,
            "head": {"fc": _lin(sd, fc_name), "proj": _lin(sd, proj_name)}}
