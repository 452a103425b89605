"""Official SAM / SAM2 checkpoints -> the port's SAM param tree (port of
``ovo_tpu/models/convert_sam.py``).

SAM2 checkpoints hold a flat ``model`` state dict under
``image_encoder.trunk.*`` (Hiera), ``image_encoder.neck.*`` (the FPN
convolutions), ``sam_prompt_encoder.*`` and ``sam_mask_decoder.*``. SAM1
checkpoints (segment_anything) hold ``image_encoder.*`` (the ViT-det with
its neck), ``prompt_encoder.*`` and ``mask_decoder.*`` (no object-score
parts). Renaming plus the layout moves of ``models/convert.py`` (Linear
(out, in) -> ``w.T``, conv OIHW -> HWIO, ConvTranspose IOHW -> HWIO).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .convert import _count, _lin, _ln, _np


def _conv(sd, prefix) -> Dict[str, np.ndarray]:
    w = _np(sd[f"{prefix}.weight"])                    # (O, I, kh, kw)
    b = (_np(sd[f"{prefix}.bias"]) if f"{prefix}.bias" in sd
         else np.zeros(w.shape[0], np.float32))
    return {"w": w.transpose(2, 3, 1, 0), "b": b}


def _conv_transpose(sd, prefix) -> Dict[str, np.ndarray]:
    w = _np(sd[f"{prefix}.weight"])                    # (I, O, kh, kw)
    b = (_np(sd[f"{prefix}.bias"]) if f"{prefix}.bias" in sd
         else np.zeros(w.shape[1], np.float32))
    return {"w": w.transpose(2, 3, 0, 1), "b": b}      # (kh, kw, I, O)


def convert_hiera(sd: Dict, prefix: str = "image_encoder.trunk"
                  ) -> Dict[str, Any]:
    blocks = []
    for i in range(_count(sd, prefix + ".blocks.{}.norm1.weight")):
        p = f"{prefix}.blocks.{i}"
        blk = {"norm1": _ln(sd, f"{p}.norm1"),
               "attn": {"qkv": _lin(sd, f"{p}.attn.qkv"),
                        "proj": _lin(sd, f"{p}.attn.proj")},
               "norm2": _ln(sd, f"{p}.norm2"),
               "mlp": {"fc": _lin(sd, f"{p}.mlp.layers.0"),
                       "proj": _lin(sd, f"{p}.mlp.layers.1")}}
        if f"{p}.proj.weight" in sd:
            blk["proj"] = _lin(sd, f"{p}.proj")
        blocks.append(blk)
    pos = _np(sd[f"{prefix}.pos_embed"])               # (1, C, H, W)
    pos_win = _np(sd[f"{prefix}.pos_embed_window"])
    return {"patch": _conv(sd, f"{prefix}.patch_embed.proj"),
            "pos_embed": pos[0].transpose(1, 2, 0),
            "pos_embed_window": pos_win[0].transpose(1, 2, 0),
            "blocks": blocks}


def convert_vitdet(sd: Dict, prefix: str = "image_encoder") -> Dict[str, Any]:
    """The SAM1 ViT-det trunk (segment_anything's image_encoder.py):
    ``patch_embed.proj``, ``pos_embed`` stored (1, H, W, C) channels-last,
    blocks with ``attn.{qkv, proj, rel_pos_h, rel_pos_w}`` and
    ``mlp.lin1 / lin2``, and the neck (1x1 conv, LayerNorm2d, 3x3 conv,
    LayerNorm2d; the convolutions without bias)."""
    blocks = []
    for i in range(_count(sd, prefix + ".blocks.{}.norm1.weight")):
        p = f"{prefix}.blocks.{i}"
        blocks.append({
            "norm1": _ln(sd, f"{p}.norm1"),
            "attn": {"qkv": _lin(sd, f"{p}.attn.qkv"),
                     "proj": _lin(sd, f"{p}.attn.proj"),
                     "rel_pos_h": _np(sd[f"{p}.attn.rel_pos_h"]),
                     "rel_pos_w": _np(sd[f"{p}.attn.rel_pos_w"])},
            "norm2": _ln(sd, f"{p}.norm2"),
            "mlp": {"fc": _lin(sd, f"{p}.mlp.lin1"),
                    "proj": _lin(sd, f"{p}.mlp.lin2")}})
    return {
        "patch": _conv(sd, f"{prefix}.patch_embed.proj"),
        "pos_embed": _np(sd[f"{prefix}.pos_embed"])[0],    # (H, W, C)
        "blocks": blocks,
        "neck": {
            "conv1": {"w": _np(sd[f"{prefix}.neck.0.weight"]
                               ).transpose(2, 3, 1, 0)},
            "ln1": _ln(sd, f"{prefix}.neck.1"),
            "conv2": {"w": _np(sd[f"{prefix}.neck.2.weight"]
                               ).transpose(2, 3, 1, 0)},
            "ln2": _ln(sd, f"{prefix}.neck.3"),
        },
    }


def convert_neck(sd: Dict, prefix: str = "image_encoder.neck"
                 ) -> Dict[str, Any]:
    convs = [_conv(sd, f"{prefix}.convs.{i}.conv")
             for i in range(_count(sd, prefix + ".convs.{}.conv.weight"))]
    # the checkpoint lists the lowest resolution first; the neck takes the
    # highest first
    return {"convs": convs[::-1]}


def convert_prompt_encoder(sd: Dict, prefix: str = "sam_prompt_encoder"
                           ) -> Dict[str, Any]:
    embeds = np.stack([
        _np(sd[f"{prefix}.point_embeddings.{i}.weight"]).reshape(-1)
        for i in range(4)])
    return {
        "pe_gaussian": _np(
            sd[f"{prefix}.pe_layer.positional_encoding_gaussian_matrix"]),
        "point_embeds": embeds,
        "not_a_point": _np(sd[f"{prefix}.not_a_point_embed.weight"]
                           ).reshape(-1),
        "no_mask": _np(sd[f"{prefix}.no_mask_embed.weight"]).reshape(-1),
    }


def convert_mask_decoder(sd: Dict, prefix: str = "sam_mask_decoder",
                         obj_token: bool = True) -> Dict[str, Any]:
    """``obj_token=False`` (SAM1 checkpoints) leaves the object-score token
    and head out, so ``decode_masks`` runs the SAM1 token layout; a SAM2
    layout without those keys gets zeros (a one-linear head when the
    checkpoint has one)."""
    def attn(p):
        return {"q": _lin(sd, f"{p}.q_proj"), "k": _lin(sd, f"{p}.k_proj"),
                "v": _lin(sd, f"{p}.v_proj"),
                "out": _lin(sd, f"{p}.out_proj")}

    def mlp3(p):
        return {"l0": _lin(sd, f"{p}.layers.0"),
                "l1": _lin(sd, f"{p}.layers.1"),
                "l2": _lin(sd, f"{p}.layers.2")}

    layers = []
    for i in range(_count(sd, prefix + ".transformer.layers.{}.norm1.weight")):
        p = f"{prefix}.transformer.layers.{i}"
        layers.append({
            "self_attn": attn(f"{p}.self_attn"),
            "norm1": _ln(sd, f"{p}.norm1"),
            "cross_t2i": attn(f"{p}.cross_attn_token_to_image"),
            "norm2": _ln(sd, f"{p}.norm2"),
            "mlp": {"fc": _lin(sd, f"{p}.mlp.lin1"),
                    "proj": _lin(sd, f"{p}.mlp.lin2")},
            "norm3": _ln(sd, f"{p}.norm3"),
            "cross_i2t": attn(f"{p}.cross_attn_image_to_token"),
            "norm4": _ln(sd, f"{p}.norm4"),
        })
    n_hyper = _count(sd, prefix
                     + ".output_hypernetworks_mlps.{}.layers.0.weight")
    params = {
        "iou_token": _np(sd[f"{prefix}.iou_token.weight"]).reshape(-1),
        "mask_tokens": _np(sd[f"{prefix}.mask_tokens.weight"]),
        "layers": layers,
        "final_attn": attn(f"{prefix}.transformer.final_attn_token_to_image"),
        "norm_final": _ln(sd, f"{prefix}.transformer.norm_final_attn"),
        "upscale1": _conv_transpose(sd, f"{prefix}.output_upscaling.0"),
        "upscale_ln": _ln(sd, f"{prefix}.output_upscaling.1"),
        "upscale2": _conv_transpose(sd, f"{prefix}.output_upscaling.3"),
        "hyper_mlps": [mlp3(f"{prefix}.output_hypernetworks_mlps.{i}")
                       for i in range(n_hyper)],
        "iou_head": mlp3(f"{prefix}.iou_prediction_head"),
    }
    if obj_token:
        params["obj_score_token"] = (
            _np(sd[f"{prefix}.obj_score_token.weight"]).reshape(-1)
            if f"{prefix}.obj_score_token.weight" in sd
            else np.zeros_like(params["iou_token"]))
        head = f"{prefix}.pred_obj_score_head"
        params["obj_head"] = (
            mlp3(head) if f"{head}.layers.2.weight" in sd
            and f"{head}.layers.0.weight" in sd
            else _lin(sd, head) if f"{head}.weight" in sd
            else {"w": np.zeros((256, 1), np.float32),
                  "b": np.zeros((1,), np.float32)})
    if f"{prefix}.conv_s0.weight" in sd:
        params["conv_s0"] = _conv(sd, f"{prefix}.conv_s0")
        params["conv_s1"] = _conv(sd, f"{prefix}.conv_s1")
    return params


def convert_sam_state_dict(sd: Dict) -> Dict[str, Any]:
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    if not any(k.startswith("image_encoder.trunk.") for k in sd):
        # SAM1: image_encoder.* is the ViT-det, neck included; the prompt
        # encoder and decoder carry no sam_ prefix, the decoder no
        # object-score parts
        return {"trunk": convert_vitdet(sd),
                "prompt": convert_prompt_encoder(sd, prefix="prompt_encoder"),
                "decoder": convert_mask_decoder(sd, prefix="mask_decoder",
                                                obj_token=False)}
    return {"trunk": convert_hiera(sd), "neck": convert_neck(sd),
            "prompt": convert_prompt_encoder(sd),
            "decoder": convert_mask_decoder(sd)}


def load_sam_checkpoint(encoder: str, ckpt_path: str, device="cuda"):
    """An official SAM / SAM2 checkpoint as a ``SAMModel`` on ``device``
    (``raw.get("model", raw)``, then :func:`convert_sam_state_dict`)."""
    import torch

    from .sam.model import SAMConfig, SAMModel

    raw = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = raw.get("model", raw) if isinstance(raw, dict) else raw
    # SAMConfig(encoder=encoder) as the reference builds it: the config's
    # image_size does not reach a loaded model, which runs at the default
    cfg = SAMConfig(encoder=encoder)
    return SAMModel.from_jax_params(cfg.encoder, cfg.image_size,
                                    convert_sam_state_dict(sd), device=device,
                                    compute_dtype=cfg.compute_dtype)
