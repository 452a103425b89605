"""Mask decoder (port of ``ovo_tpu/models/sam/decoder.py``): the two-way
transformer, the upscaling chain and the hypernetwork heads; every prompt of
a keyframe decodes in one batched pass.

The two-way transformer takes the reference's projection-fused route: the
token self-attention runs through kernel B2, token -> image attention and
the final attention through kernel B3 (``cross_t2i_from_keys``), and image
-> token attention with its out-projection, keys residual and norm4 through
kernel B4 (``cross_i2t_tail_from_keys``). The image side enters with batch
1: the first layer reads the shared image embedding through a batch stride
of 0, and the keys become per prompt at the first norm4. The reference's
other routes (``_img_side_proj``, ``_attn_core``, ``_i2t_proj``,
``_norm4``) lead to kernels B7-B9 and are not on this path.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ...ops.attention import (cross_i2t_tail_from_keys, cross_t2i_from_keys,
                              dot_product_attention)
from ..layers import gelu
from .hiera import lin, mlp, norm
from .params import Init

Params = Dict[str, Any]

NUM_MASK_TOKENS = 4  # 1 single-mask + 3 multimask outputs


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_attn(init: Init, d: int, internal: int) -> Params:
    return {"q": init.linear(d, internal), "k": init.linear(d, internal),
            "v": init.linear(d, internal), "out": init.linear(internal, d)}


def _init_twoway_layer(init: Init, d: int, mlp_dim: int) -> Params:
    return {
        "self_attn": _init_attn(init, d, d),
        "norm1": init.layer_norm(d),
        "cross_t2i": _init_attn(init, d, d // 2),
        "norm2": init.layer_norm(d),
        "mlp": {"fc": init.linear(d, mlp_dim),
                "proj": init.linear(mlp_dim, d)},
        "norm3": init.layer_norm(d),
        "cross_i2t": _init_attn(init, d, d // 2),
        "norm4": init.layer_norm(d),
    }


def _init_mlp3(init: Init, d: int, d_out: int) -> Params:
    return {"l0": init.linear(d, d), "l1": init.linear(d, d),
            "l2": init.linear(d, d_out)}


def init_mask_decoder(init: Init, d: int = 256, depth: int = 2,
                      mlp_dim: int = 2048) -> Params:
    """The SAM2 decoder: object-score token and head, high-res skip convs."""
    up1, up2 = d // 4, d // 8
    return {
        "iou_token": init.normal((d,), 0.02),
        "mask_tokens": init.normal((NUM_MASK_TOKENS, d), 0.02),
        "layers": [_init_twoway_layer(init, d, mlp_dim)
                   for _ in range(depth)],
        "final_attn": _init_attn(init, d, d // 2),
        "norm_final": init.layer_norm(d),
        "upscale1": {"w": init.normal((2, 2, d, up1), 0.02),
                     "b": init.zeros(up1)},
        "upscale_ln": init.layer_norm(up1),
        "upscale2": {"w": init.normal((2, 2, up1, up2), 0.02),
                     "b": init.zeros(up2)},
        "hyper_mlps": [_init_mlp3(init, d, up2)
                       for _ in range(NUM_MASK_TOKENS)],
        "iou_head": _init_mlp3(init, d, NUM_MASK_TOKENS),
        "obj_score_token": init.normal((d,), 0.02),
        "obj_head": _init_mlp3(init, d, 1),
        "conv_s0": {"w": init.normal((1, 1, d, up2), 0.05),
                    "b": init.zeros(up2)},
        "conv_s1": {"w": init.normal((1, 1, d, up1), 0.05),
                    "b": init.zeros(up1)},
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _self_attn(p: Params, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               heads: int) -> torch.Tensor:
    """Token self-attention (B, T, d) through kernel B2."""
    qq, kk, vv = lin(p["q"], q), lin(p["k"], k), lin(p["v"], v)
    B, T, internal = qq.shape
    hd = internal // heads

    def split(t):
        return t.reshape(B, T, heads, hd).transpose(1, 2)

    o = dot_product_attention(split(qq), split(kk), split(vv))
    return lin(p["out"], o.transpose(1, 2).reshape(B, T, internal))


def _t2i_proj(t2i: Params, q: torch.Tensor, keys: torch.Tensor,
              image_pe: torch.Tensor, heads: int) -> torch.Tensor:
    """Token -> image cross attention, image-side projections in kernel B3:
    pe_k = image_pe Wk + bk is the batch-1 correction ((keys + pe) Wk + bk
    == keys Wk + pe_k)."""
    di = t2i["k"]["w"].shape[1]
    pe_k = lin(t2i["k"], image_pe)
    bv = t2i["v"].get("b")
    if bv is None:
        bv = torch.zeros(di, device=q.device)
    o = cross_t2i_from_keys(lin(t2i["q"], q), keys, t2i["k"]["w"],
                            t2i["v"]["w"], pe_k, bv, heads)
    return lin(t2i["out"], o)


def _i2t_tail(i2t: Params, norm4: Params, q: torch.Tensor,
              queries: torch.Tensor, keys: torch.Tensor,
              image_pe: torch.Tensor, heads: int) -> torch.Tensor:
    """The whole image-side update in kernel B4: image -> token attention,
    out-projection, keys residual and norm4. Returns the next keys."""
    pe_q = lin(i2t["q"], image_pe)
    bout = i2t["out"].get("b")
    if bout is None:
        bout = torch.zeros(keys.shape[-1], device=keys.device)
    return cross_i2t_tail_from_keys(
        keys, i2t["q"]["w"], pe_q, lin(i2t["k"], q), lin(i2t["v"], queries),
        i2t["out"]["w"], bout, norm4["scale"], norm4["bias"], heads)


def _mlp3(p: Params, x: torch.Tensor, sigmoid_out: bool = False
          ) -> torch.Tensor:
    x = torch.relu(lin(p["l0"], x))
    x = torch.relu(lin(p["l1"], x))
    x = lin(p["l2"], x)
    return torch.sigmoid(x) if sigmoid_out else x


def two_way_transformer(params: Params, tokens: torch.Tensor,
                        image: torch.Tensor, image_pe: torch.Tensor,
                        heads: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, T, d) queries; image (1 or B, L, d) keys; image_pe
    (1, L, d). Returns (tokens, image) after the two-way layers and the final
    token -> image attention."""
    q_pe = tokens  # the token embeddings double as their positional code
    queries, keys = tokens, image
    for i, layer in enumerate(params["layers"]):
        if i == 0:
            # skip_first_layer_pe: the first self-attention REPLACES the
            # queries, no residual
            queries = _self_attn(layer["self_attn"], queries, queries,
                                 queries, heads)
        else:
            q = queries + q_pe
            queries = queries + _self_attn(layer["self_attn"], q, q, queries,
                                           heads)
        queries = norm(layer["norm1"], queries)
        q = queries + q_pe
        attn_out = _t2i_proj(layer["cross_t2i"], q, keys, image_pe, heads)
        queries = norm(layer["norm2"], queries + attn_out)
        queries = norm(layer["norm3"],
                       queries + mlp(layer["mlp"], queries, act=torch.relu))
        # q is recomputed from the post-MLP queries (the two-way block)
        q = queries + q_pe
        keys = _i2t_tail(layer["cross_i2t"], layer["norm4"], q, queries,
                         keys, image_pe, heads)
    q = queries + q_pe
    attn_out = _t2i_proj(params["final_attn"], q, keys, image_pe, heads)
    queries = norm(params["norm_final"], queries + attn_out)
    return queries, keys


def _up_blocked(p: Params, x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 transposed conv without its depth-to-space: rows
    (..., Cin) -> (..., 2, 2, Cout), (i, j) indexing the output block of
    each input pixel."""
    w = p["w"].to(x.dtype)                         # (2, 2, Cin, Cout)
    Cin, Cout = w.shape[2], w.shape[3]
    wm = w.permute(2, 0, 1, 3).reshape(Cin, 4 * Cout)
    lead = tuple(x.shape[:-1])
    y = (x.reshape(-1, Cin) @ wm).reshape(lead + (2, 2, Cout))
    return y + p["b"].to(x.dtype)


def decode_masks(params: Params, image_embed: torch.Tensor,
                 image_pe: torch.Tensor, sparse_prompts: torch.Tensor,
                 high_res_feats: Optional[List[torch.Tensor]] = None,
                 heads: int = 8,
                 mask_channels: Optional[Tuple[int, ...]] = None,
                 top_prompts: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One batched decoding pass.

    image_embed (H, W, d) shared stride-16 embedding; image_pe (H, W, d);
    sparse_prompts (B, Np, d); high_res_feats [(4H, 4W, up2), (2H, 2W,
    up1)]; mask_channels: the mask tokens to rasterize (AMG: (1, 2, 3));
    top_prompts: when set (< B), only the top_prompts prompts by max-channel
    predicted IoU pay the upscale tail, in ascending prompt order (exactly
    the ungated output restricted to them, ``prompt_sel``).

    Returns {"masks": (B', C, 4H, 4W) f32 logits, "iou": (B', C),
    "obj_score": (B',), "prompt_sel": (B',)}."""
    B = sparse_prompts.shape[0]
    H, W, d = image_embed.shape
    cdtype = image_embed.dtype
    prefix = torch.cat([params["obj_score_token"][None],
                        params["iou_token"][None], params["mask_tokens"]],
                       dim=0).to(cdtype)                     # (6, d)
    tokens = torch.cat([prefix.expand(B, -1, d), sparse_prompts.to(cdtype)],
                       dim=1)
    # the image side enters batch-1: the first layer reads it once
    src = image_embed.reshape(1, H * W, d)
    pe = image_pe.reshape(1, H * W, d).to(cdtype)
    queries, keys = two_way_transformer(params, tokens, src, pe, heads)

    obj_token = queries[:, 0]
    iou_token = queries[:, 1]
    mask_tokens = queries[:, 2:2 + NUM_MASK_TOKENS]
    chans = (tuple(range(NUM_MASK_TOKENS)) if mask_channels is None
             else tuple(mask_channels))
    iou_head = _mlp3(params["iou_head"], iou_token, sigmoid_out=True)
    # column picks, not a list index: that would upload the index list
    iou_all = torch.stack([iou_head[:, c] for c in chans], dim=1)  # (B, C)
    prompt_sel = torch.arange(B, device=tokens.device)
    if top_prompts is not None and top_prompts < B:
        gate = iou_all.amax(dim=1)
        prompt_sel = torch.sort(torch.argsort(-gate, stable=True)
                                [:top_prompts]).values
        keys = keys[prompt_sel]
        mask_tokens = mask_tokens[prompt_sel]
        obj_token = obj_token[prompt_sel]
        iou_all = iou_all[prompt_sel]
        B = top_prompts

    # upscale chain in the blocked layout; one relayout to raster order
    up = _up_blocked(params["upscale1"], keys.reshape(B, H, W, d))
    if high_res_feats is not None:
        hr1 = high_res_feats[1]                     # (2H, 2W, up1) raster
        up = up + hr1.reshape(H, 2, W, 2, -1).permute(0, 2, 1, 3, 4)[None]
    up = gelu(norm(params["upscale_ln"], up))
    hyper = torch.stack([_mlp3(params["hyper_mlps"][i], mask_tokens[:, i])
                         for i in chans], dim=1)       # (B, C, up2)
    up = _up_blocked(params["upscale2"], up)   # (B, H, W, 2, 2, 2, 2, up2)
    if high_res_feats is not None:
        hr0 = high_res_feats[0]                     # (4H, 4W, up2) raster
        up = up + hr0.reshape(H, 2, 2, W, 2, 2, -1).permute(
            0, 3, 1, 4, 2, 5, 6)[None]
    up = gelu(up)
    up = up.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(B, 4 * H, 4 * W, -1)
    # f32 products and sums, as the reference's preferred_element_type: the
    # logits meet thresholds at 0 and +-1
    masks = torch.einsum("bkc,bhwc->bkhw", hyper.float(), up.float())
    obj = _mlp3(params["obj_head"], obj_token)[:, 0]
    return {"masks": masks, "iou": iou_all, "obj_score": obj,
            "prompt_sel": prompt_sel}
