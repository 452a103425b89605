"""Mask decoder (port of ``ovo_tpu/models/sam/decoder.py``): the two-way
transformer, the upscaling chain and the hypernetwork heads; every prompt of
a keyframe decodes in one batched pass.

The token self-attention runs through kernel B2. The cross attentions take
one of the reference's three routes, chosen by its own predicates
(``ops/decoder_route.decoder_route``; the routes round differently in
bf16, so the port runs the reference's route at every configuration):

  - ``"proj_tail"`` (SAM2 at 1024^2 in bf16): token -> image attention and
    the final attention through kernel B3 (``cross_t2i_from_keys``), image
    -> token attention with its out-projection, keys residual and norm4
    through kernel B4 (``cross_i2t_tail_from_keys``);
  - ``"proj"`` (reached by no shape of a SAM decoder; driven by name): t2i
    through B3, image -> token attention through kernel B7
    (``cross_i2t_from_keys``), norm4 through kernel B8
    (``residual_layer_norm``);
  - ``"unfused"`` (1280^2, or any f32 decoder): the image side projected
    with plain matmuls (``_img_side_proj``), token <-> image attention
    through kernels B9a / B9b (``cross_attention_small_head``, in
    ``_attn_core``), norm4 through B8.

The image side enters with batch 1: the first layer reads the shared image
embedding through a batch stride of 0, and the keys become per prompt at
the first norm4.

The mask tail (second upscale, high-res skip, gelu, hypernet dot) takes the
reference's route, PyTorch ops (``mask_tail="unfused"``), or, by name,
kernel B13 (``mask_tail="fused"``, ``ops/mask_tail.fused_mask_tail``; bf16
decoders only: the reference defines that tail in bf16, with its tanh-gelu
rounded op by op).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ...ops.attention import (cross_attention_small_head, cross_i2t_from_keys,
                              cross_i2t_tail_from_keys, cross_t2i_from_keys,
                              dot_product_attention)
from ...ops.decoder_route import ROUTES, decoder_route
from ...ops.layer_norm import residual_layer_norm
from ...ops.mask_tail import (fused_mask_tail, gather_hr0q,
                              mask_tail_to_raster)
from ..layers import gelu
from .hiera import lin, mlp, norm
from .params import Init

Params = Dict[str, Any]

NUM_MASK_TOKENS = 4  # 1 single-mask + 3 multimask outputs
MASK_TAILS = ("unfused", "fused")


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
                      mlp_dim: int = 2048, high_res: bool = True,
                      obj_token: bool = True) -> Params:
    """The SAM2 decoder (object-score token and head, high-res skip convs);
    ``high_res=False, obj_token=False``: the SAM1 decoder, without them."""
    up1, up2 = d // 4, d // 8
    p = {
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
    }
    if obj_token:
        p["obj_score_token"] = init.normal((d,), 0.02)
        p["obj_head"] = _init_mlp3(init, d, 1)
    if high_res:
        p["conv_s0"] = {"w": init.normal((1, 1, d, up2), 0.05),
                        "b": init.zeros(up2)}
        p["conv_s1"] = {"w": init.normal((1, 1, d, up1), 0.05),
                        "b": init.zeros(up1)}
    return p


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


def _attn_core(p_out: Params, qq: torch.Tensor, kk: torch.Tensor,
               vv: torch.Tensor, heads: int) -> torch.Tensor:
    """Attention on pre-projected operands (batch B or 1) and its
    out-projection: token <-> image through kernels B9a / B9b, two short
    sides through :func:`dot_product_attention`."""
    B = max(qq.shape[0], kk.shape[0])
    Lq, Lk, internal = qq.shape[1], kk.shape[1], qq.shape[-1]
    if (Lq <= 64) != (Lk <= 64):
        return lin(p_out, cross_attention_small_head(qq, kk, vv, heads))
    hd = internal // heads

    def heads_of(t, n):
        return t.reshape(t.shape[0], n, heads, hd).transpose(1, 2).expand(
            B, heads, n, hd)

    o = dot_product_attention(heads_of(qq, Lq), heads_of(kk, Lk),
                              heads_of(vv, Lk))
    return lin(p_out, o.transpose(1, 2).reshape(B, Lq, internal))


def _img_side_proj(t2i: Params, keys: torch.Tensor, image_pe: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unfused route's image-side kk / vv for t2i: (keys + pe) Wk + bk
    == keys Wk + (pe Wk + bk), so the big matmuls run on the raw keys and
    the positional term stays batch 1."""
    kk = keys @ t2i["k"]["w"].to(keys.dtype) + lin(t2i["k"], image_pe)
    vv = keys @ t2i["v"]["w"].to(keys.dtype)
    if t2i["v"].get("b") is not None:
        vv = vv + t2i["v"]["b"].to(vv.dtype)
    return kk, vv


def _t2i_unfused(t2i: Params, q: torch.Tensor, keys: torch.Tensor,
                 image_pe: torch.Tensor, heads: int) -> torch.Tensor:
    kk, vv = _img_side_proj(t2i, keys, image_pe)
    return _attn_core(t2i["out"], lin(t2i["q"], q), kk, vv, heads)


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


def _i2t_proj(i2t: Params, q: torch.Tensor, queries: torch.Tensor,
              keys: torch.Tensor, image_pe: torch.Tensor, heads: int
              ) -> torch.Tensor:
    """Image -> token cross attention with the image-side qq in kernel B7,
    then the out-projection."""
    pe_q = lin(i2t["q"], image_pe)
    o = cross_i2t_from_keys(keys, i2t["q"]["w"], pe_q, lin(i2t["k"], q),
                            lin(i2t["v"], queries), heads)
    return lin(i2t["out"], o)


def _i2t_unfused(i2t: Params, q: torch.Tensor, queries: torch.Tensor,
                 keys: torch.Tensor, image_pe: torch.Tensor, heads: int
                 ) -> torch.Tensor:
    qq = keys @ i2t["q"]["w"].to(keys.dtype) + lin(i2t["q"], image_pe)
    return _attn_core(i2t["out"], qq, lin(i2t["k"], q), lin(i2t["v"], queries),
                      heads)


def _norm4(p: Params, attn_out: torch.Tensor, keys: torch.Tensor
           ) -> torch.Tensor:
    """The image-side residual + LayerNorm through kernel B8; a batch-1
    keys residual (first layer) is read, never broadcast in memory."""
    return residual_layer_norm(attn_out, keys, p["scale"], p["bias"])


def _mlp3(p: Params, x: torch.Tensor, sigmoid_out: bool = False
          ) -> torch.Tensor:
    x = torch.relu(lin(p["l0"], x))
    x = torch.relu(lin(p["l1"], x))
    x = lin(p["l2"], x)
    return torch.sigmoid(x) if sigmoid_out else x


def two_way_transformer(params: Params, tokens: torch.Tensor,
                        image: torch.Tensor, image_pe: torch.Tensor,
                        heads: int = 8, *, route: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, T, d) queries; image (1 or B, L, d) keys; image_pe
    (1, L, d). Returns (tokens, image) after the two-way layers and the final
    token -> image attention. ``route`` (one of ``ROUTES``) forces a route;
    by default :func:`decoder_route` picks the reference's."""
    if route is None:
        di = params["layers"][0]["cross_t2i"]["k"]["w"].shape[1]
        route = decoder_route(tokens.shape[1], image.shape[1], di,
                              image.shape[-1], heads,
                              tokens.dtype.itemsize)
    if route not in ROUTES:
        raise ValueError(f"route {route!r} is not one of {ROUTES}")
    t2i = _t2i_unfused if route == "unfused" else _t2i_proj
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
        attn_out = t2i(layer["cross_t2i"], q, keys, image_pe, heads)
        queries = norm(layer["norm2"], queries + attn_out)
        queries = norm(layer["norm3"],
                       queries + mlp(layer["mlp"], queries, act=torch.relu))
        # q is recomputed from the post-MLP queries (the two-way block)
        q = queries + q_pe
        if route == "proj_tail":
            keys = _i2t_tail(layer["cross_i2t"], layer["norm4"], q, queries,
                             keys, image_pe, heads)
        else:
            i2t = _i2t_unfused if route == "unfused" else _i2t_proj
            attn_out = i2t(layer["cross_i2t"], q, queries, keys, image_pe,
                           heads)
            keys = _norm4(layer["norm4"], attn_out, keys)
    q = queries + q_pe
    attn_out = t2i(params["final_attn"], q, keys, image_pe, heads)
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
                 top_prompts: Optional[int] = None, *,
                 route: Optional[str] = None,
                 mask_tail: str = "unfused") -> Dict[str, torch.Tensor]:
    """One batched decoding pass.

    image_embed (H, W, d) shared stride-16 embedding; image_pe (H, W, d);
    sparse_prompts (B, Np, d); high_res_feats [(4H, 4W, up2), (2H, 2W,
    up1)]; mask_channels: the mask tokens to rasterize (AMG: (1, 2, 3));
    top_prompts: when set (< B), only the top_prompts prompts by max-channel
    predicted IoU pay the upscale tail, in ascending prompt order (exactly
    the ungated output restricted to them, ``prompt_sel``); route: the
    two-way transformer's route (default: the reference's choice);
    mask_tail: ``"unfused"`` (the reference's PyTorch ops) or ``"fused"``
    (kernel B13, bf16 decoders with high-res features only).

    A decoder without ``obj_score_token`` (SAM1) runs 7 tokens (IoU, 4
    mask tokens, the point, the pad point) and gives ``obj_score`` zeros.

    Returns {"masks": (B', C, 4H, 4W) f32 logits, "iou": (B', C),
    "obj_score": (B',), "prompt_sel": (B',)}."""
    B = sparse_prompts.shape[0]
    H, W, d = image_embed.shape
    cdtype = image_embed.dtype
    if mask_tail not in MASK_TAILS:
        raise ValueError(f"mask_tail {mask_tail!r} is not one of "
                         f"{MASK_TAILS}")
    if mask_tail == "fused" and (cdtype != torch.bfloat16
                                 or high_res_feats is None):
        raise ValueError(f"mask_tail='fused' takes a bf16 decoder with "
                         f"high-res features; got {cdtype}, high_res_feats "
                         f"{'absent' if high_res_feats is None else 'set'}")
    # the SAM1 decoder has no object-score token: IoU + 4 mask tokens
    has_obj = "obj_score_token" in params
    head = [params["obj_score_token"][None]] if has_obj else []
    prefix = torch.cat(head + [params["iou_token"][None],
                               params["mask_tokens"]],
                       dim=0).to(cdtype)                     # (5 or 6, d)
    tokens = torch.cat([prefix.expand(B, -1, d), sparse_prompts.to(cdtype)],
                       dim=1)
    # the image side enters batch-1: the first layer reads it once
    src = image_embed.reshape(1, H * W, d)
    pe = image_pe.reshape(1, H * W, d).to(cdtype)
    queries, keys = two_way_transformer(params, tokens, src, pe, heads,
                                        route=route)

    off = 1 if has_obj else 0
    obj_token = queries[:, 0] if has_obj else None
    iou_token = queries[:, off]
    mask_tokens = queries[:, off + 1:off + 1 + NUM_MASK_TOKENS]
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
        if obj_token is not None:
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
    if mask_tail == "fused":
        # up (B, H, W, 2, 2, c1) is already (B, H*W*4, c1) in (h, w, i, j)
        # row order
        p2 = params["upscale2"]
        c1, c2 = p2["w"].shape[2], p2["w"].shape[3]
        masks = mask_tail_to_raster(fused_mask_tail(
            up.reshape(B, H * W * 4, c1),
            p2["w"].to(cdtype).reshape(4, c1, c2).contiguous(),
            p2["b"].to(cdtype), gather_hr0q(high_res_feats[0], H, W),
            hyper, H=H, W=W), H, W)
    else:
        up = _up_blocked(params["upscale2"], up)  # (B, H, W, 2, 2, 2, 2, up2)
        if high_res_feats is not None:
            hr0 = high_res_feats[0]                 # (4H, 4W, up2) raster
            up = up + hr0.reshape(H, 2, 2, W, 2, 2, -1).permute(
                0, 3, 1, 4, 2, 5, 6)[None]
        up = gelu(up)
        up = up.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(B, 4 * H, 4 * W, -1)
        # f32 products and sums, as the reference's preferred_element_type:
        # the logits meet thresholds at 0 and +-1
        masks = torch.einsum("bkc,bhwc->bkhw", hyper.float(), up.float())
    if obj_token is None:
        obj = torch.zeros(B, device=masks.device)    # SAM1: no object score
    else:
        oh = params["obj_head"]
        # a one-linear head: the legacy layout convert_sam falls back to
        obj = (_mlp3(oh, obj_token) if "l0" in oh
               else lin(oh, obj_token))[:, 0]
    return {"masks": masks, "iou": iou_all, "obj_score": obj,
            "prompt_sel": prompt_sel}
