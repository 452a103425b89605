"""Kernel B10 (fused_attention) of the PyTorch port and the routing of its
self-attention.

B10's plain version against the JAX package's Pallas ``fused_attention`` run
in interpret mode on the CPU: f32 at 1e-5 abs (same math, another summation
order), bf16 at 1e-2 (both sides round p to bf16, so a weight on a rounding
edge can move the output one bf16 step, 2^-8 at |out| < 1), with and
without a ``kv_len`` key mask. The CUDA kernel is held against this plain
version in ``tests/test_torch_cuda_kernels.py``, on the card.

``attention_route`` against ``select_attention_route`` on every attention
shape the real-size programs dispatch (captured with ``jax.eval_shape``):
Hiera-L automatic masks at 1024^2 with the SAM2 decoder, PE-Core-L14-336
TextRegion and its causal text tower, the SigLIP-384 crop embedder (global
view and 96 crops), its text tower, ViT-H-14 and its text tower, and the
learned merger.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ovo_tpu.ops.attention as jatt
from ovo_tpu.ops.attention import fused_attention as jax_fused

from ovo_tpu_torch.ops import attention as A
from ovo_tpu_torch.ops import cuda_build

H, W, M_MASKS = 680, 1200, 96


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
@pytest.mark.parametrize("shape,kv_len", [((2, 3, 264, 72), None),
                                          ((2, 3, 264, 72), 250),
                                          ((1, 2, 128, 16), 77)])
def test_fused_plain_matches_pallas(dtype, tol, shape, kv_len):
    q, k, v = _qkv(3, shape)
    jx = [jnp.asarray(a, dtype) for a in (q, k, v)]
    ref = np.asarray(jax_fused(*jx, kv_len=kv_len, interpret=True)
                     .astype(jnp.float32))
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jx]
    got = A.fused_attention(*tx, kv_len=kv_len)
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol)


def test_fused_takes_strided_head_views():
    """Head-split views of a packed (B, L, 3, H, hd) projection, as the
    towers hand them over, give what contiguous copies give."""
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal((2, 300, 3, 4, 72)).astype(
        np.float32))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    got = A.fused_attention(q, k, v)
    ref = A.fused_attention_plain(q.contiguous(), k.contiguous(),
                                  v.contiguous())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)


@pytest.mark.parametrize("hd,padded", [(40, 48), (20, 32), (33, 48)])
def test_fused_zero_columns_change_nothing(hd, padded):
    """B10 in bf16 pads a head size B2's device code is not built for with
    zero columns (``fused_attention`` on the card): the padded operands
    give the same first ``hd`` output columns, bit for bit, and zeros past
    them."""
    assert padded == min(d for d in A.WINDOWED_HEAD_DIMS if d > hd)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(hd, (2, 3, 300, hd)))
    scale = hd ** -0.5
    ref = A.fused_attention_plain(q, k, v, scale=scale, kv_len=289)
    pq, pk, pv = (torch.nn.functional.pad(t, (0, padded - hd))
                  for t in (q, k, v))
    got = A.fused_attention_plain(pq, pk, pv, scale=scale, kv_len=289)
    assert torch.equal(got[..., :hd], ref)
    assert not got[..., hd:].float().any()


def test_dot_product_attention_routes_match_xla():
    """Every route of the port's dispatcher computes the reference's
    ``xla_attention``: B10, B2 and B1's plain versions, and the plain route
    for causal, masked and head-size-144 attention."""
    from ovo_tpu.ops.attention import xla_attention as jax_xla

    cases = [((1, 2, 300, 300, 72), False, None),    # fused
             ((2, 2, 64, 64, 72), False, None),      # windowed
             ((1, 1, 1100, 1100, 16), False, None),  # flash
             ((2, 3, 32, 32, 64), True, None),       # causal
             ((4, 8, 3, 3, 144), False, None),       # the merger
             ((2, 2, 40, 40, 32), False, 30)]        # key mask
    for (b, h, lq, lk, d), causal, n_keys in cases:
        rng = np.random.default_rng(lq)
        q = rng.standard_normal((b, h, lq, d)).astype(np.float32)
        k, v = (rng.standard_normal((b, h, lk, d)).astype(np.float32)
                for _ in range(2))
        mask = None if n_keys is None else (np.arange(lk) < n_keys)[
            None, None, None, :]
        jmask = jnp.tril(jnp.ones((lq, lk), bool))[None, None] if causal \
            else (None if mask is None else jnp.asarray(mask))
        ref = np.asarray(jax_xla(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), mask=jmask))
        got = A.dot_product_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            mask=None if mask is None else torch.from_numpy(mask),
            causal=causal)
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def test_cpu_b10_counts_no_launch():
    cuda_build.reset_launch_counts()
    A.dot_product_attention(*(torch.zeros((1, 2, 260, 16)) for _ in range(3)))
    assert "fused_attention" in cuda_build.KERNELS
    assert cuda_build.launch_counts()["fused_attention"] == 0


# ---------------------------------------------------------------------------
# routing against select_attention_route on every real-size shape
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dispatched_shapes():
    """(program, bh, lq, lk, d, itemsize, causal, has_mask) of every
    ``dot_product_attention`` call of the real-size programs, abstract
    params, no FLOPs."""
    from ovo_tpu.models import merger as jmerger
    from ovo_tpu.models import text as jtext
    from ovo_tpu.models import vit as jvit
    from ovo_tpu.models.clip import MODEL_REGISTRY
    from ovo_tpu.models.sam.amg import _amg_program, grid_points
    from ovo_tpu.models.sam.model import SAMConfig, SAMModel
    from ovo_tpu.models.textregion import _textregion_program

    recorded = []
    orig = jatt.select_attention_route
    program = ["?"]

    def recorder(bh, lq, lk, d, itemsize, **kw):
        recorded.append((program[0], bh, lq, lk, d, itemsize,
                         kw.get("causal", False), kw.get("has_mask", False)))
        return orig(bh, lq, lk, d, itemsize, **kw)

    def bf16(tree):
        return jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32
            else x, tree)

    key = jax.random.PRNGKey(0)
    img = jax.ShapeDtypeStruct((H, W, 3), jnp.float32)
    # a jitted program traced before (by the reference's dispatch test, in
    # the same process) would skip the recorder: start and end uncached
    jax.clear_caches()
    jatt.select_attention_route = recorder
    try:
        program[0] = "sam2"
        sam_abs = jax.eval_shape(lambda: bf16(SAMModel.random_init(
            "hiera_l", image_size=1024).params))
        amg_kw = dict(pred_iou_thresh=0.0, stability_thresh=0.0,
                      stability_offset=1.0, mask_threshold=0.0,
                      box_nms_thresh=0.7, nms_iou_th=0.8, nms_score_th=0.0,
                      nms_inner_th=0.5, max_masks=M_MASKS, candidates=256,
                      min_area=0, out_hw=(H, W))
        jax.eval_shape(lambda p, im, pts: _amg_program(
            p, SAMConfig(encoder="hiera_l", image_size=1024), im, pts,
            **amg_kw), sam_abs, img, jnp.asarray(grid_points(16)))

        pe = MODEL_REGISTRY["PE-Core-L14-336"]
        pe_abs = jax.eval_shape(lambda: bf16({
            "visual": jvit.init_vit(key, pe.vision),
            "text": jtext.init_text(key, pe.text)}))
        cs = pe.vision.image_size
        program[0] = "pe_textregion"
        jax.eval_shape(lambda p, im, ms: _textregion_program(
            p, pe.vision, im, ms, mean=jnp.zeros(3), std=jnp.ones(3),
            crop_size=cs, patch_size=pe.vision.patch_size,
            crop_num_h=max(H // cs, 1), crop_num_w=max(W // cs, 1),
            remove_global=True, gp_threshold=0.07, project=True),
            pe_abs, img, jax.ShapeDtypeStruct((M_MASKS, H, W), jnp.bool_))

        def towers(card, batches):
            c = MODEL_REGISTRY[card]
            p = jax.eval_shape(lambda: {
                "visual": jvit.init_vit(key, c.vision),
                "text": jtext.init_text(key, c.text)})
            s = c.vision.image_size
            for b in batches:
                program[0] = f"{card}_image_b{b}"
                jax.eval_shape(lambda pp, x: jvit.encode(pp, c.vision, x),
                               p["visual"],
                               jax.ShapeDtypeStruct((b, s, s, 3),
                                                    jnp.float32))
            program[0] = f"{card}_text"
            jax.eval_shape(lambda pp, t: jtext.encode_text(pp, c.text, t),
                           p["text"], jax.ShapeDtypeStruct(
                               (1, c.text.context_length), jnp.int32))

        program[0] = "pe_text"
        jax.eval_shape(lambda p, t: jtext.encode_text(p, pe.text, t),
                       pe_abs["text"],
                       jax.ShapeDtypeStruct((8, pe.text.context_length),
                                            jnp.int32))
        towers("SigLIP-384", (1, M_MASKS))
        towers("ViT-H-14", (1,))
        program[0] = "merger"
        jax.eval_shape(lambda p, x: jmerger.merger_apply(p, x),
                       jax.eval_shape(lambda: jmerger.init_merger(key)),
                       jax.ShapeDtypeStruct((M_MASKS, 3, 1152), jnp.float32))
    finally:
        jatt.select_attention_route = orig
        jax.clear_caches()
    return sorted(set(recorded))


def _old_rule(lq, lk):
    """The port's route for unmasked non-causal attention before B10."""
    return "windowed" if max(lq, lk) <= 512 else "flash"


def test_routes_follow_select_attention_route(dispatched_shapes):
    programs = {s[0] for s in dispatched_shapes}
    assert {"sam2", "pe_textregion", "pe_text", "SigLIP-384_image_b1",
            "SigLIP-384_image_b96", "SigLIP-384_text", "ViT-H-14_image_b1",
            "ViT-H-14_text", "merger"} <= programs, programs
    seen = set()
    for prog, bh, lq, lk, d, it, causal, mask in dispatched_shapes:
        ours = A.attention_route(lq, lk, d, causal=causal, has_mask=mask)
        jax_route = jatt.select_attention_route(
            bh, lq, lk, d, it, causal=causal, has_mask=mask, on_tpu=True)
        label = (prog, bh, lq, lk, d, it, causal, mask, jax_route, ours)
        seen.add((prog, ours))
        if causal or mask or d > 128:
            # the reference has no Pallas kernel here either
            assert ours == "xla" and jax_route == "xla", label
        elif lq == lk and 256 <= lq <= 1024:
            # B10 at any batch; the reference takes it too unless its TPU
            # grid gate (bh <= 512) or its VMEM model refuses the shape
            assert ours == "fused", label
            assert jax_route == "fused" or bh > 512 or jatt.fused_vmem_bytes(
                -(-lq // 8) * 8, -(-lk // 8) * 8, d, it) > jatt._VMEM_BUDGET, \
                label
        else:
            assert ours == _old_rule(lq, lk), label
            assert {"winfused": "windowed", "flash": "flash"}.get(
                jax_route, ours) == ours, label
    # Hiera and the SAM2 decoder keep B2 / B1; the SigLIP-384 tower (global
    # view and crops), ViT-H-14 and PE's 577 tokens take B10; SigLIP's text
    # tower B2; causal text towers and the merger the plain route
    assert {r for p, r in seen if p == "sam2"} == {"windowed", "flash"}
    for prog in ("SigLIP-384_image_b1", "SigLIP-384_image_b96",
                 "ViT-H-14_image_b1", "pe_textregion"):
        assert {r for p, r in seen if p == prog} == {"fused"}, prog
    assert {r for p, r in seen if p == "SigLIP-384_text"} == {"windowed"}
    for prog in ("pe_text", "ViT-H-14_text", "merger"):
        assert {r for p, r in seen if p == prog} == {"xla"}, prog
