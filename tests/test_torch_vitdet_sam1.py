"""The SAM1 tier of the PyTorch port against the JAX package, one test per
scenario of ``tests/test_vitdet_sam1.py``, in f32 on the CPU (and the
trunk's attention and one SAM1 decode in bf16), with the JAX random weights
carried across by ``ovo_tpu_torch.models.convert_jax``:

  - ``vitdet_forward`` on ``vit_test`` (window 6 pads the 16-token grid to
    18; at 192 px the position embedding is resized and the global block's
    rel-pos tables interpolated) to 2e-4;
  - the rel-pos table interpolation;
  - in bf16, each trunk block's attention on the reference forward's own
    input (its rounding points, against planted variants), and the SAM1
    decode;
  - the SAM1 decoder's 7-token layout through each route of the two-way
    transformer, and its prompt gate;
  - the preprocess geometry (ResizeLongestSide + pad) and ``point_scale``;
  - the AMG program on a non-square frame (valid sets equal, seg maps equal
    but for < 0.1% of pixels: the tie rule of ``test_torch_sam.py``), the
    small-region host pass included;
  - the upsample reading the raw boundary logits through the composed
    matrices, and ``min_area`` in logit cells;
  - the factory: SAM1 defaults, and a present ``sam_vit_test.pth`` through
    both packages' ``build_sam_mask_source``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovo_tpu.models.sam import amg as jamg
from ovo_tpu.models.sam import model as jmodel
from ovo_tpu.models.sam.decoder import decode_masks as jax_decode_masks
from ovo_tpu.models.sam.model import SAMConfig as JaxSAMConfig
from ovo_tpu.models.sam.model import SAMModel as JaxSAM
from ovo_tpu.models.sam import vitdet as jvitdet

from ovo_tpu_torch.models.convert_jax import flatten_tree, load_jax_params
from ovo_tpu_torch.models.sam import amg as tamg
from ovo_tpu_torch.models.sam import decoder as tdec
from ovo_tpu_torch.models.sam import model as tmodel
from ovo_tpu_torch.models.sam import vitdet as tvitdet
from ovo_tpu_torch.models.sam.model import SAMModel
from ovo_tpu_torch.models.sam.params import Init, ParamTree
from ovo_tpu_torch.ops.decoder_route import ROUTES

from test_torch_sam import GATES_OFF, assert_masks_agree

ATOL = 2e-4


def t(x):
    return torch.from_numpy(np.array(x))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(image_size, seed=1):
    jm = JaxSAM.random_init("vit_test", image_size=image_size, seed=seed)
    jm = JaxSAM(JaxSAMConfig("vit_test", image_size,
                             compute_dtype="float32"), jm.params)
    tm = SAMModel.from_jax_params("vit_test", image_size, np_tree(jm.params),
                                  device="cpu", compute_dtype="float32")
    return jm, tm


@pytest.fixture(scope="module")
def sam256():
    return _models(256)


def _image(seed, h=96, w=128):
    return (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(
        np.uint8)


# ---------------------------------------------------------------------------
# the ViT-det trunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [256, 192])
def test_vitdet_forward_matches_jax(size):
    cfg = jvitdet.VITDET_CONFIGS["vit_test"]
    jp = jvitdet.init_vitdet(jax.random.PRNGKey(3), cfg)
    tp = load_jax_params(ParamTree(tvitdet.init_vitdet(
        Init(None, "cpu"), tvitdet.VITDET_CONFIGS["vit_test"])), np_tree(jp))
    img = np.random.default_rng(size).standard_normal(
        (1, size, size, 3)).astype(np.float32)
    ref = np.asarray(jvitdet.vitdet_forward(jp, cfg, jnp.asarray(img)))
    got = tvitdet.vitdet_forward(tp, tvitdet.VITDET_CONFIGS["vit_test"],
                                 t(img))
    assert tuple(got.shape) == ref.shape == (1, size // 16, size // 16, 256)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def test_vitdet_rel_pos_interpolation_matches_jax(rng):
    rel = rng.standard_normal((9, 8)).astype(np.float32)   # 2 * 7 - 1 = 13
    ref = np.asarray(jvitdet._rel_pos_table(jnp.asarray(rel), 7))
    got = tvitdet._rel_pos_table(t(rel), 7).numpy()
    assert got.shape == (7, 7, 8)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    same = rng.standard_normal((13, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        tvitdet._rel_pos_table(t(same), 7).numpy(),
        np.asarray(jvitdet._rel_pos_table(jnp.asarray(same), 7)))


# bf16: the trunk's attention rounding points (vitdet.py:150-171 of the
# reference): q times the bf16-rounded scale, exact f32 products of bf16
# operands for the scores and the rel-pos bias, the tables cast to q's
# dtype, an f32 softmax, p rounded before p . v. A whole bf16 forward is
# chaotic (one output a step off in block 0 moves most of the embedding:
# the port and the reference differ in 65% of its elements on the SAM1
# vit_test weights, a variant with p unrounded in 78%), so the trunk is held
# block by block: each block's attention on the very input the reference's
# forward gave it. The share of outputs that differ at all reads 0 at
# vit_test (dh 16) and up to 0.94% at ViT-H's head width (dh 80), where
# the two sides' f32 sums of the same exact products run in another order;
# the planted variants below read 42-59%.
BF16_SHARE = 0.02


def _bf16_step(ref):
    """One bf16 step at ref's largest magnitude (2^-7 of its binade)."""
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _attention_variant(p, x, heads, *, f32_scale=False, round_p=True):
    """The trunk's attention with one rounding point moved: the scale
    applied in f32 (unrounded), or p left in f32 before p . v."""
    B, H, W, C = x.shape
    dh = C // heads
    qkv = tvitdet.lin(p["qkv"], x.reshape(B, H * W, C)).reshape(
        B, H * W, 3, heads, dh)
    q, k, v = (qkv[:, :, i].transpose(1, 2).reshape(B * heads, H * W, dh)
               for i in range(3))
    if f32_scale:
        s = torch.matmul(q.float() * dh ** -0.5, k.float().transpose(1, 2))
    else:
        scale = torch.full((), dh ** -0.5, dtype=q.dtype)
        s = torch.matmul((q * scale).float(), k.float().transpose(1, 2))
    rh = tvitdet._rel_pos_table(p["rel_pos_h"], H).to(q.dtype).float()
    rw = tvitdet._rel_pos_table(p["rel_pos_w"], W).to(q.dtype).float()
    qs = q.reshape(B * heads, H, W, dh).float()
    s = s.view(B * heads, H, W, H, W) + (
        torch.einsum("bhwd,hkd->bhwk", qs, rh)[:, :, :, :, None]
        + torch.einsum("bhwd,wkd->bhwk", qs, rw)[:, :, :, None, :])
    pw = torch.softmax(s.reshape(B * heads, H * W, H * W), dim=-1)
    if round_p:
        pw = pw.to(v.dtype).float()
    o = torch.matmul(pw, v.float()).to(x.dtype)
    o = o.reshape(B, heads, H * W, dh).transpose(1, 2).reshape(B, H, W, C)
    return tvitdet.lin(p["proj"], o)


@pytest.mark.parametrize("width", [32, 160])
def test_vitdet_attention_bf16_matches_jax_at_each_block(width, monkeypatch):
    """vit_test (width 32, 2 heads of 16: a scale of 0.25, exact in bf16)
    and the same trunk at ViT-H's head width (160, 2 heads of 80: a scale
    bf16 rounds) in bf16 at 256 px: blocks 0-1 windowed (6 x 6 windows,
    the 16-token grid padded to 18), block 2 global. Each block's attention
    on the input the reference's forward gave it, against the reference's
    output: at most BF16_SHARE of the outputs differ, none by more than
    one bf16 step at the block's largest output (the output projection
    carries a step of its input to outputs near 0). A variant with p unrounded, and at ViT-H's head width one
    with the scale in f32, breaks the share."""
    cfg = dataclasses.replace(jvitdet.VITDET_CONFIGS["vit_test"],
                              embed_dim=width)
    tcfg = tvitdet.ViTDetConfig(**dataclasses.asdict(cfg))
    jp = jvitdet.init_vitdet(jax.random.PRNGKey(1), cfg)
    tp = load_jax_params(ParamTree(tvitdet.init_vitdet(Init(None, "cpu"),
                                                       tcfg)), np_tree(jp))
    calls = []
    jax_attention = jvitdet._attention

    def record(p, x, heads):
        out = jax_attention(p, x, heads)
        calls.append((x, out))
        return out

    monkeypatch.setattr(jvitdet, "_attention", record)
    img = np.random.default_rng(width).standard_normal((1, 256, 256, 3))
    jvitdet.vitdet_forward(jp, cfg, jnp.asarray(img, jnp.bfloat16))
    assert [tuple(x.shape) for x, _ in calls] == [
        (9, 6, 6, width), (9, 6, 6, width), (1, 16, 16, width)]

    def share(fn):
        worst = 0.0
        for i, (x, ref) in enumerate(calls):
            xt = t(x.astype(jnp.float32)).to(torch.bfloat16)
            got = fn(tp["blocks"][i]["attn"], xt, cfg.num_heads).float()
            ref = np.asarray(ref.astype(jnp.float32))
            d = np.abs(got.numpy() - ref)
            assert got.shape == xt.shape
            worst = max(worst, float((d > 0).mean()))
            if fn is tvitdet._attention:
                assert d.max() <= _bf16_step(ref), (i, d.max())
        return worst

    assert share(tvitdet._attention) <= BF16_SHARE
    assert share(functools.partial(_attention_variant, round_p=False)) \
        > BF16_SHARE
    f32_scale = share(functools.partial(_attention_variant, f32_scale=True))
    if width == 160:
        assert f32_scale > BF16_SHARE
    else:   # 0.25 is exact in bf16: the variant is the same function
        assert f32_scale <= BF16_SHARE


def test_vitdet_configs_and_tree_match_jax():
    for name, cfg in jvitdet.VITDET_CONFIGS.items():
        assert dataclasses.asdict(tvitdet.VITDET_CONFIGS[name]) == \
            dataclasses.asdict(cfg)
    jm = JaxSAM.random_init("vit_test", image_size=256)
    tm = SAMModel.random_init("vit_test", 256, device="cpu")
    assert {n for n, _ in tm.params.named_parameters()} == \
        {k for k, _ in flatten_tree(np_tree(jm.params))}
    assert tm.cfg.family == "sam1" and "neck" not in tm.params
    assert "obj_score_token" not in tm.params["decoder"]
    assert "conv_s0" not in tm.params["decoder"]


# ---------------------------------------------------------------------------
# the SAM1 decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
def test_sam1_decoder_token_layout_each_route_matches_jax(sam256, route):
    """IoU head on token 0, mask tokens 1-4, no object score (zeros), no
    high-res skips: a (16, 16, 256) embedding (L 256), 6 prompts of 2
    sparse tokens (7 tokens), f32, every route against the reference's XLA
    route on the CPU. Measured max |diff| 7.7e-7 on logits up to 0.70; the
    limit is 1.1e-5, what the SAM2 decoder's routes measure
    (test_torch_decoder_routes.py)."""
    jm, tm = sam256
    rng = np.random.default_rng(71)
    f = np.float32
    embed = rng.standard_normal((16, 16, 256)).astype(f)
    pe = rng.standard_normal((16, 16, 256)).astype(f)
    sparse = rng.standard_normal((6, 2, 256)).astype(f)
    ref = jax_decode_masks(jm.params["decoder"], jnp.asarray(embed),
                           jnp.asarray(pe), jnp.asarray(sparse),
                           mask_channels=(1, 2, 3))
    got = tdec.decode_masks(tm.params["decoder"], t(embed), t(pe), t(sparse),
                            mask_channels=(1, 2, 3), route=route)
    assert tuple(got["masks"].shape) == (6, 3, 64, 64)
    for key in ("masks", "iou", "obj_score"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=1.1e-5)
    np.testing.assert_array_equal(got["obj_score"].numpy(), np.zeros(6))


def test_sam1_decode_bf16_matches_jax():
    """The SAM1 model in bf16 (SAMConfig's default dtype), vit_test at 256
    on a 96 x 128 frame, 16 grid points. The decoder (7 tokens, no object
    token) on the reference's own bf16 embedding: logits and IoU within the
    decoder routes' bf16 limit (rtol 1e-2, atol 3e-2; measured max 7.5e-3
    and 3.9e-3). The whole model from the same preprocessed frame: the mask
    logits' signs agree on >= 99% (measured 99.7%). The bf16 trunk is
    chaotic (see BF16_SHARE), so this end-to-end limit holds the path
    together, not its rounding points: a variant with p unrounded reads
    99.6% too. The block-by-block test above holds those."""
    jm = JaxSAM.random_init("vit_test", image_size=256, seed=1)
    tm = SAMModel.from_jax_params("vit_test", 256, np_tree(jm.params),
                                  device="cpu", compute_dtype="bfloat16")
    assert jm.cfg.compute_dtype == "bfloat16"
    img = _image(6).astype(np.float32) / 255.0
    pts = np.random.default_rng(7).uniform(0.05, 0.95, (16, 2)).astype(
        np.float32)
    pre = jm.preprocess(jnp.asarray(img))
    ej, _ = jm.encode_image(pre)
    ref = jm.decode_grid(ej, None, jnp.asarray(pts), mask_channels=(1, 2, 3))
    emb = t(ej.astype(jnp.float32)).to(torch.bfloat16)
    got = tm.decode_grid(emb, None, t(pts), mask_channels=(1, 2, 3))
    assert tuple(got["masks"].shape) == (16, 3, 64, 64)
    for key in ("masks", "iou"):
        np.testing.assert_allclose(got[key].float().numpy(),
                                   np.asarray(ref[key], np.float32),
                                   rtol=1e-2, atol=3e-2)
    np.testing.assert_array_equal(got["obj_score"].float().numpy(),
                                  np.zeros(16))
    pre_t = t(pre.astype(jnp.float32)).to(torch.bfloat16)
    et, high_res = tm.encode_image(pre_t)
    assert high_res is None and et.dtype == torch.bfloat16
    whole = tm.decode_grid(et, None, t(pts), mask_channels=(1, 2, 3))
    agree = (whole["masks"].float().numpy() > 0) == (
        np.asarray(ref["masks"], np.float32) > 0)
    assert agree.mean() >= 0.99


def test_sam1_decoder_prompt_gate_matches_jax(sam256, rng):
    jm, tm = sam256
    emb = rng.standard_normal((16, 16, 256)).astype(np.float32)
    pts = rng.uniform(0.1, 0.9, (12, 2)).astype(np.float32)
    ref = jm.decode_grid(jnp.asarray(emb), None, jnp.asarray(pts),
                         mask_channels=(1, 2, 3), top_prompts=5)
    ours = tm.decode_grid(t(emb), None, t(pts), mask_channels=(1, 2, 3),
                          top_prompts=5)
    np.testing.assert_array_equal(ours["prompt_sel"].numpy(),
                                  np.asarray(ref["prompt_sel"]))
    np.testing.assert_allclose(ours["masks"].numpy(),
                               np.asarray(ref["masks"]), atol=ATOL)
    full = tm.decode_grid(t(emb), None, t(pts), mask_channels=(1, 2, 3))
    sel = ours["prompt_sel"]
    np.testing.assert_allclose(ours["masks"].numpy(),
                               full["masks"][sel].numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# preprocess, encoder, AMG
# ---------------------------------------------------------------------------

def test_sam1_preprocess_geometry_matches_jax(sam256):
    jm, tm = sam256
    for h, w in ((480, 640), (680, 1200), (640, 480), (256, 256)):
        assert tm.resized_hw(h, w) == jm.resized_hw(h, w)
        assert tm.point_scale(h, w) == jm.point_scale(h, w)
    assert tm.resized_hw(480, 640) == (192, 256)
    assert tm.point_scale(480, 640) == (1.0, 0.75)
    img = _image(5, 120, 200).astype(np.float32) / 255.0
    ref = np.asarray(jm.preprocess(jnp.asarray(img)))
    got = tm.preprocess(t(img)).numpy()
    assert got.shape == (1, 256, 256, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    nh = tm.resized_hw(120, 200)[0]
    np.testing.assert_array_equal(got[0, nh:], 0.0)


def test_sam1_encode_image_matches_jax(sam256):
    jm, tm = sam256
    img = _image(6).astype(np.float32) / 255.0
    ej, hj = jm.encode_image(jm.preprocess(jnp.asarray(img)))
    et, ht = tm.encode_image(tm.preprocess(t(img)))
    assert hj is None and ht is None
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=ATOL)


@pytest.mark.parametrize("gates", ["off", "sam1_defaults"])
def test_sam1_amg_end_to_end_nonsquare_matches_jax(sam256, gates):
    """96 x 128 frames: the pad-suppressed scores, the crop-composed
    upsample, outputs at the frame's size; with SAM1's defaults (gates at
    0 but ``min_area`` 100) the host small-region pass runs."""
    jm, tm = sam256
    kw = dict(points_per_side=4, max_masks=16, candidates=32, gate_prompts=8,
              **GATES_OFF)
    if gates == "sam1_defaults":
        kw["min_area"] = 100
    img = _image(11)
    ref = jamg.AutomaticMaskSource(jm, **kw).get_masks(img, 0)
    ours = tamg.AutomaticMaskSource(tm, **kw).get_masks(img, 0)
    valid = assert_masks_agree(ours, ref)
    assert ours[0].shape == (96, 128) and valid.sum() >= 1
    seg_b, bmaps_b, valid_b = tamg.AutomaticMaskSource(
        tm, **kw).get_masks_batch(np.stack([img, _image(12)]))
    np.testing.assert_array_equal(valid_b[0].numpy(), valid)
    np.testing.assert_array_equal(seg_b[0].numpy(), ours[0].numpy())


def test_sam1_upsample_uses_raw_boundary_logits():
    """The composed matrices equal the reference's bit for bit; a mask
    positive everywhere (the model's real pad logits included) stays
    positive over the whole output, which the pad sentinel would not."""
    Hm = Wm = 16
    s, nh, nw, out = 256, 192, 256, (96, 128)
    for src, crop, dst in ((Hm, nh, out[0]), (Wm, nw, out[1])):
        np.testing.assert_array_equal(
            tamg._sam1_upsample_matrix(src, s, crop, dst),
            jamg._sam1_upsample_matrix(src, s, crop, dst))
    mats = (t(jamg._sam1_upsample_matrix(Hm, s, nh, out[0])),
            t(jamg._sam1_upsample_matrix(Wm, s, nw, out[1])))
    raw = torch.ones((1, Hm, Wm))
    vh = -(-nh * Hm // s)
    suppressed = raw.clone()
    suppressed[:, vh:] = -1e4
    up_raw = tamg.upsample_bilinear_matmul(raw, out, mats)
    up_sup = tamg.upsample_bilinear_matmul(suppressed, out, mats)
    assert bool((up_raw > 0).all())
    assert bool((up_sup[:, -1, :] < 0).any())


def test_sam1_min_area_rescaled_to_logit_cells():
    for args in ((100, 192 * 256, (480, 640)), (0, 192 * 256, (480, 640)),
                 (100, 256 * 256, (1024, 1024)), (100, 37 * 64, (680, 1200))):
        assert tamg.min_area_cells(*args) == jamg.min_area_cells(*args)
    assert tamg.min_area_cells(100, 192 * 256, (480, 640)) == 16.0


# ---------------------------------------------------------------------------
# the factory
# ---------------------------------------------------------------------------

def test_sam1_factory_dispatch(tmp_path, monkeypatch):
    """``sam_version: ""`` builds SAM1 with its defaults (stability 0.85,
    ``min_area`` 100) as the reference does; a present sam_vit_test.pth (a
    SAM1 state dict from the JAX random weights, in the official layout)
    loads through both packages' factories. A loaded model runs at
    SAMConfig's defaults, in both: bf16 at 1024 whatever the config says.
    Compared in f32 (both configs patched), the masks agree as the AMG
    tests' do."""
    from ovo_tpu.models.sam.amg import build_sam_mask_source as jax_build

    cfg = {"sam_version": "", "sam_encoder": "vit_test",
           "sam_ckpt_path": str(tmp_path / "none"), "image_size": 256,
           "points_per_side": 4}
    src = tamg.build_sam_mask_source(cfg, device="cpu")
    ref = jax_build(cfg)
    assert src.model.cfg.family == ref.model.cfg.family == "sam1"
    assert src.stability_thresh == ref.stability_thresh == 0.85
    assert src.min_area == ref.min_area == 100
    assert src.model.cfg.image_size == 256

    import chip_smoke

    jm = JaxSAM.random_init("vit_test", image_size=1024, seed=4)
    sd = chip_smoke.official_state_dict("sam1", np_tree(jm.params))
    torch.save({"model": sd}, tmp_path / "sam_vit_test.pth")
    cfg = dict(cfg, sam_ckpt_path=str(tmp_path), image_size=256,
               pred_iou_th=0.0, stability_score_th=0.0, nms_score_th=0.0)
    loaded = tamg.build_sam_mask_source(cfg, device="cpu")
    assert all(p.is_contiguous() for p in loaded.model.params.parameters())
    assert loaded.model.cfg.image_size == 1024
    assert loaded.model.cfg.compute_dtype == "bfloat16"
    for mod in (jmodel, tmodel):
        monkeypatch.setattr(mod, "SAMConfig", functools.partial(
            mod.SAMConfig, compute_dtype="float32"))
    ours = tamg.build_sam_mask_source(cfg, device="cpu")
    theirs = jax_build(cfg)
    assert ours.model.cfg.compute_dtype == "float32"
    img = _image(21, 90, 160)
    valid = assert_masks_agree(ours.get_masks(img, 0),
                               theirs.get_masks(img, 0))
    assert valid.sum() >= 1
