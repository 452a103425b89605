"""The SAM2 path of the PyTorch port against the JAX package on the
``hiera_test`` card in f32, with the JAX random weights carried across by
``ovo_tpu_torch.models.convert_jax``: per-stage Hiera features, neck, prompt
encoder and ``encode_image`` to 2e-4; ``decode_masks`` logits to 2e-4 with
``prompt_sel`` equal; the AMG program's valid sets equal and seg maps equal
under the tie rule (fewer than 0.1% of pixels differ: a pixel whose
upsampled logit lies within rounding of 0 may flip between frameworks).
The mask post-processing ops are bit-equal on numpy inputs.

On the CPU the port's decoder runs the plain versions of kernels B3 / B4
(the TPU route's algebra) where the JAX package takes its XLA route; in f32
the two agree to rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovo_tpu.models.sam import amg as jamg
from ovo_tpu.models.sam.hiera import HIERA_CONFIGS as JAX_HIERA
from ovo_tpu.models.sam.hiera import hiera_forward as jax_hiera_forward
from ovo_tpu.models.sam.hiera import init_hiera as jax_init_hiera
from ovo_tpu.models.sam.model import SAMConfig as JaxSAMConfig
from ovo_tpu.models.sam.model import SAMModel as JaxSAM
from ovo_tpu.ops import masks as jmasks
from ovo_tpu.ops.patchify import patch_embed_s4 as jax_patch_embed

from ovo_tpu_torch.models.convert_jax import flatten_tree, load_jax_params
from ovo_tpu_torch.models.sam import amg as tamg
from ovo_tpu_torch.models.sam import hiera as thiera
from ovo_tpu_torch.models.sam.model import SAMModel
from ovo_tpu_torch.models.sam.params import Init, ParamTree
from ovo_tpu_torch.models.sam.prompt import encode_points, pe_grid
from ovo_tpu_torch.ops import masks as tmasks
from ovo_tpu_torch.ops.patchify import patch_embed_s4

from ovo_tpu.models.sam.prompt import encode_points as jax_encode_points
from ovo_tpu.models.sam.prompt import pe_grid as jax_pe_grid

ATOL = 2e-4
TIE_FRACTION = 1e-3


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t(x):
    return torch.from_numpy(np.array(x))


def _models(image_size):
    jm = JaxSAM.random_init("hiera_test", image_size=image_size, seed=1)
    jm = JaxSAM(JaxSAMConfig("hiera_test", image_size,
                             compute_dtype="float32"), jm.params)
    tm = SAMModel.from_jax_params("hiera_test", image_size,
                                  np_tree(jm.params), device="cpu",
                                  compute_dtype="float32")
    return jm, tm


@pytest.fixture(scope="module")
def sam128():
    return _models(128)


@pytest.fixture(scope="module")
def sam256():
    return _models(256)


def _image(seed, h=90, w=120):
    return (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(
        np.uint8)


# ---------------------------------------------------------------------------
# towers
# ---------------------------------------------------------------------------

def test_patch_embed_matches_jax(rng):
    x = rng.standard_normal((2, 32, 40, 3)).astype(np.float32)
    w = rng.standard_normal((7, 7, 3, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    ref = np.asarray(jax_patch_embed(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b)))
    # f32 sums of 196 taps of magnitude ~1 in another order: 1e-5 relative
    np.testing.assert_allclose(patch_embed_s4(t(x), t(w), t(b)).numpy(), ref,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [128, 256])
def test_hiera_stages_match_jax(size):
    cfg = JAX_HIERA["hiera_test"]
    jp = jax_init_hiera(jax.random.PRNGKey(2), cfg)
    tp = load_jax_params(ParamTree(thiera.init_hiera(Init(None, "cpu"),
                                                     thiera.HIERA_CONFIGS[
                                                         "hiera_test"])),
                         np_tree(jp))
    imgs = np.random.default_rng(size).standard_normal(
        (1, size, size, 3)).astype(np.float32)
    ref = jax_hiera_forward(jp, cfg, jnp.asarray(imgs))
    ours = thiera.hiera_forward(tp, thiera.HIERA_CONFIGS["hiera_test"],
                                t(imgs))
    assert len(ours) == len(ref) == 4
    for o, r in zip(ours, ref):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL)


def test_block_layout_matches_jax():
    for name, cfg in JAX_HIERA.items():
        assert thiera.HIERA_CONFIGS[name].block_layout() == cfg.block_layout()


def test_converted_params_cover_the_tree(sam128):
    jm, tm = sam128
    names = {n for n, _ in tm.params.named_parameters()}
    assert names == {k for k, _ in flatten_tree(np_tree(jm.params))}
    w = dict(tm.params.named_parameters())
    assert w["trunk.blocks.0.attn.qkv.w"].dtype == torch.float32
    bf = SAMModel.random_init("hiera_test", 128, device="cpu")
    p = dict(bf.params.named_parameters())
    assert p["decoder.layers.1.cross_i2t.q.w"].dtype == torch.bfloat16
    assert p["decoder.layers.1.cross_i2t.q.b"].dtype == torch.float32


def test_prompt_encoder_matches_jax(sam128, rng):
    jm, tm = sam128
    pts = rng.random((5, 2, 2)).astype(np.float32)
    labels = np.array([[1, 0], [1, 1], [0, -1], [1, -1], [0, 0]], np.int32)
    ref = jax_encode_points(jm.params["prompt"], jnp.asarray(pts),
                            jnp.asarray(labels))
    ours = encode_points(tm.params["prompt"], t(pts), t(labels))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(
        pe_grid(tm.params["prompt"], 8, 6).numpy(),
        np.asarray(jax_pe_grid(jm.params["prompt"], 8, 6)), atol=1e-5)


@pytest.mark.parametrize("size", [128, 256])
def test_encode_image_matches_jax(size, sam128, sam256):
    jm, tm = sam128 if size == 128 else sam256
    img = _image(size).astype(np.float32) / 255.0
    xj = jm.preprocess(jnp.asarray(img))
    xt = tm.preprocess(t(img))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5)
    ej, hj = jm.encode_image(xj)
    et, ht = tm.encode_image(xt)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=ATOL)
    for a, b in zip(ht, hj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


@pytest.mark.parametrize("top_prompts", [None, 6])
def test_decode_masks_match_jax(sam128, top_prompts):
    jm, tm = sam128
    img = _image(3).astype(np.float32) / 255.0
    ej, hj = jm.encode_image(jm.preprocess(jnp.asarray(img)))
    pts = jamg.grid_points(4)
    ref = jm.decode_grid(ej, hj, jnp.asarray(pts), mask_channels=(1, 2, 3),
                         top_prompts=top_prompts)
    ours = tm.decode_grid(t(ej), [t(h) for h in hj], t(pts),
                          mask_channels=(1, 2, 3), top_prompts=top_prompts)
    np.testing.assert_array_equal(ours["prompt_sel"].numpy(),
                                  np.asarray(ref["prompt_sel"]))
    assert ours["masks"].dtype == torch.float32
    for key in ("masks", "iou", "obj_score"):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]),
                                   atol=ATOL)


def test_sam1_is_not_ported():
    with pytest.raises(NotImplementedError):
        SAMModel.random_init("vit_b", 1024, device="cpu")
    with pytest.raises(NotImplementedError):
        tamg.build_sam_mask_source({"sam_encoder": "vit_b",
                                    "sam_version": ""}, device="cpu")


# ---------------------------------------------------------------------------
# the AMG program
# ---------------------------------------------------------------------------

GATES_OFF = dict(pred_iou_thresh=0.0, stability_thresh=0.0, nms_score_th=0.0)


def assert_masks_agree(ours, ref):
    seg, bmaps, valid = (x.numpy() for x in ours)
    rseg, rbmaps, rvalid = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(valid, rvalid)
    assert seg.shape == rseg.shape and bmaps.shape == rbmaps.shape
    assert (seg != rseg).mean() < TIE_FRACTION
    assert (bmaps != rbmaps).mean() < TIE_FRACTION
    return valid


@pytest.mark.parametrize("gates", ["off", "defaults"])
def test_amg_program_matches_jax(sam256, gates):
    jm, tm = sam256
    kw = dict(points_per_side=4, max_masks=16, candidates=32,
              gate_prompts=12)
    if gates == "off":
        kw.update(GATES_OFF)
    img = _image(11, 96, 140)
    ref = jamg.AutomaticMaskSource(jm, **kw).get_masks(img, 0)
    ours = tamg.AutomaticMaskSource(tm, **kw).get_masks(img, 0)
    valid = assert_masks_agree(ours, ref)
    if gates == "off":
        assert valid.sum() >= 1


def test_amg_small_region_pass_matches_jax(sam128):
    """min_mask_region_area > 0: the host connected-component pass."""
    jm, tm = sam128
    kw = dict(points_per_side=4, max_masks=16, candidates=32, min_area=30,
              **GATES_OFF)
    img = _image(13)
    ref = jamg.AutomaticMaskSource(jm, **kw).get_masks(img, 0)
    ours = tamg.AutomaticMaskSource(tm, **kw).get_masks(img, 0)
    assert_masks_agree(ours, ref)


def test_mask_ops_bit_equal_on_numpy_inputs(rng):
    N, H, W = 24, 20, 30
    masks = np.zeros((N, H, W), bool)
    for i in range(N):
        y, x = rng.integers(0, H - 4), rng.integers(0, W - 4)
        masks[i, y:y + rng.integers(2, 12), x:x + rng.integers(2, 15)] = True
    masks[5] = masks[4]                       # a duplicate
    masks[7, :] = False                       # an empty mask
    scores = rng.random(N).astype(np.float32)
    scores[9] = scores[10]                    # a tie
    valid = rng.random(N) > 0.2
    for thr in ((0.7, 0.1, 0.2), (0.5, 0.95, 0.5), (0.7, 2.0, 0.2)):
        kw = dict(iou_thr=thr[0], score_thr=thr[1], inner_thr=thr[2])
        ref = np.asarray(jmasks.mask_nms(jnp.asarray(masks),
                                         jnp.asarray(scores),
                                         jnp.asarray(valid), **kw))
        ours = tmasks.mask_nms(t(masks), t(scores), t(valid), **kw).numpy()
        np.testing.assert_array_equal(ours, ref)
    ref = np.asarray(jmasks.masks_to_seg_map(
        jnp.asarray(masks), jnp.asarray(scores), jnp.asarray(valid)))
    ours = tmasks.masks_to_seg_map(t(masks), t(scores), t(valid)).numpy()
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)
    keep = rng.random(N) > 0.5
    for a, b in zip(tmasks.compact_masks(t(keep), t(masks), t(scores),
                                         t(scores)),
                    jmasks.compact_masks(jnp.asarray(keep),
                                         jnp.asarray(masks),
                                         jnp.asarray(scores),
                                         jnp.asarray(scores))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_box_ops_bit_equal_on_numpy_inputs(rng):
    N = 40
    xy = rng.integers(0, 50, (N, 2))
    wh = rng.integers(1, 30, (N, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    boxes[3] = boxes[2]
    scores = rng.random(N).astype(np.float32)
    scores[11] = scores[12]
    valid = rng.random(N) > 0.1
    for thr in (0.3, 0.7):
        ref = np.asarray(jamg.greedy_box_nms(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thr))
        ours = tamg.greedy_box_nms(t(boxes), t(scores), t(valid), thr)
        np.testing.assert_array_equal(ours.numpy(), ref)
    m = rng.random((6, 12, 17)) > 0.8
    m[2] = False
    np.testing.assert_array_equal(tamg.mask_boxes(t(m)).numpy(),
                                  np.asarray(jamg.mask_boxes(jnp.asarray(m))))
    logits = (rng.standard_normal((3, 16, 16)) * 3).astype(np.float32)
    np.testing.assert_array_equal(
        tamg.stability_score(t(logits), 0.0, 1.0).numpy(),
        np.asarray(jamg.stability_score(jnp.asarray(logits), 0.0, 1.0)))
    np.testing.assert_array_equal(tamg.grid_points(16), jamg.grid_points(16))
    up_ref = np.asarray(jamg.upsample_bilinear_matmul(jnp.asarray(logits),
                                                      (40, 50)))
    np.testing.assert_allclose(
        tamg.upsample_bilinear_matmul(t(logits), (40, 50)).numpy(), up_ref,
        atol=1e-5)
