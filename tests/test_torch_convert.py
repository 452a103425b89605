"""The port's checkpoint converters (``ovo_tpu_torch/models/convert.py``,
``convert_sam.py``) against the JAX package's, on the CPU.

  - seeded random state dicts in the official layouts (SAM 2.1 on the
    ``hiera_test`` card, SAM1 on ``vit_test``, open_clip / PE on
    ``tiny-test`` and ``tiny-pe``, a timm SigLIP trunk, the merger) give
    the same trees through both packages, bit for bit;
  - the full-size contracts at zero fill (SAM 2.1 hiera-L, SAM1 ViT-H,
    PE-Core-L14-336, SigLIP so400m-384: the manifests of
    ``tests/test_convert_manifest.py`` and ``tests/test_vitdet_sam1.py``):
    every key outside the documented ignore sets consumed, and the shapes
    those of the port's own trees (its SAM init tree, its tower modules,
    built on the meta device);
  - ``chip_smoke.official_state_dict``, the smoke's inverse of the
    converters: its output, fed to the reference's converters, gives the
    tree back bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from ovo_tpu.models import convert as jconvert
from ovo_tpu.models import convert_sam as jconvert_sam
from ovo_tpu.models import merger as jmerger
from ovo_tpu.models.clip import CLIPModel as JaxCLIP
from ovo_tpu.models.sam.model import SAMModel as JaxSAM

import chip_smoke
from ovo_tpu_torch.models import convert as tconvert
from ovo_tpu_torch.models import convert_sam as tconvert_sam
from ovo_tpu_torch.models import text as text_mod
from ovo_tpu_torch.models import vit as vit_mod
from ovo_tpu_torch.models.convert_jax import flatten_tree
from ovo_tpu_torch.models.clip import MODEL_REGISTRY
from ovo_tpu_torch.models.sam.model import SAMConfig, init_sam

from test_convert_manifest import (pe_core_l14_336_manifest,
                                   sam21_hiera_large_manifest,
                                   siglip_so400m_384_manifest, zeros_sd)
from test_siglip_transformers_parity import timm_siglip_vision_sd
from test_vitdet_sam1 import _vit_h_manifest

META = torch.device("meta")


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_trees_equal(got, ref):
    """Equal paths, shapes, dtypes and bits (None leaves skipped)."""
    g, r = chip_smoke.flat_params(got), chip_smoke.flat_params(ref)
    assert set(g) == set(r), sorted(set(g) ^ set(r))[:8]
    for k in r:
        assert g[k].shape == r[k].shape, k
        np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def shapes(tree, prefix=""):
    """{dotted path: shape} of a tree or a module (meta tensors included)."""
    if isinstance(tree, torch.nn.Module):
        return {prefix + k: tuple(v.shape)
                for k, v in tree.named_parameters()}
    return {prefix + k: tuple(v.shape) for k, v in flatten_tree(tree)}


def randomized(sd, seed):
    """The state dict's keys and shapes, seeded N(0, 1) values."""
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
        np.float32)) for k, v in sd.items()}


def _jax_tree(kind, name):
    if kind in ("sam1", "sam2"):
        return np_tree(JaxSAM.random_init(name, image_size=256).params)
    if kind == "clip":
        return np_tree(JaxCLIP.random_init(name).params)
    return np_tree(jmerger.init_merger(jax.random.PRNGKey(0), d_model=64,
                                       depth=2))


CASES = [("sam2", "hiera_test"), ("sam1", "vit_test"), ("clip", "tiny-test"),
         ("clip", "tiny-pe"), ("merger", "merger")]


# ---------------------------------------------------------------------------
# random state dicts through both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,name", CASES)
def test_converters_match_jax_on_random_state_dicts(kind, name):
    sd = randomized(chip_smoke.official_state_dict(
        kind, _jax_tree(kind, name)), seed=len(name))
    if kind in ("sam1", "sam2"):
        ref = jconvert_sam.convert_sam_state_dict(dict(sd))
        got = tconvert_sam.convert_sam_state_dict(dict(sd))
        assert ("neck" in got) == (kind == "sam2")
        assert ("obj_score_token" in got["decoder"]) == (kind == "sam2")
    elif kind == "clip":
        ref = jconvert.convert_clip_state_dict(sd)
        got = tconvert.convert_clip_state_dict(sd)
        card = MODEL_REGISTRY[name]
        assert tconvert.infer_vit_config(got["visual"], 64, card.vision) == \
            card.vision
    else:
        # a DataParallel checkpoint: module. prefixes are stripped
        sd = {f"module.{k}": v for k, v in sd.items()}
        ref = jconvert.convert_merger_state_dict(sd)
        got = tconvert.convert_merger_state_dict(sd)
    assert_trees_equal(got, ref)


def test_timm_trunk_converter_matches_jax():
    sd = timm_siglip_vision_sd(np.random.default_rng(4))
    ref = jconvert.convert_timm_trunk(sd)
    got = tconvert.convert_timm_trunk(sd)
    assert got["attn_pool"]["ln"] is None and "mlp" in got["attn_pool"]
    assert_trees_equal(got, ref)
    with pytest.raises(KeyError):
        tconvert.convert_timm_trunk({})


# ---------------------------------------------------------------------------
# the full-size contracts at zero fill
# ---------------------------------------------------------------------------

def _sam_shapes(encoder):
    cfg = SAMConfig(encoder=encoder)
    return shapes(init_sam(cfg, None, META))


def test_sam21_hiera_large_manifest_contract():
    manifest, ignored = sam21_hiera_large_manifest()
    sd = zeros_sd({**manifest, **ignored})
    params = {"trunk": tconvert_sam.convert_hiera(sd),
              "neck": tconvert_sam.convert_neck(sd),
              "prompt": tconvert_sam.convert_prompt_encoder(sd),
              "decoder": tconvert_sam.convert_mask_decoder(sd)}
    assert set(manifest) == sd.touched
    assert shapes(params) == _sam_shapes("hiera_l")


def test_sam1_vit_h_manifest_contract():
    manifest = _vit_h_manifest()
    sd = zeros_sd(manifest)
    params = {"trunk": tconvert_sam.convert_vitdet(sd),
              "prompt": tconvert_sam.convert_prompt_encoder(
                  sd, prefix="prompt_encoder"),
              "decoder": tconvert_sam.convert_mask_decoder(
                  sd, prefix="mask_decoder", obj_token=False)}
    ignore = {k for k in manifest
              if k.startswith("prompt_encoder.mask_downscaling.")}
    assert set(manifest) - sd.touched == ignore
    got = shapes(params)
    assert got == _sam_shapes("vit_h")
    disp = tconvert_sam.convert_sam_state_dict(dict(sd))
    assert shapes(disp) == got


def _tower_shapes(cfg, params):
    pool = params["visual"].get("attn_pool") or {}
    hidden = (pool["mlp"]["fc"]["w"].shape[1]
              if pool.get("mlp") is not None else None)
    visual = vit_mod.VisionTransformer(cfg.vision, device=META,
                                       map_mlp_hidden=hidden,
                                       pool_ln=pool.get("ln") is not None)
    text = text_mod.TextTransformer(
        cfg.text, device=META,
        proj_bias=params["text"].get("proj_bias") is not None)
    return {**shapes(visual, "visual."), **shapes(text, "text.")}


@pytest.mark.parametrize("card,manifest", [
    ("PE-Core-L14-336", pe_core_l14_336_manifest),
    ("SigLIP-384", siglip_so400m_384_manifest)])
def test_clip_manifest_contract(card, manifest):
    m = manifest()
    sd = zeros_sd(m)
    params = tconvert.convert_clip_state_dict(sd)
    assert set(m) == sd.touched
    cfg = MODEL_REGISTRY[card]
    assert tconvert.infer_vit_config(params["visual"], cfg.vision.image_size,
                                     cfg.vision) == cfg.vision
    got = shapes({"visual": params["visual"], "text": params["text"]})
    assert got == _tower_shapes(cfg, params)
    assert ("proj_bias" in params["text"]) == (card == "SigLIP-384")


# ---------------------------------------------------------------------------
# the smoke's inverse of the converters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,name", CASES)
def test_official_state_dict_round_trips(kind, name):
    tree = _jax_tree(kind, name)
    sd = chip_smoke.official_state_dict(kind, tree)
    assert all(v.dtype == torch.float32 and v.is_contiguous()
               for v in sd.values())
    if kind in ("sam1", "sam2"):
        back = jconvert_sam.convert_sam_state_dict(sd)
    elif kind == "clip":
        back = jconvert.convert_clip_state_dict(sd)
        assert ("visual.conv1.bias" in sd) == bool(
            np.any(tree["visual"]["patch"]["b"]))
    else:
        back = jconvert.convert_merger_state_dict(sd)
    assert_trees_equal(back, tree)
    # a flat map of the port's own parameters lays out the same keys
    flat = chip_smoke.flat_params(tree)
    assert chip_smoke.official_state_dict(kind, flat).keys() == sd.keys()
    assert_trees_equal(chip_smoke.nest_params(flat), tree)
