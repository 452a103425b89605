"""The port's towers against HuggingFace transformers' independent
implementations, as the JAX package's three suites hold its own
(``tests/test_siglip_transformers_parity.py``,
``test_clip_text_transformers_parity.py``,
``test_sam1_transformers_parity.py``):
the same random official-format state dicts, the same HF models and the
same tolerances, with the port's converters and forwards (f32, CPU) in
place of the JAX ones. The state dicts and the HF key maps are the
reference suites' own.
"""
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import test_clip_text_transformers_parity as clip_suite  # noqa: E402
import test_sam1_transformers_parity as sam1_suite  # noqa: E402
import test_siglip_transformers_parity as siglip_suite  # noqa: E402
from ovo_tpu_torch.models import convert as tconvert  # noqa: E402
from ovo_tpu_torch.models import convert_sam as tconvert_sam  # noqa: E402
from ovo_tpu_torch.models import text as text_mod  # noqa: E402
from ovo_tpu_torch.models import vit as vit_mod  # noqa: E402
from ovo_tpu_torch.models.convert_jax import load_jax_params  # noqa: E402
from ovo_tpu_torch.models.sam import vitdet  # noqa: E402
from ovo_tpu_torch.models.sam.params import Init, ParamTree  # noqa: E402


def _hf(model, sd):
    model = model.eval()
    missing, unexpected = model.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    return model


def siglip_vision():
    s = siglip_suite
    rng = np.random.default_rng(0)
    sd = s.timm_siglip_vision_sd(rng)
    params = tconvert.convert_timm_trunk(sd, prefix="visual.trunk")
    cfg = vit_mod.ViTConfig(image_size=s.IMG, patch_size=s.PATCH,
                            width=s.W_, depth=s.DEPTH, n_heads=s.HEADS,
                            mlp_ratio=s.HIDDEN / s.W_, embed_dim=s.W_,
                            use_cls_token=False, use_abs_pos=True,
                            pool="attn")
    tower = load_jax_params(vit_mod.VisionTransformer(
        cfg, device="cpu", map_mlp_hidden=s.HIDDEN, pool_ln=False), params)
    imgs = rng.standard_normal((2, s.IMG, s.IMG, 3)).astype(np.float32) * 0.5
    ours = vit_mod.encode(tower, cfg, torch.from_numpy(imgs),
                          project=False).numpy()
    from transformers import SiglipVisionConfig, SiglipVisionModel

    model = _hf(SiglipVisionModel(SiglipVisionConfig(
        hidden_size=s.W_, intermediate_size=s.HIDDEN,
        num_hidden_layers=s.DEPTH, num_attention_heads=s.HEADS,
        image_size=s.IMG, patch_size=s.PATCH, hidden_act="gelu",
        attention_dropout=0.0)), s.to_hf_state_dict(sd))
    with torch.no_grad():
        theirs = model(pixel_values=torch.from_numpy(
            imgs.transpose(0, 3, 1, 2))).pooler_output.numpy()
    assert ours.shape == theirs.shape == (2, s.W_)
    return ours, theirs, 2e-4


def clip_text():
    s = clip_suite
    rng = np.random.default_rng(1)
    sd = s.openai_text_sd(rng)
    cfg = text_mod.TextConfig(vocab_size=s.VOCAB, context_length=s.CTX,
                              width=s.W_, depth=s.DEPTH, n_heads=s.HEADS,
                              mlp_ratio=s.HIDDEN / s.W_, embed_dim=s.EMBED,
                              causal=True, pool="argmax", act="quick_gelu")
    tower = text_mod.text_from_jax_params(
        cfg, tconvert.convert_text_tower(dict(sd)), "cpu")
    # sot low, EOT the highest id of each row (argmax pooling)
    toks = rng.integers(1, s.VOCAB - 2, (3, s.CTX)).astype(np.int32)
    toks[:, 0] = 0
    for r, pos in enumerate((5, s.CTX - 1, 9)):
        toks[r, pos] = s.VOCAB - 1
        toks[r, pos + 1:] = 0
    ours = text_mod.encode_text(tower, cfg, torch.from_numpy(toks)).numpy()
    from transformers import CLIPTextConfig, CLIPTextModelWithProjection

    model = _hf(CLIPTextModelWithProjection(CLIPTextConfig(
        vocab_size=s.VOCAB, hidden_size=s.W_, intermediate_size=s.HIDDEN,
        num_hidden_layers=s.DEPTH, num_attention_heads=s.HEADS,
        max_position_embeddings=s.CTX, hidden_act="quick_gelu",
        projection_dim=s.EMBED, eos_token_id=s.VOCAB - 1,
        attention_dropout=0.0)), s.to_hf_state_dict(sd))
    with torch.no_grad():
        theirs = model(input_ids=torch.from_numpy(toks.astype(np.int64))
                       ).text_embeds.numpy()
    assert ours.shape == theirs.shape == (3, s.EMBED)
    return ours, theirs, 2e-4


def sam1_encoder():
    s = sam1_suite
    rng = np.random.default_rng(2)
    sd = s.official_sam1_encoder_sd(rng)
    cfg = vitdet.ViTDetConfig(embed_dim=s.C, depth=s.DEPTH,
                              num_heads=s.HEADS, global_blocks=s.GLOBAL,
                              window_size=s.WS, patch=s.PATCH,
                              mlp_ratio=s.MLP / s.C, out_chans=s.OUT,
                              pretrain_grid=s.IMG // s.PATCH)
    params = load_jax_params(ParamTree(vitdet.init_vitdet(Init(None, "cpu"),
                                                          cfg)),
                             tconvert_sam.convert_vitdet(sd))
    imgs = rng.standard_normal((2, s.IMG, s.IMG, 3)).astype(np.float32) * 0.5
    ours = vitdet.vitdet_forward(params, cfg, torch.from_numpy(imgs)).numpy()
    from transformers import SamVisionConfig, SamVisionModel

    model = _hf(SamVisionModel(SamVisionConfig(
        hidden_size=s.C, output_channels=s.OUT, num_hidden_layers=s.DEPTH,
        num_attention_heads=s.HEADS, image_size=s.IMG, patch_size=s.PATCH,
        use_rel_pos=True, window_size=s.WS,
        global_attn_indexes=list(s.GLOBAL), mlp_dim=s.MLP,
        attention_dropout=0.0)), s.to_hf_state_dict(sd))
    with torch.no_grad():
        theirs = model(pixel_values=torch.from_numpy(
            imgs.transpose(0, 3, 1, 2))).last_hidden_state.numpy()
    theirs = theirs.transpose(0, 2, 3, 1)      # HF is channels-first
    assert ours.shape == theirs.shape
    return ours, theirs, 3e-4


@pytest.mark.parametrize("suite", [siglip_vision, clip_text, sam1_encoder],
                         ids=["siglip_vision", "clip_text", "sam1_encoder"])
def test_port_towers_match_transformers(suite):
    ours, theirs, tol = suite()
    np.testing.assert_allclose(ours, theirs, rtol=tol, atol=tol)
