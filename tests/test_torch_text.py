"""The query side of the PyTorch port against the JAX package: tokenizers
(equal ids on ``tests/test_tokenizers.py``'s fixtures), the model-card
registry, the text towers (2e-4 abs, PARITY.md section 1) on the causal
``tiny-test`` card and a non-causal SigLIP-structured card, and the
similarity functions (1e-6)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovo_tpu.models import clip as jclip
from ovo_tpu.models import text as jtext
from ovo_tpu.models import tokenizers as jtok
from ovo_tpu.ops import similarity as jsim

from ovo_tpu_torch.models import clip as tclip
from ovo_tpu_torch.models import text as ttext
from ovo_tpu_torch.models import tokenizers as ttok
from ovo_tpu_torch.ops import similarity as tsim

from test_tokenizers import PIECES, _write_bpe_vocab, make_sp_model

TEXTS = ["a chair", "A Photo, of CHAIR!", "  spaced   out  chair ",
         "This is a photo of a chairZ", "", "a photo of chair " * 6]


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# tokenizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("style,pieces,ids", [
    ("siglip", PIECES, (2, -1, 1, 0)),
    ("gemma", [("<pad>", 0.0, 3), ("<eos>", 0.0, 3), ("<bos>", 0.0, 3),
               ("<unk>", 0.0, 2)] + PIECES[3:], (3, 2, 1, 0)),
    ("siglip", PIECES + [(f"<0x{b:02X}>", -12.0, 6) for b in range(256)],
     (2, -1, 1, 0)),
])
def test_sentencepiece_ids_match(tmp_path, style, pieces, ids):
    path = tmp_path / "spiece.model"
    path.write_bytes(make_sp_model(pieces, trainer_ids=ids))
    ours = ttok.SentencePieceTokenizer(str(path), 12, style=style)
    theirs = jtok.SentencePieceTokenizer(str(path), 12, style=style)
    np.testing.assert_array_equal(ours(TEXTS), theirs(TEXTS))
    for text in TEXTS:
        assert ours.encode(text) == theirs.encode(text)


def test_bpe_and_hash_ids_match(tmp_path):
    _write_bpe_vocab(tmp_path / "bpe_simple_vocab_16e6.txt")
    path = str(tmp_path / "bpe_simple_vocab_16e6.txt")
    np.testing.assert_array_equal(ttok.CLIPBPETokenizer(path, 16)(TEXTS),
                                  jtok.CLIPBPETokenizer(path, 16)(TEXTS))
    np.testing.assert_array_equal(ttok.HashTokenizer(1024, 16)(TEXTS),
                                  jtok.HashTokenizer(1024, 16)(TEXTS))


def test_card_routing_matches(tmp_path):
    _write_bpe_vocab(tmp_path / "bpe_simple_vocab_16e6.txt")
    (tmp_path / "sentencepiece.model").write_bytes(
        make_sp_model(PIECES, trainer_ids=(2, -1, 1, 0)))
    for name, card in tclip.MODEL_REGISTRY.items():
        for ckpt in (str(tmp_path), None):
            ours = ttok.get_tokenizer(ckpt, card.text.context_length,
                                      card=card)
            theirs = jtok.get_tokenizer(ckpt, card.text.context_length,
                                        card=jclip.MODEL_REGISTRY[name])
            assert type(ours).__name__ == type(theirs).__name__, name
            np.testing.assert_array_equal(ours(TEXTS), theirs(TEXTS))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _dtype_name(dt):
    return str(dt)[len("torch."):] if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


def _fields(cfg):
    return {k: _dtype_name(v) if k == "dtype" else v
            for k, v in dataclasses.asdict(cfg).items()}


def test_registry_matches_jax():
    assert set(tclip.MODEL_REGISTRY) == set(jclip.MODEL_REGISTRY)
    for name, ours in tclip.MODEL_REGISTRY.items():
        theirs = jclip.MODEL_REGISTRY[name]
        assert _fields(ours.vision) == _fields(theirs.vision), name
        assert _fields(ours.text) == _fields(theirs.text), name
        assert (ours.name, ours.mean, ours.std, ours.siglip, ours.clip_dim) \
            == (theirs.name, theirs.mean, theirs.std, theirs.siglip,
                theirs.clip_dim), name


# ---------------------------------------------------------------------------
# text towers
# ---------------------------------------------------------------------------

SIGLIP_TINY = jtext.TextConfig(vocab_size=1024, context_length=64, width=64,
                               depth=2, n_heads=4, mlp_ratio=3.7362,
                               embed_dim=48, causal=False, pool="last")


@pytest.mark.parametrize("pool", ["argmax", "last", "mean"])
@pytest.mark.parametrize("causal", [True, False])
def test_text_tower_matches_jax(rng, causal, pool):
    cfg = dataclasses.replace(SIGLIP_TINY, causal=causal, pool=pool)
    params = jtext.init_text(jax.random.PRNGKey(3), cfg)
    if not causal:
        params["proj_bias"] = jnp.asarray(rng.standard_normal(48),
                                          jnp.float32)
    tcfg = ttext.TextConfig(**{k: v for k, v in dataclasses.asdict(
        cfg).items() if k != "dtype"})
    model = ttext.text_from_jax_params(tcfg, np_tree(params), "cpu")
    assert (model.proj_bias is None) == causal
    tokens = rng.integers(1, 1000, (3, 64)).astype(np.int32)
    tokens[:, 20] = 1023                                    # the EOT id
    ref = np.asarray(jtext.encode_text(params, cfg, jnp.asarray(tokens)))
    ours = ttext.encode_text(model, tcfg, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-4)


def test_clip_model_text_side_matches_jax():
    """``tiny-test`` (causal, argmax pool): tokenizer, tower, normalized
    embeddings, cosine similarity; the text tree and logit scalars carried
    by ``from_jax_params``."""
    jm = jclip.CLIPModel.random_init("tiny-test", seed=2)
    tm = tclip.CLIPModel.from_jax_params("tiny-test", np_tree(jm.params),
                                         device="cpu")
    texts = ["a chair", "a photo of a big table", "wall"]
    ref = np.asarray(jm.encode_text(texts))
    ours = tm.encode_text(texts).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-4)
    assert float(tm.logit_scale) == pytest.approx(
        float(jm.params["logit_scale"]))
    emb = tclip.CropCLIPEmbedder(tm)
    jemb = jclip.CropCLIPEmbedder(jm)
    te, je = emb.embed_text(texts), np.asarray(jemb.embed_text(texts))
    np.testing.assert_allclose(te.numpy(), je, atol=2e-5)
    imgs = np.random.default_rng(1).standard_normal((5, 32)).astype(
        np.float32)
    imgs /= np.linalg.norm(imgs, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        emb.similarity(te, torch.from_numpy(imgs)).numpy(),
        np.asarray(jemb.similarity(jnp.asarray(je), jnp.asarray(imgs))),
        atol=2e-5)


# ---------------------------------------------------------------------------
# similarity
# ---------------------------------------------------------------------------

def test_similarities_match_jax(rng):
    txt = rng.standard_normal((4, 16)).astype(np.float32)
    img = rng.standard_normal((7, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tsim.clip_cosine_similarity(torch.from_numpy(txt),
                                    torch.from_numpy(img)).numpy(),
        np.asarray(jsim.clip_cosine_similarity(jnp.asarray(txt),
                                               jnp.asarray(img))),
        atol=1e-6, rtol=1e-6)
    scale, bias = np.float32(np.log(10.0)), np.float32(-10.0)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        tsim.siglip_similarity(torch.from_numpy(txt), torch.from_numpy(img),
                               torch.tensor(scale), torch.tensor(bias)
                               ).numpy(),
        np.asarray(jsim.siglip_similarity(jnp.asarray(txt), jnp.asarray(img),
                                          scale, bias)), atol=1e-6)
