"""The SAM decoder's three routes in the PyTorch port against the JAX
package, on the CPU.

Kernels B9a / B9b (``cross_attention_small_head``), B7
(``cross_i2t_from_keys``) and B8 (``residual_layer_norm``): their plain
versions against the reference's Pallas kernels run in interpret mode
(f32 3e-5 / 1e-4 / 1e-5; B8 in bf16 within one output step). The route
choice against the reference's own predicates, and ``decode_masks``
through each route, and the AMG program on the route the predicates pick,
against the reference's XLA route on the CPU (the unfused algebra). The
CUDA kernels are held against these plain versions in
``tests/test_torch_cuda_kernels.py``, on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovo_tpu.models.sam import amg as jamg
from ovo_tpu.models.sam.decoder import decode_masks as jax_decode_masks
from ovo_tpu.models.sam.model import SAMConfig as JaxSAMConfig
from ovo_tpu.models.sam.model import SAMModel as JaxSAM
from ovo_tpu.ops import attention as jatt
from ovo_tpu.ops import layer_norm as jln

from ovo_tpu_torch.models.sam import amg as tamg
from ovo_tpu_torch.models.sam import decoder as tdec
from ovo_tpu_torch.models.sam.model import SAMModel
from ovo_tpu_torch.ops import attention as A
from ovo_tpu_torch.ops import cuda_build
from ovo_tpu_torch.ops.decoder_route import ROUTES, decoder_route
from ovo_tpu_torch.ops.layer_norm import (residual_layer_norm,
                                          residual_layer_norm_plain)

from test_torch_sam import assert_masks_agree


def t(x):
    return torch.from_numpy(np.array(x))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# B9a / B9b, B7, B8: plain versions against the interpreted Pallas kernels
# ---------------------------------------------------------------------------

# the reference's own parametrization (tests/test_attention_ops.py:161-165)
CROSS_CASES = [(6, 1, 8, 256), (6, 6, 8, 256), (4, 4, 11, 384)]


@pytest.mark.parametrize("B,Bimg,T,L", CROSS_CASES)
@pytest.mark.parametrize("direction", ["t2i", "i2t"])
def test_cross_small_head_plain_matches_pallas(B, Bimg, T, L, direction):
    """Batch-1 and per-prompt image sides; T = 11 runs the TPU kernels on
    tokens padded to 16 (t2i drops the pad rows, i2t masks the pad tokens
    with t_len)."""
    heads, D = 8, 128
    rng = np.random.default_rng(B * 100 + Bimg * 10 + T)
    tok = rng.standard_normal((B, T, D)).astype(np.float32)
    tok_v = rng.standard_normal((B, T, D)).astype(np.float32)
    img = rng.standard_normal((Bimg, L, D)).astype(np.float32)
    val = rng.standard_normal((Bimg, L, D)).astype(np.float32)
    pad = ((0, 0), (0, (-T) % 8), (0, 0))
    texp = jatt._expand_blockdiag(jnp.pad(jnp.asarray(tok), pad), heads)
    scale = (D // heads) ** -0.5
    if direction == "t2i":
        o = jatt._crossq_call(texp, jnp.asarray(img), jnp.asarray(val),
                              heads=heads, scale=scale, interpret=True)
        ref = jatt._extract_blockdiag(o, heads, T)
        got = A.cross_attention_small_head(t(tok), t(img), t(val), heads)
    else:
        vexp = jatt._expand_blockdiag(jnp.pad(jnp.asarray(tok_v), pad),
                                      heads)
        ref = jatt._crossk_call(jnp.asarray(img), texp, vexp, heads=heads,
                                scale=scale, t_len=T, interpret=True)
        got = A.cross_attention_small_head(t(img), t(tok), t(tok_v), heads)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5,
                               rtol=3e-5)


def test_cross_small_head_t_len_masks_tokens():
    """i2t over 8 tokens with t_len 6 equals the first 6 tokens alone."""
    rng = np.random.default_rng(9)
    img = t(rng.standard_normal((2, 130, 64)).astype(np.float32))
    kk = t(rng.standard_normal((2, 8, 64)).astype(np.float32))
    vv = t(rng.standard_normal((2, 8, 64)).astype(np.float32))
    got = A.cross_attention_small_head(img, kk, vv, 4, t_len=6)
    ref = A.cross_attention_small_head(img, kk[:, :6], vv[:, :6], 4)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)
    with pytest.raises(ValueError):
        A.cross_attention_small_head(kk, img, img, 4, t_len=6)   # t2i
    with pytest.raises(ValueError):
        A.cross_attention_small_head(img, img, img, 4)    # no short side


@pytest.mark.parametrize("B,Bimg,T,L", CROSS_CASES)
def test_cross_i2t_from_keys_plain_matches_pallas(B, Bimg, T, L):
    """The reference's recipe (tests/test_attention_ops.py:297-342):
    batch-1 and per-prompt keys, a token count padded to 16 with t_len."""
    heads, dint, dk = 8, 128, 256
    rng = np.random.default_rng(40 + T + Bimg)
    f = np.float32
    keys = rng.standard_normal((Bimg, L, dk)).astype(f)
    wq = (rng.standard_normal((dk, dint)) * 0.1).astype(f)
    pe_q = rng.standard_normal((1, L, dint)).astype(f)
    k_tok = rng.standard_normal((B, T, dint)).astype(f)
    v_tok = rng.standard_normal((B, T, dint)).astype(f)
    args = (keys, wq, pe_q, k_tok, v_tok)
    ref = jatt.cross_i2t_from_keys(*map(jnp.asarray, args), heads,
                                   interpret=True)
    got = A.cross_i2t_from_keys(*map(t, args), heads)
    assert got.shape == (B, L, dint)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b_res", [1, 4])
def test_residual_layer_norm_plain_matches_pallas(dtype, b_res):
    """bf16 within one output step (rtol 1e-2, atol 3e-2, as the reference's
    own test), f32 within 1e-5; batch-1 and per-prompt residual."""
    rng = np.random.default_rng(50 + b_res)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x = jnp.asarray(rng.standard_normal((4, 256, 256)), jdt)
    res = jnp.asarray(rng.standard_normal((b_res, 256, 256)), jdt)
    scale = jnp.asarray(rng.standard_normal(256), jnp.float32)
    bias = jnp.asarray(rng.standard_normal(256), jnp.float32)
    ref = jln._res_ln_call(x, res, scale, bias, eps=1e-5, interpret=True)

    def tt(a, dt):
        return t(np.asarray(a, np.float32)).to(dt)

    got = residual_layer_norm(tt(x, tdt), tt(res, tdt),
                              tt(scale, torch.float32),
                              tt(bias, torch.float32))
    assert got.dtype == tdt and got.shape == (4, 256, 256)
    tol = dict(rtol=1e-2, atol=3e-2) if dtype == "bfloat16" else dict(
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("fn", ["t2i", "i2t", "i2t_proj", "res_ln"])
def test_new_wrappers_take_cpu_tensors_only(fn):
    """Off the CPU every wrapper launches its kernel or raises: a tensor that
    is not on the CPU never reaches the plain version."""
    m = dict(device="meta")
    tok = torch.zeros((2, 8, 128), **m)
    img = torch.zeros((1, 256, 128), **m)
    keys = torch.zeros((1, 256, 256), **m)
    with pytest.raises(ValueError):
        if fn == "t2i":
            A.cross_attention_small_head(tok, img, img, 8)
        elif fn == "i2t":
            A.cross_attention_small_head(img, tok, tok, 8)
        elif fn == "i2t_proj":
            A.cross_i2t_from_keys(keys, torch.zeros((256, 128), **m), img,
                                  tok, tok, 8)
        else:
            vec = torch.zeros((256,), **m)
            residual_layer_norm(keys, keys, vec, vec)


def test_cpu_wrappers_of_the_new_kernels_count_no_launch():
    cuda_build.reset_launch_counts()
    x = torch.zeros((2, 300, 64))
    tok = torch.ones((2, 8, 64))
    A.cross_attention_small_head(tok, x, x, 4)
    A.cross_attention_small_head(x, tok, tok, 4)
    residual_layer_norm_plain(x, x[:1], torch.ones(64), torch.zeros(64))
    assert set(cuda_build.launch_counts().values()) == {0}
    assert {"cross_small_head_t2i", "cross_small_head_i2t", "cross_i2t_proj",
            "residual_layer_norm"} <= set(cuda_build.LAUNCH_NAMES)


# ---------------------------------------------------------------------------
# the route choice
# ---------------------------------------------------------------------------

def _reference_route(T, L, di, dk, heads, itemsize):
    """decoder.py:258-262 as the reference decides on a TPU."""
    HT = heads * (T + (-T) % 8)
    use_proj = jatt._cross_proj_fits(HT, L, di, dk, itemsize)
    use_tail = use_proj and jatt._cross_proj_ln_fits(HT, L, di, dk,
                                                     itemsize)
    return "proj_tail" if use_tail else ("proj" if use_proj else "unfused")


@pytest.mark.parametrize("image_size", [128, 256, 512, 1024, 1280, 2048])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("T", [7, 8, 9])
def test_decoder_route_matches_reference_predicates(image_size, itemsize, T):
    L = (image_size // 16) ** 2
    for di, dk, heads in ((128, 256, 8), (64, 256, 4), (128, 192, 8)):
        assert decoder_route(T, L, di, dk, heads, itemsize) == \
            _reference_route(T, L, di, dk, heads, itemsize)


def test_decoder_route_of_the_configurations():
    """SAM2 (and SAM1: 7 tokens pad to 8) at 1024^2 in bf16 takes B3 / B4;
    1280^2 in bf16 and any f32 decoder take the unfused route. No SAM
    shape reaches the proj route: it needs heads x tokens in the
    thousands."""
    assert decoder_route(8, 4096, 128, 256, 8, 2) == "proj_tail"
    assert decoder_route(7, 4096, 128, 256, 8, 2) == "proj_tail"
    assert decoder_route(8, 6400, 128, 256, 8, 2) == "unfused"
    assert decoder_route(8, 4096, 128, 256, 8, 4) == "unfused"
    assert decoder_route(8, 256, 128, 256, 8, 4) == "proj_tail"   # hiera_test
    assert decoder_route(8, 64, 128, 256, 8, 4) == "unfused"      # L % 128
    reached = {decoder_route(T, L, 128, 256, 8, it)
               for T in range(1, 65) for L in range(128, 16385, 128)
               for it in (2, 4)}
    assert reached == {"proj_tail", "unfused"}
    # the proj route: 640 heads x 8 tokens (5120 rows) over 128 image rows
    assert decoder_route(8, 128, 128, 256, 640, 2) == "proj"
    assert _reference_route(8, 128, 128, 256, 640, 2) == "proj"


# ---------------------------------------------------------------------------
# decode_masks through each route, and the AMG program on its own route
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decoders():
    jm = JaxSAM.random_init("hiera_test", image_size=256, seed=5)
    tm = SAMModel.from_jax_params("hiera_test", 256, np_tree(jm.params),
                                  device="cpu", compute_dtype="float32")
    return jm.params["decoder"], tm.params["decoder"]


@pytest.mark.parametrize("route", ROUTES)
def test_decode_masks_each_route_matches_jax(decoders, route):
    """A (16, 16, 256) embedding (L 256), 6 prompts of 2 sparse tokens (T
    8), f32: every route against the reference's XLA route on the CPU.
    Measured max |diff| 1.1e-5 on logits up to 9.7 (iou 2.4e-7); the limit
    is 2e-4."""
    jp, tp = decoders
    rng = np.random.default_rng(61)
    f = np.float32
    embed = rng.standard_normal((16, 16, 256)).astype(f)
    pe = rng.standard_normal((16, 16, 256)).astype(f)
    sparse = rng.standard_normal((6, 2, 256)).astype(f)
    hr = [rng.standard_normal((64, 64, 32)).astype(f),
          rng.standard_normal((32, 32, 64)).astype(f)]
    ref = jax_decode_masks(jp, jnp.asarray(embed), jnp.asarray(pe),
                           jnp.asarray(sparse),
                           high_res_feats=[jnp.asarray(h) for h in hr],
                           mask_channels=(1, 2, 3))
    got = tdec.decode_masks(tp, t(embed), t(pe), t(sparse),
                            high_res_feats=[t(h) for h in hr],
                            mask_channels=(1, 2, 3), route=route)
    for key in ("masks", "iou", "obj_score"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=2e-4)
    with pytest.raises(ValueError):
        tdec.decode_masks(tp, t(embed), t(pe), t(sparse), route="fused")


def test_amg_program_on_the_unfused_route_matches_jax(monkeypatch):
    """The slice as a whole: hiera_test in f32 at 1024^2 (L 4096, 16
    prompts), whose decoder the predicates send to the unfused route (B9a /
    B9b, B8), against the reference's AMG program: equal valid sets, seg
    maps under the tie rule."""
    calls = []
    small_head = tdec.cross_attention_small_head
    monkeypatch.setattr(tdec, "cross_attention_small_head",
                        lambda *a, **k: calls.append(1) or small_head(*a,
                                                                      **k))
    jm = JaxSAM.random_init("hiera_test", image_size=1024, seed=6)
    jm = JaxSAM(JaxSAMConfig("hiera_test", 1024, compute_dtype="float32"),
                jm.params)
    tm = SAMModel.from_jax_params("hiera_test", 1024, np_tree(jm.params),
                                  device="cpu", compute_dtype="float32")
    kw = dict(points_per_side=4, max_masks=16, candidates=32, gate_prompts=12,
              pred_iou_thresh=0.0, stability_thresh=0.0, nms_score_th=0.0)
    img = (np.random.default_rng(12).random((90, 160, 3)) * 255).astype(
        np.uint8)
    ref = jamg.AutomaticMaskSource(jm, **kw).get_masks(img, 0)
    ours = tamg.AutomaticMaskSource(tm, **kw).get_masks(img, 0)
    valid = assert_masks_agree(ours, ref)
    assert valid.sum() >= 1
    assert len(calls) == 5      # t2i in 2 layers + final, i2t in 2 layers
