"""Kernels B1-B4 of the PyTorch port (the SAM2 automatic-mask path): their
plain versions against the JAX package's Pallas kernels run in interpret
mode on the CPU, at 2e-5 abs in f32 (same math, different summation order).
The CUDA kernels are held against these plain versions in
``tests/test_torch_cuda_kernels.py``, which runs on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovo_tpu.models.sam.hiera import HIERA_CONFIGS
from ovo_tpu.ops.attention import cross_i2t_tail_from_keys as jax_i2t_tail
from ovo_tpu.ops.attention import cross_t2i_from_keys as jax_t2i
from ovo_tpu.ops.attention import flash_attention as jax_flash
from ovo_tpu.ops.attention import windowed_fused_attention as jax_winfused

from ovo_tpu_torch.ops import attention as A
from ovo_tpu_torch.ops import cuda_build

ATOL = 2e-5


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _qkv(seed, B, H, Lq, Lk, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Lq, D)).astype(np.float32),
            rng.standard_normal((B, H, Lk, D)).astype(np.float32),
            rng.standard_normal((B, H, Lk, D)).astype(np.float32))


@pytest.mark.parametrize("D,kv_len", [(72, None), (72, 200), (32, 129)])
def test_flash_plain_matches_pallas(D, kv_len):
    q, k, v = _qkv(1, 1, 2, 256, 256, D)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               block_q=128, block_k=128, kv_len=kv_len,
                               interpret=True))
    got = A.flash_attention(t(q), t(k), t(v), kv_len=kv_len).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("n,Lq,Lk,D,kv_len", [
    (12, 64, 64, 72, None),      # Hiera-L stage 1 windows
    (10, 16, 64, 72, 50),        # pooled queries, masked keys
    (40, 8, 8, 32, None),        # decoder token self-attention
    (6, 200, 200, 72, 196),      # stage 3 windows (196 keys, padded)
])
def test_windowed_plain_matches_pallas(n, Lq, Lk, D, kv_len):
    q, k, v = _qkv(2, n, 1, Lq, Lk, D)
    q[3], k[3] = 0.0, 0.0        # a padded instance: uniform softmax
    ref = np.asarray(jax_winfused(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), kv_len=kv_len,
                                  interpret=True))
    got = A.windowed_fused_attention(t(q), t(k), t(v), kv_len=kv_len).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)
    kv = Lk if kv_len is None else kv_len
    np.testing.assert_allclose(got[3, 0], np.broadcast_to(
        v[3, 0, :kv].mean(0), (Lq, D)), atol=1e-5)
    assert np.isfinite(got).all()


def _cross_inputs(seed, B, Bk, T, L, heads, D, dk):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        q=rng.standard_normal((B, T, D)).astype(f),
        keys=rng.standard_normal((Bk, L, dk)).astype(f),
        wk=(rng.standard_normal((dk, D)) * dk ** -0.5).astype(f),
        wv=(rng.standard_normal((dk, D)) * dk ** -0.5).astype(f),
        pe=rng.standard_normal((1, L, D)).astype(f),
        bv=rng.standard_normal(D).astype(f),
        wout=(rng.standard_normal((D, dk)) * D ** -0.5).astype(f),
        bout=rng.standard_normal(dk).astype(f),
        g=(rng.random(dk) + 0.5).astype(f),
        b=rng.standard_normal(dk).astype(f))


@pytest.mark.parametrize("Bk", [1, 3])
@pytest.mark.parametrize("T", [8, 6])
def test_cross_t2i_plain_matches_pallas(Bk, T):
    """Keys shared by every prompt (batch 1, the first two-way layer) and
    per prompt; a token count that the TPU path pads to 8."""
    x = _cross_inputs(3, 3, Bk, T, 256, 4, 64, 96)
    ref = np.asarray(jax_t2i(jnp.asarray(x["q"]), jnp.asarray(x["keys"]),
                             jnp.asarray(x["wk"]), jnp.asarray(x["wv"]),
                             jnp.asarray(x["pe"]), jnp.asarray(x["bv"]), 4,
                             interpret=True))
    got = A.cross_t2i_from_keys(t(x["q"]), t(x["keys"]), t(x["wk"]),
                                t(x["wv"]), t(x["pe"]), t(x["bv"]), 4).numpy()
    assert got.shape == (3, T, 64)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("Bk", [1, 3])
@pytest.mark.parametrize("T", [8, 6])
def test_cross_i2t_tail_plain_matches_pallas(Bk, T):
    """T = 6 runs the TPU kernel with 2 masked pad tokens (t_len < 8)."""
    x = _cross_inputs(4, 3, Bk, T, 256, 4, 64, 96)
    kk, vv = x["q"], x["q"][:, ::-1] * 0.5
    args = [x["keys"], x["wk"], x["pe"], kk, vv, x["wout"], x["bout"],
            x["g"], x["b"]]
    ref = np.asarray(jax_i2t_tail(*map(jnp.asarray, args), 4,
                                  interpret=True))
    got = A.cross_i2t_tail_from_keys(*map(t, args), 4).numpy()
    assert got.shape == (3, 256, 96)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)


def test_cross_i2t_tail_t_len_masks_tokens():
    """Tokens past ``t_len`` drop out: 8 tokens with t_len 6 equal the first
    6 tokens alone (the TPU kernel's own pad masking)."""
    x = _cross_inputs(5, 2, 2, 8, 256, 4, 64, 96)
    base = [x["keys"], x["wk"], x["pe"]]
    tail = [x["wout"], x["bout"], x["g"], x["b"]]
    kk, vv = x["q"], x["q"] * 0.3
    ref = np.asarray(jax_i2t_tail(*map(jnp.asarray, base + [
        kk[:, :6], vv[:, :6]] + tail), 4, interpret=True))
    got = A.cross_i2t_tail_from_keys(*map(t, base + [kk, vv] + tail), 4,
                                     t_len=6).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)


def _hiera_l_attention_shapes(image_size=1024):
    """(instances, lq, lk, hd) of every attention in Hiera-L at 1024^2."""
    cfg = HIERA_CONFIGS["hiera_l"]
    side = image_size // 4
    shapes = []
    for din, dout, heads, ws, pool in cfg.block_layout():
        if ws:
            n_w = (-(-side // ws)) ** 2
            lk = ws * ws
            lq = (ws // 2) ** 2 if pool else lk
            shapes.append((n_w * heads, lq, lk, dout // heads))
        else:
            lk = side * side
            lq = (side // 2) ** 2 if pool else lk
            shapes.append((heads, lq, lk, dout // heads))
        if pool:
            side //= 2
    return shapes


def test_routing_of_every_amg_attention():
    """Every Hiera-L attention at 1024^2 and the decoder's token
    self-attention land on B1 or B2: the three global blocks (L = 4096) on
    B1, the 45 window blocks and the decoder on B2, with head sizes B2
    takes. A pure function of the shapes (no card needed)."""
    shapes = _hiera_l_attention_shapes()
    routes = [A.attention_route(lq, lk, hd) for _, lq, lk, hd in shapes]
    assert routes.count("flash") == 3 and routes.count("windowed") == 45
    assert [i for i, r in enumerate(routes) if r == "flash"] == [23, 33, 43]
    assert {s[3] for s in shapes} == {72}
    assert all(hd in A.WINDOWED_HEAD_DIMS for *_, hd in shapes)
    assert A.attention_route(8, 8, 32) == "windowed"   # decoder, hd 32
    assert 32 in A.WINDOWED_HEAD_DIMS
    assert {(n, lq, lk) for n, lq, lk, _ in shapes if lq <= 512} >= {
        (2048, 64, 64), (4096, 16, 64), (4096, 16, 16), (8192, 4, 16),
        (200, 196, 196), (400, 49, 196), (400, 49, 49)}


@pytest.mark.parametrize("fn", ["flash", "windowed", "t2i", "i2t"])
def test_wrappers_take_cpu_tensors_only(fn):
    """Off the CPU every wrapper launches its kernel or raises: a tensor that
    is not on the CPU never reaches the plain version."""
    m = dict(device="meta")
    q = torch.zeros((1, 2, 16, 32), **m)
    x = torch.zeros((2, 8, 64), **m)
    keys = torch.zeros((1, 128, 64), **m)
    w = torch.zeros((64, 64), **m)
    vec = torch.zeros((64,), **m)
    with pytest.raises(ValueError):
        if fn == "flash":
            A.flash_attention(q, q, q)
        elif fn == "windowed":
            A.windowed_fused_attention(q, q, q)
        elif fn == "t2i":
            A.cross_t2i_from_keys(x, keys, w, w, torch.zeros((1, 128, 64),
                                                             **m), vec, 4)
        else:
            A.cross_i2t_tail_from_keys(keys, w, torch.zeros((1, 128, 64), **m),
                                       x, x, w, vec, vec, vec, 4)


def test_masked_attention_has_no_card_route():
    """Causal and masked attention have no kernel: the plain route on any
    device (the reference routes them to XLA too), launching nothing."""
    cuda_build.reset_launch_counts()
    q = torch.zeros((1, 2, 16, 32), device="meta")
    assert A.attention_route(16, 16, 32, causal=True) == "xla"
    assert A.attention_route(16, 16, 32, has_mask=True) == "xla"
    out = A.dot_product_attention(q, q, q, causal=True)
    assert out.device.type == "meta" and out.shape == q.shape
    assert set(cuda_build.launch_counts().values()) == {0}
    qc, kc, vc = (t(a) for a in _qkv(6, 1, 2, 16, 16, 32))
    ref = A.xla_attention(qc, kc, vc, mask=torch.ones(16, 16).tril().bool())
    np.testing.assert_allclose(
        A.dot_product_attention(qc, kc, vc, causal=True).numpy(),
        ref.numpy(), atol=1e-6)


def test_cpu_wrappers_count_no_launch():
    cuda_build.reset_launch_counts()
    q, k, v = (t(a) for a in _qkv(7, 1, 2, 16, 16, 32))
    A.dot_product_attention(q, k, v)
    A.flash_attention(q, k, v)
    assert set(cuda_build.launch_counts().values()) == {0}
