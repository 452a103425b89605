"""The learned merger's train step in the port against the JAX package:
``merger_loss`` and its gradients against ``jax.value_and_grad``, one Adam
step against ``optax.adam`` through the reference's ``make_train_step``,
and 30 steps reducing the loss (the outcome check of
``tests/test_models.py::test_merger_training_reduces_loss``: a loop of
optimizer steps drifts by f32 rounding at every step, so it is held by its
outcome, not bit for bit).

Tolerances: the loss within 2e-4 (PARITY.md section 1); the gradients,
order 1e-2 here, within 1e-6 (measured 4.7e-8). One Adam step at lr 1e-3:
parameters within 2e-4. Where a gradient is zero in exact arithmetic (the
k bias of qkv and the head's output bias: a softmax ignores a shift) each
package keeps its own rounding noise, below 1e-8, and Adam scales it to
lr * noise / (noise + eps) < lr / 2 (measured 6.0e-5); every other update
agrees to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ovo_tpu.models import merger as jmerger

from ovo_tpu_torch.models import merger as tmerger
from ovo_tpu_torch.models.convert_jax import (flatten_tree,
                                              merger_from_jax_params)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(rng, b, d):
    clips = rng.standard_normal((b, 3, d)).astype(np.float32)
    target = rng.standard_normal((b, d)).astype(np.float32)
    return clips, target


@pytest.fixture(scope="module")
def merger_tree():
    return jmerger.init_merger(jax.random.PRNGKey(3), d_model=64, depth=2,
                               n_heads=8, mlp_hidden=32)


def test_merger_loss_and_grads_match_jax(merger_tree, rng):
    clips, target = _inputs(rng, 12, 64)
    loss, grads = jax.value_and_grad(jmerger.merger_loss)(
        merger_tree, jnp.asarray(clips), jnp.asarray(target))
    params = merger_from_jax_params(_np(merger_tree), "cpu").params
    params.requires_grad_(True)
    ours = tmerger.merger_loss(params, torch.from_numpy(clips),
                               torch.from_numpy(target))
    ours.backward()
    assert abs(float(ours.detach()) - float(loss)) <= 2e-4
    ref = dict(flatten_tree(_np(grads)))
    names = [n for n, _ in params.named_parameters()]
    assert sorted(names) == sorted(ref)
    for name, p in params.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], rtol=0,
                                   atol=1e-6, err_msg=name)
    # the inference wrapper is the same forward, without a graph
    fused = tmerger.merger_apply(params, torch.from_numpy(clips))
    assert not fused.requires_grad
    torch.testing.assert_close(
        fused, tmerger.merger_forward(params, torch.from_numpy(clips)),
        rtol=0, atol=0)


def test_one_adam_step_matches_optax(merger_tree, rng):
    clips, target = _inputs(rng, 12, 64)
    lr = 1e-3
    opt = optax.adam(lr)
    step = jmerger.make_train_step(opt)
    new_tree, _, jloss = step(merger_tree, opt.init(merger_tree),
                              jnp.asarray(clips), jnp.asarray(target))
    params = merger_from_jax_params(_np(merger_tree), "cpu").params
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    tstep = tmerger.make_train_step(params, lr)
    loss = tstep(torch.from_numpy(clips), torch.from_numpy(target))
    assert abs(float(loss) - float(jloss)) <= 2e-4
    ref = dict(flatten_tree(_np(new_tree)))
    moved = 0
    for name, p in params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=0,
                                   atol=2e-4, err_msg=name)
        moved += int((p.detach() != before[name]).any())
    assert moved == len(before)


def test_train_step_hook_sees_gradients_before_the_update(merger_tree, rng):
    """``grad_hook`` runs after backward and before the update: scaling the
    gradients there by 0 changes nothing in Adam's first step (m and v stay
    0, the update is 0)."""
    clips, target = _inputs(rng, 6, 64)
    params = merger_from_jax_params(_np(merger_tree), "cpu").params
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    seen = []

    def hook(ps):
        seen.append(all(p.grad is not None for p in ps.parameters()))
        for p in ps.parameters():
            p.grad.zero_()

    tmerger.make_train_step(params, 1e-3, grad_hook=hook)(
        torch.from_numpy(clips), torch.from_numpy(target))
    assert seen == [True]
    for name, p in params.named_parameters():
        assert torch.equal(p.detach(), before[name]), name


def test_merger_training_reduces_loss(rng):
    """30 Adam steps at lr 1e-3 on a 16-wide merger learning to pick the
    middle clip, from the JAX init the reference's test uses."""
    tree = jmerger.init_merger(jax.random.PRNGKey(0), d_model=16, depth=1,
                               n_heads=2, mlp_hidden=8)
    params = merger_from_jax_params(_np(tree), "cpu").params
    step = tmerger.make_train_step(params, 1e-3)
    clips = torch.from_numpy(rng.standard_normal((32, 3, 16)).astype(
        np.float32))
    target = clips[:, 1]
    losses = [float(step(clips, target)) for _ in range(30)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_train_step_refuses_kernel_routes_off_the_cpu():
    """Off the CPU a head size of at most 128 would send attention through
    a kernel, which has no backward: the step refuses it. The merger's own
    head size (1152 / 8 = 144) takes the plain route and builds."""
    small = tmerger.MergerParams(d_model=64, depth=1, n_heads=8,
                                 mlp_hidden=16, device="meta")
    with pytest.raises(ValueError, match="no backward"):
        tmerger.make_train_step(small, 1e-3)
    wide = tmerger.MergerParams(d_model=1152, depth=1, n_heads=8,
                                mlp_hidden=16, device="meta")
    assert callable(tmerger.make_train_step(wide, 1e-3))
