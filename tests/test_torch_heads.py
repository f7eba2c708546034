"""The head options, the lpc target and the remaining losses of the port
against the JAX package, on the CPU: ``nn.PatternedDropout`` (its
channels from numpy equal JAX's; its outputs with the keep draws
injected), ``MLPBlock``'s tied context, ``dropout_time`` of the MLP and
decoder heads (JAX's uniform draws patched in), ``ops.signal.levinson``
and ``ops.features.lpc``, ``CrossEntropyLoss`` and ``SmoothL1Loss``.

Bounds: 1e-6 (absolute, of values O(1)) for the losses and the head
options; lpc 1e-4 of max|coef| on a seeded well-conditioned AR(4) +
sinusoid signal (Levinson in float32 is ill-conditioned near a singular
autocorrelation)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pase_tpu import losses as jax_losses
from pase_tpu import minions as jax_minions
from pase_tpu import nn as jax_nn
from pase_tpu.ops import features as jax_features
from pase_tpu.ops import signal as jax_signal
from pase_tpu_torch import losses, minions
from pase_tpu_torch import nn as port_nn
from pase_tpu_torch.checkpoint import variables_to_state_dict
from pase_tpu_torch.ops import features, signal
from torch_port_common import flat_variables, port_test_guard  # noqa: F401

TOL = 1e-6


def _load(module, variables):
    sd = variables_to_state_dict(flat_variables(variables))
    module.load_state_dict(sd, strict=True)
    return module


@pytest.mark.parametrize("name,make_target", [
    ("CrossEntropyLoss", lambda rng: rng.randint(0, 5, (3, 7))),
    ("SmoothL1Loss", lambda rng: rng.randn(3, 7, 5).astype(np.float32))])
def test_remaining_losses_match_jax(name, make_target):
    rng = np.random.RandomState(4)
    pred = (rng.randn(3, 7, 5) * 1.5).astype(np.float32)
    target = make_target(rng)
    want = float(jax_losses.make_loss(name)(jnp.asarray(pred),
                                            jnp.asarray(target)))
    got = losses.make_loss(name)(torch.from_numpy(pred),
                                 torch.from_numpy(target)).item()
    assert abs(got - want) <= TOL * max(1.0, abs(want)), (got, want)


def test_unknown_loss_is_a_key_error_as_in_jax():
    with pytest.raises(KeyError):
        jax_losses.make_loss("HuberLoss")
    with pytest.raises(KeyError):
        losses.make_loss("HuberLoss")


def _dropout_case(mode, whole):
    return dict(emb_size=12, p=0.3, dropout_mode=mode,
                ratio_fixed=0.5 if mode == "fixed_rand" else None,
                range_fixed="2:7" if mode == "fixed_given" else None,
                drop_whole_channels=whole)


@pytest.mark.parametrize("mode,whole", [
    ("fixed_rand", False), ("fixed_rand", True), ("fixed_given", False),
    ("std", False)])
def test_patterned_dropout_matches_jax(monkeypatch, mode, whole):
    """The droppable channels are JAX's; with JAX's keep draws injected
    (jax.random.bernoulli patched to return a seeded mask) the outputs
    agree."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 9, 12).astype(np.float32)          # JAX [B, T, C]
    kw = _dropout_case(mode, whole)
    draws = {}

    def bernoulli(key, p, shape):
        draws["keep"] = rng.rand(*shape) < p
        return jnp.asarray(draws["keep"])

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    mod = jax_nn.PatternedDropout(**kw)
    want = np.asarray(mod.apply({}, jnp.asarray(x), train=True,
                                rngs={"dropout": jax.random.PRNGKey(0)}))
    port = port_nn.PatternedDropout(**kw).train()
    port.keep = torch.from_numpy(draws["keep"]).transpose(1, 2)
    got = port(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    if mode == "fixed_rand":
        changed = np.any(want != x, axis=(0, 1))
        assert set(np.flatnonzero(changed)) <= set(
            np.flatnonzero(port.droppable[:, 0].numpy()))
        n_drop = int(12 - 12 * 0.5)
        want_sel = np.sort(np.random.RandomState(0).choice(
            12, size=n_drop, replace=False))
        np.testing.assert_array_equal(
            np.flatnonzero(port.droppable[:, 0].numpy()), want_sel)
    port.eval()
    assert torch.equal(port(torch.from_numpy(x).transpose(1, 2)),
                       torch.from_numpy(x).transpose(1, 2))


def test_patterned_dropout_draws_keep_at_the_rate():
    port = port_nn.PatternedDropout(64, p=0.3, dropout_mode="std").train()
    port.dropout_generator = torch.Generator().manual_seed(0)
    y = port(torch.ones(8, 64, 50))
    kept = (y != 0).float().mean().item()
    # 25600 draws: 4 sigma of a Bernoulli(0.7) mean is 0.0115
    assert abs(kept - 0.7) < 0.0115
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.7))


@pytest.mark.parametrize("context", [3, 5])
def test_tied_context_block_matches_jax(context):
    rng = np.random.RandomState(6)
    x = rng.randn(2, 11, 6).astype(np.float32)
    mod = jax_nn.MLPBlock(5, context=context, tie_context_weights=True)
    v = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    v = {"params": {**v["params"], "act": {"weight": jnp.asarray(
        rng.uniform(0, 0.3, (5,)).astype(np.float32))}}}
    want = np.asarray(mod.apply(v, jnp.asarray(x)))
    port = _load(port_nn.MLPBlock(6, 5, context=context,
                                  tie_context_weights=True), v)
    got = port(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL)


@pytest.mark.parametrize("head", ["mlp", "decoder"])
def test_dropout_time_matches_jax(monkeypatch, head):
    """MLPMinion (context 3) and DecoderMinion with dropout_time 0.3 in
    train mode: JAX's uniform draw patched to a seeded one, the same
    frames dropped on the port's side (``time_keep``); outputs and the
    input gradient agree."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 6, 8).astype(np.float32)
    draws = {}

    uniform_init = jax.random.uniform

    def uniform(key, shape=(), *a, **k):
        if a or k:                       # a parameter initializer's call
            return uniform_init(key, shape, *a, **k)
        draws["u"] = rng.rand(*shape).astype(np.float32)
        return jnp.asarray(draws["u"])

    if head == "mlp":
        kw = dict(num_outputs=4, hidden_size=5, hidden_layers=1, context=3,
                  dropout_time=0.3)
        mod = jax_minions.MLPMinion(**kw)
        port = minions.MLPMinion(8, **kw)
    else:
        kw = dict(num_outputs=1, fmaps=(4,), strides=(2,), kwidths=(4,),
                  hidden_size=3, hidden_layers=1, dropout_time=0.3)
        mod = jax_minions.DecoderMinion(**kw)
        port = minions.DecoderMinion(8, **kw)
    v = mod.init(jax.random.PRNGKey(2), jnp.asarray(x))
    _load(port, v)
    monkeypatch.setattr(jax.random, "uniform", uniform)

    def f(xx):
        y = mod.apply(v, xx, train=True,
                      rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(y * y), y

    (_, want), gx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    keep = draws["u"] > 0.3
    assert 0 < keep.sum() < keep.size
    port.train()
    port.time_keep = torch.from_numpy(keep).transpose(1, 2)
    xt = torch.from_numpy(x).transpose(1, 2).requires_grad_(True)
    y = port(xt)
    (y * y).sum().backward()
    np.testing.assert_allclose(y.detach().transpose(1, 2).numpy(),
                               np.asarray(want), atol=TOL)
    np.testing.assert_allclose(xt.grad.transpose(1, 2).numpy(),
                               np.asarray(gx), atol=10 * TOL)
    assert torch.equal(port.last_time_keep, port.time_keep)


def _ar4_signal(n=8000, seed=8):
    rng = np.random.RandomState(seed)
    a = [0.6, -0.3, 0.2, -0.1]                  # a stable AR(4)
    e = rng.randn(n + 100)
    y = np.zeros(n + 100)
    for t in range(4, n + 100):
        y[t] = sum(a[i] * y[t - 1 - i] for i in range(4)) + e[t]
    t = np.arange(n)
    s = y[100:] + 0.5 * np.sin(2 * np.pi * 440.0 * t / 16000.0)
    return (0.1 * s / np.abs(s).max()).astype(np.float32)


def test_levinson_matches_jax():
    rng = np.random.RandomState(9)
    x = rng.randn(3, 400)
    r = np.stack([np.correlate(row, row, "full")[399:399 + 9]
                  for row in x]).astype(np.float32)
    wa, we = jax_signal.levinson(jnp.asarray(r), 8)
    ga, ge = signal.levinson(torch.from_numpy(r), 8)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), atol=1e-5)
    np.testing.assert_allclose(ge.numpy(), np.asarray(we), rtol=1e-5)


@pytest.mark.parametrize("order", [4, 25])
def test_lpc_matches_jax(order):
    wav = np.stack([_ar4_signal(), _ar4_signal(seed=10)])
    want = np.asarray(jax_features.lpc(jnp.asarray(wav), order=order))
    got = features.lpc(torch.from_numpy(wav), order=order).numpy()
    assert got.shape == want.shape == (2, 50, order + 1)
    assert np.isfinite(want).all()
    err = np.abs(got - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err


def test_lpc_worker_dispatch_and_dim():
    cfg = {"order": 12}
    fn = features.feature_fn_for_worker("lpc", cfg)
    assert fn(torch.zeros(1, 1600) + 1e-3).shape == (1, 10, 13)
    assert features.feature_dim_for_worker("lpc", cfg) == \
        jax_features.feature_dim_for_worker("lpc", cfg) == 13
