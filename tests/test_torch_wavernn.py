"""The port's WaveRNN vocoder worker (pase_tpu_torch.wavernn) against
``pase_tpu/wavernn.py`` on the CPU, on the same weights and the same
seeded numpy inputs: the conditioning network, the head in RAW and MOL
modes, the codecs and losses, the draws and ``generate``, and a model
step with a wavernn worker.

The JAX side runs at 'highest' matmul precision (tests/conftest.py), its
GRUs as ``lax.scan``s; the torch side in float32 on the CPU.

Bounds (float32 sums in different orders):
  * forwards: max|y_torch - y_jax| <= 1e-5 x max|y_jax|; BatchNorm running
    statistics after a train-mode call: 1e-6 absolute;
  * gradients: 1e-4 x max|g| of each parameter leaf (the smoothing
    kernels up_{i}_kernel included; a bias feeding a BatchNorm: both
    sides below 1e-5 of the encoder's largest gradient);
  * losses: 1e-5 relative;
  * mu-law labels: equal, except where the argument of floor lies within
    4 ulp of an integer (the log1p of XLA and of torch may round to
    either side there);
  * parameters after one Adam step from shared weights: 1e-6 absolute
    where JAX's gradient is at least 1e-4 of its leaf's largest, 2 lr
    elsewhere (Adam's first step moves a weight by lr g / (|g| + 1e-8):
    where g is within rounding of 0, either sign is right);
  * the MoL loss's gradient: 1e-4 of its largest at the samples away from
    its branch at cdf_delta = 1e-5 (a kink);
  * fold_with_overlap / xfade_and_unfold: exactly equal;
  * generate: the teacher-forced logits on its own fed-back samples equal
    the logits of its loop within 1e-4 of their largest.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.core import unfreeze
from flax.traverse_util import flatten_dict

from pase_tpu import wavernn as W
from pase_tpu_torch import wavernn as P
from pase_tpu_torch.checkpoint import (model_state_dict_to_variables,
                                       model_variables_to_state_dict)
from torch_port_common import rel_err
from torch_port_common import port_test_guard  # noqa: F401

FWD_REL = 1e-5
GRAD_REL = 1e-4
LOSS_REL = 1e-5
STATS_ATOL = 1e-6
ADAM_ATOL = 1e-6
ADAM_LIVE_REL = 1e-4
LABEL_ULPS = 4
GEN_REL = 1e-4
# tests/test_wavernn.py's head: frames of 16 features, (4, 4, 10)
HEAD = dict(num_inputs=16, rnn_dims=32, fc_dims=32, bits=8, pad=2,
            upsample_scales=(4, 4, 10), res_out_dims=32)
D_IN, FRAMES = 16, 6


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            flatten_dict(unfreeze(tree), sep="/").items()}


def _perturbed(variables, seed, scale=0.1):
    """Every leaf plus seeded noise; running variances in [0.5, 1.5]."""
    rng = np.random.RandomState(seed)

    def one(path, v):
        v = np.asarray(v)
        if path[-1].key == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, v.shape)
                               .astype(np.float32))
        return jnp.asarray((v + rng.randn(*v.shape) * scale)
                           .astype(np.float32))
    return jax.tree_util.tree_map_with_path(one, variables)


class _Wrap(torch.nn.Module):
    """A module at ``workers.head`` (the model bridge's layout)."""

    def __init__(self, head):
        super().__init__()
        self.workers = torch.nn.ModuleDict({"head": head})


def _load(module, variables):
    flat = {f"{col}/head/{k}": v for col in variables
            for k, v in _flat(variables[col]).items()}
    sd = model_variables_to_state_dict(flat)
    wrap = _Wrap(module)
    wrap.load_state_dict(dict(wrap.state_dict(), **sd), strict=True)
    return flat


def _to_jax(module, tensors):
    """{torch name of ``module``: tensor} -> {'<col>/head/...': array}."""
    return model_state_dict_to_variables(
        {f"workers.head.{k}": t for k, t in tensors.items()})


def _assert_grads(module, g_tree):
    got = _to_jax(module, {k: p.grad for k, p in
                           module.named_parameters()})
    want = {f"params/head/{k}": v for k, v in _flat(g_tree).items()}
    assert set(got) == set(want)
    for k, g in want.items():
        err = np.abs(got[k] - g).max()
        assert err <= GRAD_REL * np.abs(g).max(), (k, err, np.abs(g).max())


def _ntc(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1)))


# ---------------------------------------------------------------------------
# the conditioning network
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
def test_melresnet_matches_jax(train):
    m = np.random.RandomState(1).randn(2, 14, D_IN).astype(np.float32)
    jm = W.MelResNet(compute_dims=16, res_out_dims=8, res_blocks=2, pad=2)
    v = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(m)), 2)
    want, upd = jm.apply(v, jnp.asarray(m), train=train,
                         mutable=["batch_stats"])
    pm = P.MelResNet(D_IN, 16, 8, res_blocks=2, pad=2).train(train)
    _load(pm, v)
    with torch.no_grad():
        got = pm(_ntc(m)).transpose(1, 2).numpy()
    assert got.shape == want.shape == (2, 10, 8)
    assert rel_err(got, want) <= FWD_REL, rel_err(got, want)
    if train:
        stats = _to_jax(pm, {k: b for k, b in pm.state_dict().items()
                             if "running" in k})
        for k, w in _flat(upd["batch_stats"]).items():
            err = np.abs(stats[f"batch_stats/head/{k}"] - w).max()
            assert err <= STATS_ATOL, (k, err)


@pytest.mark.parametrize("train", [False, True])
def test_upsample_network_matches_jax(train):
    """Both streams within 1e-5, and the gradient of sum(mels * r + aux *
    s) within 1e-4 a leaf, the trainable smoothing kernels included."""
    rng = np.random.RandomState(3)
    m = rng.randn(2, FRAMES + 4, D_IN).astype(np.float32)
    r = rng.randn(2, FRAMES * 160, D_IN).astype(np.float32)
    s = rng.randn(2, FRAMES * 160, 8).astype(np.float32)
    jm = W.UpsampleNetwork(upsample_scales=(4, 4, 10), compute_dims=16,
                           res_blocks=2, res_out_dims=8, pad=2)
    v = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(m)), 4,
                   scale=0.02)

    def loss(params):
        (mels, aux), _ = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(m), train=train, mutable=["batch_stats"])
        return jnp.sum(mels * r) + jnp.sum(aux * s), (mels, aux)

    g, (mels, aux) = jax.grad(loss, has_aux=True)(v["params"])
    pm = P.UpsampleNetwork(D_IN, (4, 4, 10), compute_dims=16, res_blocks=2,
                           res_out_dims=8, pad=2).train(train)
    _load(pm, v)
    got_m, got_a = pm(_ntc(m))
    assert got_m.shape == mels.shape == (2, FRAMES * 160, D_IN)
    assert got_a.shape == aux.shape == (2, FRAMES * 160, 8)
    assert rel_err(got_m.detach().numpy(), mels) <= FWD_REL
    assert rel_err(got_a.detach().numpy(), aux) <= FWD_REL
    ((got_m * torch.from_numpy(r)).sum()
     + (got_a * torch.from_numpy(s)).sum()).backward()
    _assert_grads(pm, g)
    assert pm.up_2_kernel.grad is not None and \
        pm.up_2_kernel.grad.abs().max() > 0


def test_stretch_time_matches_jax():
    x = np.random.RandomState(0).randn(2, 5, 3).astype(np.float32)
    want = np.asarray(W.stretch_time(jnp.asarray(x), 4))
    got = P.stretch_time(torch.from_numpy(x), 4, dim=1).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the head
# ---------------------------------------------------------------------------


def _head_pair(mode, seed=0):
    jm = W.WaveRNNMinion(mode=mode, **HEAD)
    rng = np.random.RandomState(seed)
    t = FRAMES * 160
    x = np.clip(rng.randn(2, t) * 0.3, -1, 1).astype(np.float32)
    mels = rng.randn(2, FRAMES + 4, D_IN).astype(np.float32)
    v = _perturbed(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                           jnp.asarray(mels)), seed + 1, scale=0.05)
    pm = P.WaveRNNMinion(D_IN, mode=mode, **HEAD)
    _load(pm, v)
    return jm, v, pm, x, mels


@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_wavernn_head_matches_jax(mode):
    """Train-mode forward within 1e-5; its loss (RAW cross entropy or the
    MoL likelihood against the clean samples) within 1e-5; gradients
    within 1e-4 a leaf. RAW: each side's own loss gradient. MOL: JAX's
    cotangent of the logits pushed through both heads, because the
    likelihood's branch at cdf_delta = 1e-5 is a kink, and a sample
    within rounding of it takes either branch (the loss's own gradient
    is held away from the kink in test_mol_loss_matches_jax)."""
    jm, v, pm, x, mels = _head_pair(mode, seed=2)
    target = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)

    def head(params):
        y, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                        jnp.asarray(x), jnp.asarray(mels), train=True,
                        mutable=["batch_stats"])
        return y

    def loss_of(y):
        if mode == "RAW":
            return W.raw_loss(y, jnp.asarray(target), bits=8)
        return W.discretized_mix_logistic_loss(y, jnp.asarray(target))

    want, vjp = jax.vjp(head, v["params"])
    want_loss, g_y = jax.value_and_grad(loss_of)(want)
    g, = vjp(g_y)
    pm.train()
    y = pm(torch.from_numpy(x), _ntc(mels))
    assert y.shape == want.shape == (2, FRAMES * 160, pm.n_classes)
    assert rel_err(y.detach().numpy(), want) <= FWD_REL
    t = torch.from_numpy(target)
    got_loss = (P.raw_loss(y, t, bits=8) if mode == "RAW"
                else P.discretized_mix_logistic_loss(y, t))
    assert abs(got_loss.item() - float(want_loss)) <= \
        LOSS_REL * abs(float(want_loss))
    if mode == "RAW":
        got_loss.backward()
    else:
        y.backward(torch.from_numpy(np.asarray(g_y)))
    _assert_grads(pm, g)


def test_wavernn_head_adam_step_matches_optax():
    """One Adam step of the head bridged from JAX equals optax.adam's
    within 1e-6; the port holds exactly JAX's trainable numbers (no
    parameter for the GRUs' absent r / z hidden biases) and those rows
    stay 0."""
    jm, v, pm, x, mels = _head_pair("RAW", seed=5)
    target = jnp.asarray(x)
    lr = 1e-3

    def loss(params):
        y, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                        jnp.asarray(x), jnp.asarray(mels), train=True,
                        mutable=["batch_stats"])
        return W.raw_loss(y, target, bits=8)

    tx = optax.adam(lr)
    grads = jax.grad(loss)(v["params"])
    upd, _ = tx.update(grads, tx.init(v["params"]), v["params"])
    want = _flat(optax.apply_updates(v["params"], upd))
    assert sum(p.numel() for p in pm.parameters()) == \
        sum(w.size for w in want.values())
    opt = torch.optim.Adam(pm.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    pm.train()
    P.raw_loss(pm(torch.from_numpy(x), _ntc(mels)), torch.from_numpy(x),
               bits=8).backward()
    opt.step()
    got = _to_jax(pm, dict(pm.named_parameters()))
    g_flat = _flat(grads)
    for k, w in want.items():
        diff = np.abs(got[f"params/head/{k}"] - w)
        live = np.abs(g_flat[k]) >= ADAM_LIVE_REL * np.abs(g_flat[k]).max()
        assert diff[live].max() <= ADAM_ATOL, (k, diff[live].max())
        assert diff.max() <= 2 * lr, (k, diff.max())
    for cell in (pm.rnn1_cell, pm.rnn2_cell):
        assert torch.count_nonzero(cell.weights()[3][:2 * 32]) == 0


# ---------------------------------------------------------------------------
# codecs and losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 9])
def test_mu_law_labels_match_jax(bits):
    rng = np.random.RandomState(bits)
    x = np.concatenate([rng.uniform(-1, 1, 20000),
                        [-1.0, -0.999, 0.0, 1e-8, 0.5, 0.999, 1.0]])
    x = x.astype(np.float32)
    mu = 2 ** bits
    want = np.asarray(W.encode_mu_law(jnp.asarray(x), mu))
    got = P.encode_mu_law(torch.from_numpy(x), mu).numpy()
    differ = np.flatnonzero(got != want)
    if len(differ):
        xd = x[differ].astype(np.float32)
        fx = np.sign(xd) * np.log1p((mu - 1) * np.abs(xd)) / np.log1p(mu - 1)
        arg = ((fx + 1) / 2 * (mu - 1) + 0.5).astype(np.float32)
        near = np.abs(arg - np.round(arg)) <= LABEL_ULPS * np.spacing(arg)
        assert near.all(), (x[differ][~near], got[differ], want[differ])
        assert np.abs(got[differ] - want[differ]).max() == 1
    assert len(differ) <= 10
    y = np.asarray(W.decode_mu_law(jnp.asarray(want, jnp.float32), mu))
    np.testing.assert_allclose(
        P.decode_mu_law(torch.from_numpy(want).float(), mu).numpy(), y,
        rtol=1e-6, atol=1e-7)
    z = rng.uniform(-1, 1, 100).astype(np.float32)
    np.testing.assert_allclose(
        P.decode_mu_law(torch.from_numpy(z), mu, from_labels=False).numpy(),
        np.asarray(W.decode_mu_law(jnp.asarray(z), mu, from_labels=False)),
        rtol=1e-6, atol=1e-7)


def test_raw_loss_matches_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 300, 512).astype(np.float32) * 3
    wav = rng.uniform(-0.99, 0.99, (2, 300)).astype(np.float32)
    want = float(W.raw_loss(jnp.asarray(logits), jnp.asarray(wav), bits=9))
    got = P.raw_loss(torch.from_numpy(logits), torch.from_numpy(wav),
                     bits=9).item()
    assert abs(got - want) <= LOSS_REL * abs(want)
    # a target beyond [-1, 1] has no class: NaN, as JAX's fill
    wav[0, 0] = 1.5
    assert np.isnan(float(W.raw_loss(jnp.asarray(logits),
                                     jnp.asarray(wav), bits=9)))
    assert np.isnan(P.raw_loss(torch.from_numpy(logits),
                               torch.from_numpy(wav), bits=9).item())


def test_mol_loss_matches_jax():
    """The MoL likelihood with targets at the edges (beyond +-0.999) and
    log scales below the -7 floor, where the clamps and the pdf branch
    act."""
    rng = np.random.RandomState(1)
    logits = rng.randn(3, 200, 30).astype(np.float32) * 2
    logits[0, :50, 20:] = -12.0          # scales below the floor
    target = rng.uniform(-1, 1, (3, 200)).astype(np.float32)
    target[1, :10] = -1.0
    target[1, 10:20] = 1.0
    target[2, :20] = logits[2, :20, 10]  # on a mean: narrow pdf branch
    want, g = jax.value_and_grad(W.discretized_mix_logistic_loss)(
        jnp.asarray(logits), jnp.asarray(target))
    lt = torch.from_numpy(logits).requires_grad_()
    got = P.discretized_mix_logistic_loss(lt, torch.from_numpy(target))
    assert abs(got.item() - float(want)) <= LOSS_REL * abs(float(want))
    got.backward()
    # the gradient of every sample none of whose components lies within
    # 1e-3 (relative) of the branch at cdf_delta = 1e-5, a kink
    mid = logits[..., 10:20]
    inv = np.exp(-np.maximum(logits[..., 20:], -7.0))
    c = target[..., None] - mid
    cdf = (1 / (1 + np.exp(-inv * (c + 1 / 65535)))
           - 1 / (1 + np.exp(-inv * (c - 1 / 65535))))
    away = ~np.any(np.abs(cdf / 1e-5 - 1) <= 1e-3, axis=-1)
    g = np.asarray(g)
    assert away.mean() > 0.99
    err = np.abs(lt.grad.numpy() - g)[away].max()
    assert err <= GRAD_REL * np.abs(g).max(), err


def test_fold_and_xfade_equal_jax():
    rng = np.random.RandomState(0)
    for total, target, overlap in ((1000, 200, 50), (1234, 300, 40),
                                   (950, 200, 50)):
        x = rng.randn(total, 3).astype(np.float32)
        folded = P.fold_with_overlap(x, target, overlap)
        np.testing.assert_array_equal(
            folded, W.fold_with_overlap(x, target, overlap))
        y = rng.randn(folded.shape[0], folded.shape[1]).astype(np.float32)
        np.testing.assert_array_equal(P.xfade_and_unfold(y, overlap),
                                      W.xfade_and_unfold(y, overlap))


# ---------------------------------------------------------------------------
# draws and generation
# ---------------------------------------------------------------------------


def test_mol_sampling_shape_range_and_seed():
    logits = torch.from_numpy(np.random.RandomState(0).randn(2, 5, 30)
                              .astype(np.float32))
    a = P.sample_from_discretized_mix_logistic(
        logits, torch.Generator().manual_seed(1))
    b = P.sample_from_discretized_mix_logistic(
        logits, torch.Generator().manual_seed(1))
    assert a.shape == (2, 5) and torch.equal(a, b)
    assert a.abs().max() <= 1.0
    # a sharp component at 0.25 with tiny scale: the draws sit on it
    sharp = torch.full((4000, 30), -7.0)
    sharp[:, :10] = -30.0
    sharp[:, 0] = 30.0
    sharp[:, 10] = 0.25
    s = P.sample_from_discretized_mix_logistic(
        sharp, torch.Generator().manual_seed(2))
    assert (s - 0.25).abs().max() < 0.02


def test_categorical_follows_the_softmax():
    logits = torch.log(torch.tensor([0.1, 0.2, 0.7]))
    draws = P.categorical(logits.expand(20000, 3),
                          torch.Generator().manual_seed(0))
    freq = torch.bincount(draws, minlength=3).float() / 20000
    assert torch.allclose(freq, torch.tensor([0.1, 0.2, 0.7]), atol=0.015)


@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_generate_is_consistent_with_teacher_forcing(mode):
    """generate's shape and range, its draws repeat with a seed, and the
    teacher-forced forward (BatchNorm in eval) on its own fed-back
    samples, shifted by one, gives the logits its loop computed."""
    _, _, pm, _, mels = _head_pair(mode, seed=7)
    m = _ntc(mels[:, :4 + 2])             # 2 frames, 320 samples
    wav, fed, logits = P.generate(pm, m, torch.Generator().manual_seed(3),
                                  mode=mode, bits=8, return_logits=True)
    assert wav.shape == fed.shape == (2, 320)
    assert logits.shape == (2, 320, pm.n_classes)
    assert wav.abs().max() <= 1.0 + 1e-5
    again = P.generate(pm, m, torch.Generator().manual_seed(3), mode=mode,
                       bits=8)
    assert torch.equal(again, wav)
    assert pm.training                   # generate restores the mode
    x_prev = torch.nn.functional.pad(fed, (1, 0))[:, :-1]
    with torch.no_grad():
        tf = pm.eval()(x_prev, m)
    assert rel_err(tf.numpy(), logits.numpy()) <= GEN_REL


def test_generate_matches_the_jax_shape_contract():
    """JAX's generate on the same weights returns the same shape and a
    waveform in [-1, 1] (its draws are its own)."""
    jm, v, pm, _, mels = _head_pair("RAW", seed=8)
    want = W.generate(jm, v, jnp.asarray(mels[:1, :6]),
                      jax.random.PRNGKey(2), mode="RAW", bits=8)
    got = P.generate(pm, _ntc(mels[:1, :6]), torch.Generator().manual_seed(2),
                     mode="RAW", bits=8)
    assert got.shape == want.shape == (1, 320)
    assert float(jnp.abs(want).max()) <= 1 + 1e-5 and \
        got.abs().max() <= 1 + 1e-5


# ---------------------------------------------------------------------------
# the model step with a wavernn worker (tests/test_wavernn.py's settings)
# ---------------------------------------------------------------------------

STEP_FE = {"kwidths": [65, 10, 5, 5], "strides": [1, 10, 4, 4],
           "fmaps": [16, 16, 32, 32], "emb_dim": 32, "norm_out": True}
STEP_WORKERS = {"regr": [
    {"num_outputs": 39, "dropout": 0, "hidden_size": 32, "hidden_layers": 1,
     "name": "mfcc", "r": 1, "loss": "MSELoss", "skip": False},
    {"name": "wavernn", "type": "wavernn", "loss": "WaveRNNLoss",
     "num_inputs": 32, "rnn_dims": 16, "fc_dims": 16, "bits": 4,
     "mode": "RAW", "pad": 2, "res_out_dims": 8,
     "upsample_scales": [4, 4, 10], "loss_weight": 0.5}],
    "cls": []}
# biases that feed a BatchNorm, which removes them: zero gradient
STEP_BN_CANCELLED = {"frontend/blocks_1/conv/bias",
                     "frontend/blocks_2/conv/bias",
                     "frontend/blocks_3/conv/bias", "frontend/W/bias"}


@pytest.fixture(scope="module")
def wavernn_step(tmp_path_factory):
    """The JAX Trainer of tests/test_wavernn.py's step (batch 8 x 1600),
    its initial state, one step's new state and losses, and the batch."""
    from pase_tpu.data.dataset import SyntheticChunkBatcher as JaxBatcher
    from pase_tpu.parallel.mesh import get_mesh
    from pase_tpu.trainer import Trainer as JaxTrainer
    from pase_tpu.trainer import TrainState
    from pase_tpu.optim import build_optimizer
    from pase_tpu.scheduling import init_policy_state
    tmp = tmp_path_factory.mktemp("wavernn_step")
    cfg = dict(backprop_mode="base", hop=160, bpe=1, epoch=1, batch_size=8,
               chunk_size=1600, log_freq=1, fe_lr=5e-4, min_lr=5e-4,
               lr_mode="poly", save_path=str(tmp / "jax"))
    jtr = JaxTrainer(STEP_FE, STEP_WORKERS, cfg,
                     mesh=get_mesh(devices=jax.devices()[:1]))
    key = jax.random.PRNGKey(0)
    raw = next(iter(JaxBatcher(8, 1600, seed=0)))
    prepared = jax.jit(jtr.prepare)({k: jnp.asarray(v)
                                     for k, v in raw.items()}, key)
    variables = jax.jit(lambda r, b: jtr.model.init(r, b, train=False))(
        {"params": key, "sample": key, "dropout": key}, prepared)
    jtr._tx, jtr._scheds = build_optimizer(
        variables["params"], fe_lr=5e-4, min_lr=5e-4, lr_mode="poly",
        epochs=1, bpe=1)
    state = TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jtr._tx.init(variables["params"]),
        policy_state=init_policy_state(jtr.num_workers),
        alpha=jnp.ones((jtr.num_workers,)), rng=key,
        step=jnp.zeros((), jnp.int32))
    params = _flat(state.params)
    stats = _flat(state.batch_stats)
    new_state, losses = jtr._make_train_step()(
        jax.tree.map(lambda a: jnp.array(a, copy=True), state),
        {k: jnp.asarray(v) for k, v in raw.items()})
    return params, stats, new_state, losses, raw, cfg, tmp


def test_wavernn_model_step_matches_jax(wavernn_step):
    """One base-policy step with a wavernn worker: per-worker losses
    within 1e-5, gradients (from the JAX step's Adam first moment) within
    1e-4 a leaf, BatchNorm running statistics within 1e-6."""
    from pase_tpu_torch.checkpoint import load_model_variables
    from pase_tpu_torch.trainer import Trainer
    params, stats, new_state, jlosses, raw, cfg, tmp = wavernn_step
    tr = Trainer(STEP_FE, STEP_WORKERS, dict(cfg, save_path=str(tmp / "p")),
                 device="cpu")
    flat = {f"params/{k}": v for k, v in params.items()}
    flat.update({f"batch_stats/{k}": v for k, v in stats.items()})
    load_model_variables(tr.model, flat)
    losses = tr.train_step(raw)
    for name in tr.ordered_names + ["total"]:
        got, want = float(losses[name]), float(jlosses[name])
        assert abs(got - want) <= LOSS_REL * abs(want), (name, got, want)
    grads = {}
    for group in new_state.opt_state.inner_states.values():
        for k, mu in flatten_dict(unfreeze(group.inner_state[0].mu),
                                  sep="/").items():
            if not isinstance(mu, optax.MaskedNode):
                grads[k] = np.asarray(mu, np.float64) / 0.1
    port = model_state_dict_to_variables(
        {k: p.grad for k, p in tr.model.named_parameters()})
    assert {k[len("params/"):] for k in port} == set(grads)
    assert "wavernn/upsample/up_0_kernel" in grads
    fe_max = max(np.abs(g).max() for k, g in grads.items()
                 if k.startswith("frontend/"))
    for k, g in grads.items():
        got = port["params/" + k]
        if k in STEP_BN_CANCELLED:
            assert np.abs(g).max() <= 1e-5 * fe_max, k
            assert np.abs(got).max() <= 1e-5 * fe_max, k
            continue
        err = np.abs(got - g).max()
        assert err <= GRAD_REL * np.abs(g).max(), (k, err, np.abs(g).max())
    port_stats = model_state_dict_to_variables(
        {k: b for k, b in tr.model.state_dict().items() if "running" in k})
    for k, v in _flat(new_state.batch_stats).items():
        err = np.abs(port_stats["batch_stats/" + k] - v).max()
        assert err <= STATS_ATOL, (k, err)


def test_wavernn_worker_builds_from_the_recipe_cfg():
    """cfg/workers/workers+wavernn.cfg builds with PASE+: the head at its
    published widths (rnn_dims 512, 512 classes, aux 32)."""
    from pase_tpu_torch.model import build_pase
    model, meta = build_pase("cfg/frontend/PASE+.cfg",
                             "cfg/workers/workers+wavernn.cfg")
    head = model.workers["wavernn"]
    assert isinstance(head, P.WaveRNNMinion)
    assert head.n_classes == 512 and head.aux_dims == 32
    assert head.I.weight.shape == (512, 1 + 256 + 32)
    assert head.rnn2_cell.weight_ih.shape == (3 * 512, 512 + 32)


def test_the_wavernn_recipe_parses_and_trains_a_step(tmp_path, monkeypatch):
    """recipes/run_pase_wavernn.sh's flags with --synthetic pass every
    check of the port's CLI; with a narrow encoder and bank in their
    place the CLI builds its trainer (bf16, the recipe's lr schedule),
    whose step logs a finite wavernn loss. The epoch loop is not run
    here (chip_smoke.py phase 20 runs the recipe's epoch on the card)."""
    import json
    import math
    import chip_smoke
    from pase_tpu_torch import train as port_cli
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    from pase_tpu_torch.trainer import Trainer
    argv = chip_smoke.recipe_argv("recipes/run_pase_wavernn.sh")
    assert argv[argv.index("--net_cfg") + 1] == \
        "cfg/workers/workers+wavernn.cfg"
    opts = port_cli.build_argparser().parse_args(
        argv + ["--synthetic", "--device", "cpu"])
    port_cli.compat_notes(opts)
    port_cli.check_ported(opts)
    fe, wk = tmp_path / "fe.cfg", tmp_path / "wk.cfg"
    fe.write_text(json.dumps(STEP_FE))
    wk.write_text(json.dumps(STEP_WORKERS))
    monkeypatch.setattr(Trainer, "train_", lambda self, *a, **k: None)
    flags = [f for f in argv if f not in ("--dtrans_cfg",
                                          "cfg/distortions/pase+.cfg")]
    tr = port_cli.main(flags + [
        "--synthetic", "--device", "cpu", "--net_cfg", str(wk), "--fe_cfg",
        str(fe), "--batch_size", "2", "--chunk_size", "1600",
        "--save_path", str(tmp_path / "run")])
    assert tr.cfg["compute_dtype"] == "bfloat16"
    assert tr.cfg["lr_mode"] == "poly" and tr.cfg["random_scale"]
    losses = tr.train_step(next(iter(SyntheticChunkBatcher(2, 1600))))
    assert math.isfinite(float(losses["wavernn"]))


def test_relu_kinks_are_read_and_forced():
    """grad_parity.prelu_signs reads each relu module's input of the head
    and, forced to the signs read, gives the same logits; forced to the
    opposite signs, others."""
    from pase_tpu_torch.grad_parity import prelu_signs
    _, _, pm, x, mels = _head_pair("RAW", seed=9)
    pm.eval()
    seen = {}
    with torch.no_grad(), prelu_signs(pm, record=seen):
        want = pm(torch.from_numpy(x), _ntc(mels))
    assert {"act1", "act2", "upsample.resnet.act_in",
            "upsample.resnet.res_0_act"} <= set(seen)
    with torch.no_grad():
        with prelu_signs(pm, force={k: v > 0 for k, v in seen.items()}):
            same = pm(torch.from_numpy(x), _ntc(mels))
        with prelu_signs(pm, force={k: v <= 0 for k, v in seen.items()}):
            other = pm(torch.from_numpy(x), _ntc(mels))
    assert torch.equal(same, want)
    assert not torch.allclose(other, want)


def test_kernel_time_union():
    """profiling's covered time: overlapping kernels count once."""
    from pase_tpu_torch.profiling import _union
    assert _union([]) == 0
    assert _union([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17


@pytest.mark.parametrize("name,kind", [
    ("void elemWiseRNNcell<float, float, float, (cudnnRNNMode_t)3, "
     "(cudnnRNNBiasMode_t)2>(int, int, int, int, int, bool)", "rnn"),
    ("void GRU_elementWise_bp1<float, float, float>(int, int, float*)",
     "rnn"),
    ("void LSTM_elementWise_bp1<float, float, float>(int, int, float*)",
     "rnn"),
    ("void at::native::(anonymous namespace)::gru_cell_forward<float, "
     "float, int>(at::cuda::detail::TensorInfo<float, int>)", "rnn"),
    # a cuDNN convolution whose CUTLASS name holds 'Congruous'
    ("_ZN17cutlass__5x_cudnn6KernelINS_4conv6kernel23ImplicitGemmConvolution"
     "INS1_11threadblock22ImplicitGemmMultistageINS_4gemm9GemmShapeILi64ELi"
     "64ELi64EEENS4_52Conv2dWgradOutputGradientTileAccessIteratorOptimized"
     "INS_6layout40TensorOpMultiplicandCongruous", "conv wgrad"),
    ("void (anonymous namespace)::qrnn_pool_bwd_kernel(float const*)",
     "qrnn bwd")])
def test_profiler_names_the_recurrent_kernels(name, kind):
    """cuDNN's recurrent kernels and ATen's fused cells are 'rnn'; a
    convolution kernel is not, nor the QRNN's own."""
    from pase_tpu_torch.profiling import kernel_kind
    assert kernel_kind(name) == kind


class _Event:
    """A stand-in for a profiler's host event."""

    def __init__(self, name, start, end, thread, annotation=False):
        self._v = (name, start, end, thread, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def start_thread_id(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def test_profiler_places_a_launch_in_its_span():
    """A launch counts in the innermost span open on its thread; on the
    autograd engine's thread (inside an evaluate_function frame) in the
    innermost span open on any thread, else pase.backward; elsewhere in
    'other'."""
    from pase_tpu_torch.profiling import _Spans
    where = _Spans([
        _Event("pase.forward", 0, 100, 1, True),
        _Event("pase.quantizer", 40, 60, 1, True),
        _Event("pase.backward", 200, 300, 1, True),
        _Event("pase.discriminator", 400, 600, 1, True),
        _Event("pase.forward", 0, 100, 9, False),      # not an annotation
        _Event("autograd::engine::evaluate_function: MmBackward0",
               210, 250, 2),
        _Event("autograd::engine::evaluate_function: AddBackward0",
               420, 430, 2),
        _Event("autograd::engine::evaluate_function: MulBackward0",
               700, 710, 2)])
    assert where.of(1, 10) == "pase.forward"
    assert where.of(1, 50) == "pase.quantizer"
    assert where.of(1, 150) == "other"
    assert where.of(2, 220) == "pase.backward"
    assert where.of(2, 425) == "pase.discriminator"
    assert where.of(2, 705) == "pase.backward"
    assert where.of(2, 260) == "other"
    assert where.of(9, 50) == "other"


def test_head_under_bf16_runs_where_jax_does(monkeypatch):
    """Under compute_dtype(bfloat16) the JAX head runs its 22 MelResNet
    convs in bf16 and everything else (the smoothing convs, the Denses,
    the GRUs) in float32, its flax modules having no dtype: the port's
    bf16 convs are as many, its Denses and GRUs read float32, and the
    logits (float32 on both sides) agree within 2^-7 of their largest
    (one bf16 rounding of the conv sums, then float32)."""
    import collections
    from pase_tpu.precision import compute_dtype as jax_compute_dtype
    from pase_tpu_torch import nn as pnn
    from pase_tpu_torch import precision
    jm, v, pm, x, mels = _head_pair("RAW", seed=10)
    with jax_compute_dtype(jnp.bfloat16):
        jaxpr = jax.make_jaxpr(lambda a, b: jm.apply(v, a, b))(
            jnp.asarray(x), jnp.asarray(mels))
        want = np.asarray(jm.apply(v, jnp.asarray(x), jnp.asarray(mels)))
    convs = collections.Counter(
        str(e.invars[0].aval.dtype) for e in jaxpr.jaxpr.eqns
        if e.primitive.name == "conv_general_dilated")
    dots = {str(e.invars[0].aval.dtype) for e in jaxpr.jaxpr.eqns
            if e.primitive.name == "dot_general"}
    assert convs == {"bfloat16": 22, "float32": 3} and dots == {"float32"}

    low = []
    real = pnn._low_precision
    monkeypatch.setattr(pnn, "_low_precision", lambda conv, x_, *a, **k: (
        low.append(x_.dtype), real(conv, x_, *a, **k))[1])
    reads = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: reads.append(inp[0].dtype))
        for m in pm.modules()
        if isinstance(m, (torch.nn.Linear, pnn.FlaxRNN))]
    pm.eval()
    with precision.compute_dtype(torch.bfloat16), torch.no_grad():
        got = pm(torch.from_numpy(x), _ntc(mels))
    for h in hooks:
        h.remove()
    assert low == [torch.bfloat16] * 22
    assert reads == [torch.float32] * 6
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert rel_err(got.numpy(), want) <= 2.0 ** -7, rel_err(got.numpy(), want)
