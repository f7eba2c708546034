"""The backprop policies of the port (pase_tpu_torch/scheduling.py and the
trainer's step) against the JAX package, on the CPU.

* ``apply_policy`` of each deterministic mode on seeded loss vectors and
  states, ``min_norm_weights`` on seeded gradients: 1e-6 relative.
* Two trainer steps of each of the eight modes from the same weights and
  batches as the JAX Trainer's (the small PASE of
  tests/test_torch_attention.py, ZNorm'd targets, SGD in both groups so
  that the second step starts from weights that agree to rounding):
  per-worker losses, the policy's weights, the next alpha and the policy
  state within 1e-5 relative (MGD's alpha 1e-4). select_half's and
  dropout's masks are the port's own draws: the JAX step's mask (from its
  key) is injected. The MGD case also asserts that no Frank-Wolfe argmin
  is a tie within 1e-6 on its input, so the weights are not decided by
  rounding.
* select_half / dropout against their law over 4000 draws of the
  trainer's seeded policy stream: each frequency within 4 sigma.
"""

from math import comb

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import unflatten_dict

from pase_tpu.data.dataset import SyntheticChunkBatcher as JaxBatcher
from pase_tpu.optim import build_optimizer as jax_build_optimizer
from pase_tpu.parallel.mesh import get_mesh
from pase_tpu.scheduling import PolicyState as JaxPolicyState
from pase_tpu.scheduling import apply_policy as jax_apply_policy
from pase_tpu.scheduling import init_policy_state as jax_init_policy
from pase_tpu.scheduling import min_norm_weights as jax_min_norm
from pase_tpu.trainer import Trainer as JaxTrainer
from pase_tpu.trainer import TrainState
from pase_tpu_torch import scheduling
from pase_tpu_torch import trainer as port_trainer
from pase_tpu_torch.checkpoint import load_model_variables
from pase_tpu_torch.data.dataset import SyntheticChunkBatcher, step_seed
from pase_tpu_torch.data.pipeline import compute_stats
from pase_tpu_torch.model import parse_workers_cfg
from pase_tpu_torch.trainer import Trainer
from test_torch_attention import BANK
from test_torch_train import SMALL_FE
from torch_port_common import flat_variables, port_test_guard  # noqa: F401

KW = dict(dropout_rate=0.6, delta=1.2, temp=2.0, alpha_ema=0.3)
CFG_KW = dict(dropout_rate=0.6, delta=1.2, temp=2.0, alpha=0.3)
RANDOM_MODES = ("select_half", "dropout")


def _policy_state(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.rand(n).astype(np.float32) for _ in range(3)] + [seed]


@pytest.mark.parametrize("mode", ["base", "select_one", "hyper_volume",
                                  "softmax", "adaptive", "MGD"])
def test_apply_policy_matches_jax(mode):
    rng = np.random.RandomState(13)
    losses = (rng.rand(6) * 3).astype(np.float32)
    q, last, pi, count = _policy_state(6, 5)
    mg = rng.dirichlet(np.ones(6)).astype(np.float32)
    jst = JaxPolicyState(q=jnp.asarray(q), last_loss=jnp.asarray(last),
                         pi=jnp.asarray(pi),
                         count=jnp.asarray(count, jnp.int32))
    w, a, st = jax_apply_policy(mode, jnp.asarray(losses), jst,
                                jax.random.PRNGKey(0), mgda_alpha=
                                jnp.asarray(mg), **KW)
    pst = scheduling.PolicyState(
        q=torch.from_numpy(q), last_loss=torch.from_numpy(last),
        pi=torch.from_numpy(pi), count=torch.tensor(count,
                                                    dtype=torch.int32))
    pw, pa, pst = scheduling.apply_policy(
        mode, torch.from_numpy(losses), pst, None,
        mgda_alpha=torch.from_numpy(mg), **KW)
    for got, want in ((pw, w), (pa, a)) + tuple(zip(pst, st)):
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=1e-6)
    if mode == "select_one":
        assert int(pst.count) == count + 1 and pw[(count + 1) % 6] == 1


def test_min_norm_weights_match_jax():
    rng = np.random.RandomState(14)
    g = rng.randn(5, 300).astype(np.float32)
    g[1] = 0.8 * g[0] + 0.2 * g[1]
    want = np.asarray(jax_min_norm(jnp.asarray(g)))
    got = scheduling.min_norm_weights(torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert abs(got.sum() - 1) < 1e-6 and (got >= 0).all()


def _frank_wolfe_gaps(grads):
    """The gap between the smallest and the second smallest entry of G w
    at each Frank-Wolfe iteration of ``min_norm_weights`` (float64)."""
    g = grads / np.maximum(np.linalg.norm(grads, axis=1, keepdims=True),
                           1e-8)
    gram = g @ g.T
    n = gram.shape[0]
    w = np.ones(n) / n
    gaps = []
    for _ in range(scheduling.FW_ITERS):
        v = gram @ w
        s = np.sort(v)
        gaps.append(s[1] - s[0])
        d = np.eye(n)[np.argmin(v)] - w
        den = d @ gram @ d
        gamma = np.clip(-(w @ gram @ d) / den if den > 1e-12 else 0, 0, 1)
        w = w + gamma * d
    return np.array(gaps)


@pytest.mark.parametrize("mode,n", [("select_half", 5), ("select_half", 4),
                                    ("dropout", 5)])
def test_random_policies_follow_their_law(mode, n):
    """4000 steps of the trainer's policy stream (a generator seeded with
    step_seed(seed + 5, k) at step k): select_half's share of 3-worker
    masks and each worker's inclusion, dropout's keep rate per worker,
    each within 4 sigma of the law."""
    gen = torch.Generator()
    masks = []
    for k in range(4000):
        gen.manual_seed(step_seed(2 + 5, k))
        w, _, _ = scheduling.apply_policy(
            mode, torch.ones(n), scheduling.init_policy_state(n), gen,
            dropout_rate=0.6)
        masks.append(w.numpy())
    masks = np.array(masks)
    assert set(np.unique(masks)) <= {0.0, 1.0}

    def within(freq, p):
        return abs(freq - p) <= 4 * np.sqrt(p * (1 - p) / len(masks))

    if mode == "dropout":
        for j in range(n):
            assert within(masks[:, j].mean(), 0.6), (j, masks[:, j].mean())
        return
    sizes = masks.sum(axis=1)
    assert set(np.unique(sizes)) <= {3.0, 4.0}
    p3 = comb(n, 3) / (comb(n, 3) + comb(n, 4))
    assert within((sizes == 3).mean(), p3), (sizes == 3).mean()
    inclusion = (3 * p3 + 4 * (1 - p3)) / n
    for j in range(n):
        assert within(masks[:, j].mean(), inclusion), j


def _cfg(tmp, mode):
    return dict(backprop_mode=mode, hop=160, bpe=100, epoch=10,
                batch_size=2, chunk_size=4800, log_freq=100, fe_lr=1e-3,
                min_lr=1e-3, lr_mode="poly", fe_opt="sgd", min_opt="sgd",
                save_path=str(tmp), **CFG_KW)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX Trainer on the small PASE (SGD, ZNorm'd targets) with
    randomized BatchNorm / PReLU parameters, its state and two batches."""
    tmp = tmp_path_factory.mktemp("policies")
    stats = compute_stats(SyntheticChunkBatcher(2, 4800, seed=4),
                          parse_workers_cfg(BANK), max_batches=1,
                          device="cpu")
    jtr = JaxTrainer(SMALL_FE, BANK, _cfg(tmp / "jax", "base"), stats=stats,
                     mesh=get_mesh(devices=jax.devices()[:1]))
    key = jax.random.PRNGKey(0)
    dummy = {k: jnp.zeros((2, 4800))
             for k in ("chunk", "chunk_ctxt", "chunk_rand")}
    prepared = jax.jit(jtr.prepare)(dummy, key)
    v = jax.jit(lambda b: jtr.model.init(
        {"params": key, "sample": key, "dropout": key}, b, train=False))(
        prepared)
    flat = flat_variables(v)
    rng = np.random.RandomState(7)
    for k, a in flat.items():
        if k.endswith("norm/weight"):
            flat[k] = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif k.endswith("norm/bias"):
            flat[k] = (rng.randn(*a.shape) * 0.1).astype(np.float32)
        elif k.endswith("act/weight"):
            flat[k] = rng.uniform(0.0, 0.3, a.shape).astype(np.float32)
    tree = unflatten_dict({k: jnp.asarray(a) for k, a in flat.items()},
                          sep="/")
    jtr._tx, jtr._scheds = jax_build_optimizer(
        tree["params"], fe_opt="sgd", min_opt="sgd", fe_lr=1e-3,
        min_lr=1e-3, lr_mode="poly", epochs=jtr.epochs, bpe=jtr.bpe)
    state = TrainState(
        params=tree["params"], batch_stats=tree["batch_stats"],
        opt_state=jtr._tx.init(tree["params"]),
        policy_state=jax_init_policy(jtr.num_workers),
        alpha=jnp.ones((jtr.num_workers,)), rng=key,
        step=jnp.zeros((), jnp.int32))
    it = iter(JaxBatcher(2, 4800, seed=3))
    return jtr, state, flat, stats, [next(it) for _ in range(2)], tmp


def _jax_weights(jtr, state, losses, mode):
    """The JAX step's policy weights: its apply_policy on its own loss
    vector, state and policy key (the 5th of its rng split)."""
    k_pol = jax.random.split(state.rng, 5)[4]
    vec = jnp.asarray([losses[n] for n in jtr.ordered_names])
    w, _, _ = jax_apply_policy(mode, vec, state.policy_state, k_pol,
                               mgda_alpha=jnp.ones_like(vec), **KW)
    return np.asarray(w)


def _run_mode(setup, mode, record=None):
    """Two steps of the JAX Trainer and of the port from the same state:
    [(JAX losses, weights, alpha, policy state), ...] and the same of
    the port."""
    jtr, state, flat, stats, batches, tmp = setup
    jtr.mode, jtr.cfg["backprop_mode"] = mode, mode
    step = jtr._make_train_step()
    state = jax.tree.map(lambda a: jnp.array(a, copy=True), state)
    tr = Trainer(SMALL_FE, BANK, _cfg(tmp / mode, mode), stats=stats,
                 device="cpu")
    load_model_variables(tr.model, flat)
    jax_out, port_out = [], []
    for raw in batches:
        # the jitted step donates its input state
        before = jax.tree.map(lambda a: jnp.array(a, copy=True), state)
        state, jl = step(state, {k: jnp.asarray(v) for k, v in raw.items()})
        jl = {k: float(v) for k, v in jl.items()}
        w = _jax_weights(jtr, before, jl, mode)
        jax_out.append((jl, w, np.asarray(state.alpha),
                        [np.asarray(x) for x in state.policy_state]))
        inject = torch.tensor(w) if mode in RANDOM_MODES else None
        pl = tr.train_step(raw, policy_weights=inject)
        port_out.append(({k: float(v) for k, v in pl.items()},
                         tr.last_weights.numpy(), tr.alpha.numpy(),
                         [x.numpy() for x in tr.policy_state]))
    return jax_out, port_out, tr


def _check(jax_out, port_out, names, alpha_rtol=1e-5):
    for (jl, jw, ja, jst), (pl, pw, pa, pst) in zip(jax_out, port_out):
        for n in names + ["total"]:
            assert abs(pl[n] - jl[n]) <= 1e-5 * abs(jl[n]), (n, pl[n],
                                                             jl[n])
        np.testing.assert_allclose(pw, jw, rtol=1e-5)
        np.testing.assert_allclose(pa, ja, rtol=alpha_rtol)
        for got, want in zip(pst, jst):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mode", ["base", "select_one", "select_half",
                                  "dropout", "hyper_volume", "softmax",
                                  "adaptive"])
def test_two_policy_steps_match_the_jax_trainer(setup, mode):
    jax_out, port_out, tr = _run_mode(setup, mode)
    assert tr.regu_names == ["regu_cchunk"]
    assert tr.ordered_names == ["mi", "cmi", "mfcc", "prosody"]
    _check(jax_out, port_out, tr.ordered_names)
    if mode == "select_one":
        assert [list(w) for _, w, _, _ in port_out] == [
            [0, 1, 0, 0], [0, 0, 1, 0]]


def test_two_mgd_steps_match_the_jax_trainer(setup, monkeypatch):
    """MGD (the JAX step's jacrev compiles once, here): alpha within 1e-4,
    and the Frank-Wolfe argmins of the port's input are not ties."""
    seen = []
    real = port_trainer.mgda_rep_weights

    def record(grads):
        seen.append(grads.detach().reshape(grads.shape[0], -1).double())
        return real(grads)

    monkeypatch.setattr(port_trainer, "mgda_rep_weights", record)
    jax_out, port_out, tr = _run_mode(setup, "MGD")
    _check(jax_out, port_out, tr.ordered_names, alpha_rtol=1e-4)
    assert len(seen) == 2
    for grads in seen:
        gaps = _frank_wolfe_gaps(grads.numpy())
        assert gaps.min() > 1e-6, gaps
    assert not np.allclose(port_out[-1][2], 0.25)


def test_zero_policy_flags_mean_the_defaults(tmp_path):
    """--alpha 0, --delta 0, --temp 0 and --dropout_rate 0 take the JAX
    Trainer's defaults (its `x or default`), and the port's generators
    for the policy and the heads' draws exist."""
    cfg = dict(_cfg(tmp_path, "adaptive"), alpha=0, delta=0, temp=0,
               dropout_rate=0)
    tr = Trainer(SMALL_FE, BANK, cfg, device="cpu")
    assert tr.pol_kwargs == dict(dropout_rate=0.5, delta=1.5, temp=1.0,
                                 alpha_ema=0.5)
    assert tr.policy_generator is not None
    assert tr.head_generator is not None
