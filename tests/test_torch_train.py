"""The port's training slice (pase_tpu_torch.trainer) against the JAX
Trainer on the same weights and the same synthetic batch, on the CPU.

The model is small but keeps every worker kind of workers+: a 4-block
WaveFe with rnn_pool and dense skips (stride product 160), and the
workers+ bank at hidden_size 32 with decoder fmaps [16, 16, 8], which
keeps the fused lps / lps_long heads (3075 x 7 outputs). The JAX side
runs its associative-scan QRNN at 'highest' matmul precision
(tests/conftest.py); the torch side runs float32, where the QRNN wrapper
takes its plain forward and plain backward (the CUDA kernels are held to
those on the card by tests/test_torch_cuda.py).

Bounds (float32 sums in different orders; the JAX BatchNorm takes the
variance in one pass, torch in two):
  * per-worker losses of one step: 1e-5 relative;
  * gradients: 1e-4 x max|g| per parameter leaf (a bias that feeds a
    BatchNorm has gradient 0; there both sides must be below 1e-5 of the
    encoder's largest gradient);
  * BatchNorm running stats after the step: 1e-6 absolute;
  * the Adam update applied to shared gradients: 1e-6 absolute;
  * per-worker losses over three steps: 1e-3 relative (Adam's first
    steps are near sign(g), so ulp-level gradient differences move the
    weights by up to 2 lr).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from pase_tpu.data.dataset import SyntheticChunkBatcher as JaxBatcher
from pase_tpu.optim import build_optimizer
from pase_tpu.parallel.mesh import get_mesh
from pase_tpu.scheduling import init_policy_state
from pase_tpu.trainer import Trainer as JaxTrainer
from pase_tpu.trainer import TrainState
from pase_tpu_torch import losses as port_losses
from pase_tpu_torch import minions as port_minions
from pase_tpu_torch import optim as port_optim
from pase_tpu_torch.checkpoint import (load_model_variables,
                                       model_state_dict_to_variables,
                                       model_variables_to_state_dict)
from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
from pase_tpu_torch.trainer import Trainer
from torch_port_common import port_test_guard  # noqa: F401

SMALL_FE = {"kwidths": [251, 20, 11, 11], "strides": [1, 10, 4, 4],
            "fmaps": [8, 8, 16, 16], "rnn_pool": True, "rnn_dim": 16,
            "emb_dim": 16, "denseskips": True, "norm_out": True}
BATCH, CHUNK = 2, 4800
LR = 5e-4
ADAM_B1 = 0.9           # optax.adam's default first-moment decay
# biases that feed a BatchNorm, which removes them: zero gradient
BN_CANCELLED = {"frontend/blocks_1/conv/bias", "frontend/blocks_2/conv/bias",
                "frontend/blocks_3/conv/bias", "frontend/W/bias"}


def small_workers():
    with open("cfg/workers/workers+.cfg") as f:
        wk = json.load(f)
    for group in ("regr", "cls"):
        for e in wk[group]:
            e["hidden_size"] = 32
            if e["name"] == "cchunk":
                e["fmaps"] = [16, 16, 8]
    return wk


def _cfg(save_path):
    return dict(backprop_mode="base", hop=160, bpe=100, epoch=10,
                batch_size=BATCH, chunk_size=CHUNK, log_freq=2, fe_lr=LR,
                min_lr=LR, lr_mode="poly", save_path=str(save_path))


def _np_tree(tree):
    return {k: np.array(v) for k, v in
            flatten_dict(unfreeze(tree), sep="/").items()}


def _init_state(jtr):
    """``Trainer.init_state(0)`` with its batch prepare and model init
    jitted (run eagerly they take about 35 s on a CPU)."""
    key = jax.random.PRNGKey(0)
    dummy = {k: jnp.zeros((2, CHUNK))
             for k in ("chunk", "chunk_ctxt", "chunk_rand")}
    prepared = jax.jit(jtr.prepare)(dummy, key)
    variables = jax.jit(lambda r, b: jtr.model.init(r, b, train=False))(
        {"params": key, "sample": key, "dropout": key}, prepared)
    cfg = jtr.cfg
    jtr._tx, jtr._scheds = build_optimizer(
        variables["params"], fe_lr=cfg["fe_lr"], min_lr=cfg["min_lr"],
        lr_mode=cfg["lr_mode"], epochs=jtr.epochs, bpe=jtr.bpe)
    return TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jtr._tx.init(variables["params"]),
        policy_state=init_policy_state(jtr.num_workers),
        alpha=jnp.ones((jtr.num_workers,)), rng=key,
        step=jnp.zeros((), jnp.int32))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX Trainer with non-trivial weights, its variables, and a
    batch. BatchNorm affine params and PReLU slopes are randomized (their
    inits, 1/0 and 0/0.25, hide mistakes)."""
    tmp = tmp_path_factory.mktemp("train")
    jtr = JaxTrainer(SMALL_FE, small_workers(), _cfg(tmp / "jax"),
                     mesh=get_mesh(devices=jax.devices()[:1]))
    state = _init_state(jtr)
    params = _np_tree(state.params)
    rng = np.random.RandomState(7)
    for k, v in params.items():
        if k.endswith("norm/weight"):
            params[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("norm/bias"):
            params[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("act/weight"):
            params[k] = rng.uniform(0.0, 0.3, v.shape).astype(np.float32)
    state = state._replace(params=unflatten_dict(
        {k: jnp.asarray(v) for k, v in params.items()}, sep="/"))
    stats = _np_tree(state.batch_stats)
    it = iter(JaxBatcher(BATCH, CHUNK, seed=3))
    batches = [next(it) for _ in range(3)]
    return jtr, state, params, stats, batches, tmp


@pytest.fixture(scope="module")
def jax_step(setup):
    """The JAX train step, compiled once for the module."""
    return setup[0]._make_train_step()


@pytest.fixture(scope="module")
def jax_first_step(setup, jax_step):
    """The JAX step on the first batch: (new state, losses, the step's
    gradient of the summed losses). The gradient is read back from Adam's
    first moment, which after one step from zero is (1 - b1) g."""
    jtr, state, _, _, batches, _ = setup
    new_state, losses = jax_step(
        _fresh(state), {k: jnp.asarray(v) for k, v in batches[0].items()})
    grads = {}
    for group in new_state.opt_state.inner_states.values():
        adam = group.inner_state[0]
        assert int(adam.count) == 1
        for k, mu in flatten_dict(unfreeze(adam.mu), sep="/").items():
            if not isinstance(mu, optax.MaskedNode):    # the other group's
                grads[k] = np.asarray(mu, np.float64) / (1.0 - ADAM_B1)
    return new_state, {k: float(v) for k, v in losses.items()}, grads


def _fresh(state):
    """A copy of a JAX TrainState: the jitted step donates its input."""
    return jax.tree.map(lambda x: jnp.array(x, copy=True), state)


def _port(setup_, name):
    jtr, _, params, stats, _, tmp = setup_
    tr = Trainer(SMALL_FE, small_workers(), _cfg(tmp / name), device="cpu")
    flat = {f"params/{k}": v for k, v in params.items()}
    flat.update({f"batch_stats/{k}": v for k, v in stats.items()})
    load_model_variables(tr.model, flat)
    return tr


def test_synthetic_batcher_is_the_jax_batcher():
    want = JaxBatcher(3, 1000, seed=5)
    got = SyntheticChunkBatcher(3, 1000, seed=5)
    for _ in range(2):
        w, g = next(iter(want)), next(iter(got))
        for k in ("chunk", "chunk_ctxt", "chunk_rand"):
            np.testing.assert_array_equal(g[k], w[k])


def test_model_weight_bridge_round_trip(setup):
    """JAX PASE variables -> state dict -> variables is exact, covers
    every parameter and buffer of the port, and loads strictly."""
    _, _, params, stats, _, _ = setup
    flat = {f"params/{k}": v for k, v in params.items()}
    flat.update({f"batch_stats/{k}": v for k, v in stats.items()})
    tr = _port(setup, "bridge")
    sd = model_variables_to_state_dict(flat)
    port_keys = {k for k in tr.model.state_dict()
                 if not k.endswith("num_batches_tracked")}
    assert set(sd) == port_keys
    back = model_state_dict_to_variables(tr.model.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_one_train_step_matches_jax(setup, jax_first_step):
    raw = setup[4][0]
    new_state, jlosses, grads = jax_first_step
    new_stats = _np_tree(new_state.batch_stats)

    tr = _port(setup, "one")
    losses = tr.train_step(raw)
    for name in tr.ordered_names + ["total"]:
        got, want = float(losses[name]), jlosses[name]
        assert abs(got - want) <= 1e-5 * abs(want), (name, got, want)

    port_grads = model_state_dict_to_variables(
        {k: p.grad for k, p in tr.model.named_parameters()})
    assert {k[len("params/"):] for k in port_grads} == set(grads)
    fe_max = max(np.abs(g).max() for k, g in grads.items()
                 if k.startswith("frontend/"))
    for k, g in grads.items():
        got = port_grads["params/" + k]
        if k in BN_CANCELLED:
            # a bias right before a BatchNorm: its exact gradient is 0,
            # both sides hold rounding noise only
            assert np.abs(g).max() <= 1e-5 * fe_max, k
            assert np.abs(got).max() <= 1e-5 * fe_max, k
            continue
        err = np.abs(got - g).max()
        assert err <= 1e-4 * np.abs(g).max(), (k, err, np.abs(g).max())

    port_stats = model_state_dict_to_variables(
        {k: b for k, b in tr.model.state_dict().items()
         if "running" in k})
    assert {k[len("batch_stats/"):] for k in port_stats} == set(new_stats)
    for k, v in new_stats.items():
        err = np.abs(port_stats["batch_stats/" + k] - v).max()
        assert err <= 1e-6, (k, err)


def test_adam_update_matches_optax(setup, jax_first_step):
    """Both optimizers from the same params and the same gradients (the
    JAX step's): the port's two-group Adam at sched(0) and sched(1) equals
    the JAX multi-transform over two steps."""
    jtr, state, params, _, batches, _ = setup
    grads = {k: g.astype(np.float32) for k, g in jax_first_step[2].items()}
    tx = jtr._tx
    opt_state = tx.init(state.params)
    g_tree = unflatten_dict({k: jnp.asarray(v) for k, v in grads.items()},
                            sep="/")
    p_tree = state.params
    update = jax.jit(tx.update)
    for _ in range(2):
        upd, opt_state = update(g_tree, opt_state, p_tree)
        p_tree = jax.tree.map(lambda p, u: p + u, p_tree, upd)
    want = _np_tree(p_tree)

    tr = _port(setup, "adam")
    named = dict(tr.model.named_parameters())
    by_var = model_variables_to_state_dict(
        {f"params/{k}": v for k, v in grads.items()})
    for step in range(2):
        port_optim.set_lr(tr.opt, tr.scheds, step)
        for k, p in named.items():
            p.grad = by_var[k].clone()
        tr.opt.step()
    got = model_state_dict_to_variables(
        {k: p.detach() for k, p in named.items()})
    for k, v in want.items():
        err = np.abs(got["params/" + k] - v).max()
        assert err <= 1e-6, (k, err)


def test_three_train_steps_track_jax(setup, jax_step):
    jtr, state, _, _, batches, _ = setup
    step = jax_step
    state = _fresh(state)
    tr = _port(setup, "three")
    for raw in batches:
        state, jlosses = step(state, {k: jnp.asarray(v)
                                      for k, v in raw.items()})
        losses = tr.train_step(raw)
        for name in tr.ordered_names:
            got, want = float(losses[name]), float(jlosses[name])
            assert abs(got - want) <= 1e-3 * abs(want), (name, got, want)
    assert tr.step == 3


def test_lr_schedule_is_read_before_the_count_increments():
    for mode in ("poly", "cos", "step"):
        sched = port_optim.make_lr_schedule(mode, 1e-3, epochs=2, bpe=10,
                                            lr_step=1)
        assert sched(0) == pytest.approx(1e-3, rel=1e-12)
    from pase_tpu.optim import make_lr_schedule as jax_sched
    for mode in ("poly", "cos", "step"):
        want = jax_sched(mode, 1e-3, 2, 10, 1)
        got = port_optim.make_lr_schedule(mode, 1e-3, 2, 10, 1)
        for s in (0, 1, 9, 10, 17, 25):
            assert got(s) == pytest.approx(float(want(s)), rel=1e-6,
                                           abs=1e-12), (mode, s)


def test_framed_mse_linear_matches_jax_and_materialized():
    from pase_tpu.losses import framed_mse_linear as jax_fml
    rng = np.random.RandomState(2)
    h = rng.randn(2, 13, 6).astype(np.float32)
    kernel = rng.randn(1, 6, 5 * 7).astype(np.float32) * 0.3
    bias = rng.randn(5 * 7).astype(np.float32)
    target = rng.randn(2, 13, 5).astype(np.float32)
    want = float(jax_fml(jnp.asarray(kernel), jnp.asarray(bias),
                         jnp.asarray(h), jnp.asarray(target), 7))
    weight = torch.from_numpy(kernel.transpose(2, 1, 0).copy())
    got = port_losses.framed_mse_linear(
        weight, torch.from_numpy(bias), torch.from_numpy(h),
        torch.from_numpy(target), 7).item()
    pred = torch.from_numpy(h @ kernel[0] + bias)
    mat = port_losses.make_loss("MSELoss", r=7)(
        pred, torch.from_numpy(target)).item()
    assert got == pytest.approx(want, rel=1e-5)
    assert got == pytest.approx(mat, rel=1e-5)


@pytest.mark.parametrize("r", [1, 3, 7])
def test_contextualize_r_matches_jax(r):
    from pase_tpu.losses import contextualize_r as jax_ctx
    x = np.random.RandomState(r).randn(2, 9, 4).astype(np.float32)
    np.testing.assert_array_equal(
        port_losses.contextualize_r(torch.from_numpy(x), r).numpy(),
        np.asarray(jax_ctx(jnp.asarray(x), r)))


@pytest.mark.parametrize("name", ["MSELoss", "L1Loss", "BCEWithLogitsLoss"])
def test_elementwise_losses_match_jax(name):
    from pase_tpu.losses import make_loss as jax_make_loss
    rng = np.random.RandomState(1)
    p = rng.randn(3, 8, 2).astype(np.float32)
    t = (rng.rand(3, 8, 2) > 0.5).astype(np.float32)
    want = float(jax_make_loss(name)(jnp.asarray(p), jnp.asarray(t)))
    got = port_losses.make_loss(name)(torch.from_numpy(p),
                                      torch.from_numpy(t)).item()
    assert got == pytest.approx(want, rel=1e-6)


def test_scale_grad_scales_only_the_gradient():
    x = torch.randn(3, 4, requires_grad=True)
    y = port_minions.scale_grad(x, 0.25)
    assert torch.equal(y, x)
    y.sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 0.25))


def test_prelu_signs_record_and_force():
    """grad_parity.prelu_signs: a PReLU forced to its own input's signs
    gives the same output and gradient; forced to the other side of the
    kink at one input, only that input's derivative changes (1 <-> slope),
    and sign_flips finds that input."""
    from pase_tpu_torch.grad_parity import prelu_signs, sign_flips
    model = torch.nn.Sequential(torch.nn.PReLU(3, init=0.25))
    x0 = torch.randn(2, 3, 5, generator=torch.Generator().manual_seed(0))
    g = torch.randn(2, 3, 5, generator=torch.Generator().manual_seed(1))

    def run(**kw):
        x = x0.clone().requires_grad_()
        with prelu_signs(model, **kw):
            y = model(x)
        y.backward(g)
        return y.detach(), x.grad

    seen = {}
    y_nat, dx_nat = run(record=seen)
    assert torch.equal(seen["0"], x0)
    mask = x0 > 0
    y_own, dx_own = run(force={"0": mask})
    assert torch.equal(y_own, y_nat) and torch.equal(dx_own, dx_nat)
    flipped = mask.clone()
    flipped[1, 2, 3] = ~flipped[1, 2, 3]
    _, dx_flip = run(force={"0": flipped})
    slope = 0.25 if mask[1, 2, 3] else 4.0
    assert torch.allclose(dx_flip[1, 2, 3], slope * dx_nat[1, 2, 3])
    dx_flip[1, 2, 3] = dx_nat[1, 2, 3]
    assert torch.equal(dx_flip, dx_nat)
    moved = x0.clone()
    moved[1, 2, 3] = -moved[1, 2, 3]
    flips = sign_flips({"0": moved}, {"0": x0})
    assert flips == {"0": (1, pytest.approx(
        x0[1, 2, 3].abs().item() / x0.abs().max().item()))}


def test_trainer_refuses_unported_modes(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(SMALL_FE, small_workers(),
                dict(_cfg(tmp_path), backprop_mode="softmax"), device="cpu")


def test_train_loop_logs_checks_and_saves(tmp_path):
    """Trainer.train_: logged losses, one perf line per epoch, an eval
    pass and FE_e{epoch}.npz that wf_builder loads strictly."""
    from pase_tpu_torch import wf_builder
    from pase_tpu_torch.data.dataset import DeviceSyntheticBatcher
    cfg = dict(_cfg(tmp_path), bpe=3, va_bpe=2, epoch=1, log_freq=2)
    tr = Trainer(SMALL_FE, small_workers(), cfg, device="cpu")
    tr.train_(DeviceSyntheticBatcher(BATCH, CHUNK, seed=1, device="cpu"),
              DeviceSyntheticBatcher(BATCH, CHUNK, seed=2, device="cpu"))
    tr.logger.close()
    with open(tmp_path / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [(r["split"], r["step"]) for r in recs] == [
        ("train", 2), ("train", 3), ("perf", 3), ("eval", 0)]
    for r in recs:
        assert all(np.isfinite(v) for v in r.values()
                   if isinstance(v, float))
    assert recs[2]["audio_sec_per_sec"] == pytest.approx(
        recs[2]["steps_per_sec"] * BATCH * CHUNK / 16000)
    with open(tmp_path / "fe.cfg", "w") as f:
        json.dump(SMALL_FE, f)
    enc = wf_builder(str(tmp_path / "fe.cfg"), device="cpu")
    enc.load_pretrained(str(tmp_path / "FE_e0.npz"))
    for k, v in tr.model.frontend.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(enc.module.state_dict()[k], v), k


def test_train_loop_stops_on_a_non_finite_loss(tmp_path):
    cfg = dict(_cfg(tmp_path), bpe=2, epoch=1, log_freq=1)
    tr = Trainer(SMALL_FE, small_workers(), cfg, device="cpu")
    raw = next(iter(SyntheticChunkBatcher(BATCH, CHUNK, seed=0)))
    raw["chunk"][0, :10] = np.nan
    with pytest.raises(FloatingPointError, match="non-finite"):
        tr.train_(iter([raw, raw]))


@pytest.mark.parametrize("flags", [
    ["--shard_device_corpus"], ["--ihm2sdm", "x"],
    ["--chunking_K", "3"], ["--num_processes", "2"],
    ["--backprop_mode", "softmax"], ["--att_cfg", "x"],
    ["--dataset", "AmiSegTupleWavDataset"]])
def test_train_cli_refuses_unported_flags(tmp_path, flags):
    from pase_tpu_torch import train as port_train
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_train.main(["--synthetic", "--device", "cpu", "--net_cfg",
                         "cfg/workers/workers+.cfg", "--fe_cfg",
                         "cfg/frontend/PASE+.cfg", "--save_path",
                         str(tmp_path)] + flags)


def test_train_cli_without_a_card_refuses(tmp_path):
    from pase_tpu_torch import train as port_train
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the CLI would train on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.main(["--synthetic", "--net_cfg",
                         "cfg/workers/workers+.cfg", "--fe_cfg",
                         "cfg/frontend/PASE+.cfg", "--save_path",
                         str(tmp_path)])
