"""The SPC and Gap heads of the port and the PASE v0.1 bank
(cfg/workers/workers.cfg) against the JAX package, on the CPU.

The encoder is PASE.cfg's trunk narrowed (FeBlocks, no QRNN, no dense
skips, norm_out), the bank workers.cfg at hidden_size 32 (cchunk decoder
fmaps [16, 16, 8]) plus a Gap head. The frame draws are injected
(``spc_idx``, ``gap_idx``) on both sides. Bounds are those of
``test_torch_train``: per-worker losses within 1e-5 relative, gradients
within 1e-4 x max|g| per parameter leaf (a bias that feeds a BatchNorm:
both sides below 1e-5 of the encoder's largest gradient). SPC needs more
than 2 (seq_pad + ctxt_frames) + 1 = 43 frames: the chunk is 8000 samples
(50 frames).
"""

import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
import optax
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from pase_tpu import minions as jax_minions
from pase_tpu.data.dataset import SyntheticChunkBatcher as JaxBatcher
from pase_tpu.parallel.mesh import get_mesh
from pase_tpu.trainer import Trainer as JaxTrainer
from pase_tpu_torch import minions
from pase_tpu_torch.checkpoint import (load_model_variables,
                                       model_state_dict_to_variables,
                                       model_variables_to_state_dict,
                                       variables_to_state_dict)
from pase_tpu_torch.data.dataset import step_seed
from pase_tpu_torch.model import build_pase
from pase_tpu_torch.trainer import Trainer
from test_torch_train import ADAM_B1, BN_CANCELLED, _fresh, _np_tree
from torch_port_common import flat_variables
from torch_port_common import port_test_guard  # noqa: F401

V01_FE = {"kwidths": [251, 20, 11, 11], "strides": [1, 10, 4, 4],
          "fmaps": [8, 8, 16, 16], "emb_dim": 16, "norm_out": True}
GAP = {"name": "gap", "num_outputs": 1, "dropout": 0, "hidden_size": 32,
       "hidden_layers": 1, "loss": "MSELoss", "skip": False}
BATCH, CHUNK = 2, 8000
FRAMES = CHUNK // 160
LR = 5e-4


def v01_workers():
    """workers.cfg at hidden_size 32, plus a Gap head."""
    with open("cfg/workers/workers.cfg") as f:
        wk = json.load(f)
    for group in ("regr", "cls"):
        for e in wk[group]:
            e["hidden_size"] = 32
            if e["name"] == "cchunk":
                e["fmaps"] = [16, 16, 8]
    wk["cls"].append(dict(GAP))
    return wk


def _cfg(save_path):
    return dict(backprop_mode="base", hop=160, bpe=100, epoch=10,
                batch_size=BATCH, chunk_size=CHUNK, log_freq=2, fe_lr=LR,
                min_lr=LR, lr_mode="poly", save_path=str(save_path))


def _indices(seed):
    """(spc_idx [t, future_t, past_t], gap_idx [2, B]) in range."""
    rng = np.random.RandomState(seed)
    n, pad = 5, 16
    t = rng.randint(n + pad + 1, FRAMES - n - pad)
    ft = rng.randint(t + pad, FRAMES - n)
    pt = rng.randint(n, t - pad)
    return (np.array([t, ft, pt], np.int32),
            rng.randint(0, FRAMES, (2, BATCH)).astype(np.int32))


def _init_state(jtr, extra):
    """The JAX Trainer's initial TrainState with its prepare and init
    jitted; ``extra`` holds the injected indices the init needs."""
    from pase_tpu.optim import build_optimizer
    from pase_tpu.scheduling import init_policy_state
    from pase_tpu.trainer import TrainState
    key = jax.random.PRNGKey(0)
    dummy = {k: jnp.zeros((BATCH, CHUNK))
             for k in ("chunk", "chunk_ctxt", "chunk_rand")}
    dummy.update({k: jnp.asarray(v) for k, v in extra.items()})
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
def jax_run(tmp_path_factory):
    """The JAX step of the v0.1 bank plus Gap on a batch with injected
    indices, from randomized BatchNorm affine parameters and PReLU
    slopes: (params, stats, raw batch, losses, gradients, tmp)."""
    tmp = tmp_path_factory.mktemp("spc_gap")
    spc_idx, gap_idx = _indices(3)
    extra = {"spc_idx": spc_idx, "gap_idx": gap_idx}
    jtr = JaxTrainer(V01_FE, v01_workers(), _cfg(tmp / "jax"),
                     mesh=get_mesh(devices=jax.devices()[:1]))
    state = _init_state(jtr, extra)
    params = _np_tree(state.params)
    rng = np.random.RandomState(12)
    for k, v in params.items():
        if k.endswith("norm/weight"):
            params[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("norm/bias"):
            params[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("act/weight"):
            params[k] = rng.uniform(0.0, 0.3, v.shape).astype(np.float32)
    state = state._replace(params=unflatten_dict(
        {k: jnp.asarray(v) for k, v in params.items()}, sep="/"))
    raw = dict(next(iter(JaxBatcher(BATCH, CHUNK, seed=6))), **extra)
    new_state, losses = jtr._make_train_step()(
        _fresh(state), {k: jnp.asarray(v) for k, v in raw.items()})
    grads = {}
    for group in new_state.opt_state.inner_states.values():
        adam = group.inner_state[0]
        for k, mu in flatten_dict(unfreeze(adam.mu), sep="/").items():
            if not isinstance(mu, optax.MaskedNode):
                grads[k] = np.asarray(mu, np.float64) / (1.0 - ADAM_B1)
    return (params, _np_tree(state.batch_stats), raw,
            {k: float(v) for k, v in losses.items()}, grads, tmp)


def _port(jax_run_, name):
    params, stats = jax_run_[0], jax_run_[1]
    tr = Trainer(V01_FE, v01_workers(), _cfg(jax_run_[-1] / name),
                 device="cpu")
    flat = {f"params/{k}": v for k, v in params.items()}
    flat.update({f"batch_stats/{k}": v for k, v in stats.items()})
    load_model_variables(tr.model, flat)
    return tr


def test_head_input_widths_are_the_jax_ones(jax_run):
    """SPC reads emb * (1 + ctxt_frames) channels, Gap 2 * emb, LIM / GIM
    2 * emb: every parameter shape equals the JAX init's."""
    params = jax_run[0]
    model, _ = build_pase(V01_FE, v01_workers())
    emb = model.frontend.output_dim
    assert model.workers["spc"].blocks[0].W.weight.shape[1] == emb * 6
    assert model.workers["gap"].blocks[0].W.weight.shape[1] == 2 * emb
    assert model.workers["mi"].blocks[0].W.weight.shape[1] == 2 * emb
    sd = model_variables_to_state_dict({f"params/{k}": v
                                        for k, v in params.items()})
    for k, v in sd.items():
        assert tuple(model.state_dict()[k].shape) == tuple(v.shape), k


def test_v01_bridge_round_trip(jax_run):
    params, stats = jax_run[0], jax_run[1]
    assert any(k.startswith("spc/") for k in params)
    assert any(k.startswith("gap/") for k in params)
    flat = {f"params/{k}": v for k, v in params.items()}
    flat.update({f"batch_stats/{k}": v for k, v in stats.items()})
    tr = _port(jax_run, "bridge")
    back = model_state_dict_to_variables(tr.model.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_v01_train_step_matches_jax(jax_run):
    _, _, raw, jlosses, grads, _ = jax_run
    tr = _port(jax_run, "step")
    losses = tr.train_step(raw)
    assert "spc" in tr.ordered_names and "gap" in tr.ordered_names
    assert set(losses) == set(jlosses)
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
            assert np.abs(g).max() <= 1e-5 * fe_max, k
            assert np.abs(got).max() <= 1e-5 * fe_max, k
            continue
        err = np.abs(got - g).max()
        assert err <= 1e-4 * np.abs(g).max(), (k, err, np.abs(g).max())


@pytest.mark.parametrize("head", ["spc", "gap"])
def test_head_forward_matches_jax(head):
    """The head alone, the JAX module's weights and injected indices: SPC
    flattens each window as its [C, N] slice (the JAX head transposes
    its NTC window to (C, N) first)."""
    c, t = 6, 50
    x = np.random.RandomState(1).randn(2, t, c).astype(np.float32)
    spc_idx, gap_idx = _indices(4)
    if head == "spc":
        jm = jax_minions.SPCMinion(num_outputs=1, hidden_size=12,
                                   hidden_layers=2)
        idx, port = spc_idx, minions.SPCMinion(c * 6, 1, 12, 2)
    else:
        jm = jax_minions.GapMinion(num_outputs=1, hidden_size=12,
                                   hidden_layers=2)
        idx, port = gap_idx[:, :2], minions.GapMinion(2 * c, 1, 12, 2)
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), idx=jnp.asarray(idx))
    port.load_state_dict(variables_to_state_dict(flat_variables(v)),
                         strict=True)
    want = jm.apply(v, jnp.asarray(x), idx=jnp.asarray(idx))
    got = port(torch.from_numpy(x.transpose(0, 2, 1)), idx=idx)
    if head == "gap":
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        want, got = want[0], got[0]
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 1),
                               np.asarray(want), atol=1e-5, rtol=1e-5)


@settings(max_examples=60, deadline=None)
@given(frames=st.integers(10, 400), seq_pad=st.integers(0, 40),
       ctxt=st.integers(1, 12), seed=st.integers(0, 2 ** 31 - 1))
def test_spc_draws_stay_in_range(frames, seq_pad, ctxt, seed):
    m = seq_pad + ctxt
    gen = torch.Generator().manual_seed(seed)
    if frames - m <= m + 1:
        with pytest.raises(ValueError, match="SPC needs"):
            minions.spc_draw(frames, ctxt, seq_pad, gen)
        return
    t, ft, pt = (int(v) for v in minions.spc_draw(frames, ctxt, seq_pad,
                                                  gen))
    assert m + 1 <= t < frames - m
    assert t + seq_pad <= ft < frames - ctxt       # the future window fits
    assert ctxt <= pt < t - seq_pad                # the past window fits


@settings(max_examples=40, deadline=None)
@given(frames=st.integers(2, 300), batch=st.integers(1, 6),
       seed=st.integers(0, 2 ** 31 - 1))
def test_gap_draws_stay_in_range(frames, batch, seed):
    idx = minions.gap_draw(batch, frames,
                           torch.Generator().manual_seed(seed))
    assert idx.shape == (2, batch)
    assert int(idx.min()) >= 0 and int(idx.max()) < frames
    x = torch.randn(batch, 3, frames)
    head = minions.GapMinion(6, 1, 4, 1)
    _, dists = head(x, idx=idx)
    want = (idx[0] - idx[1]).abs().float() / (frames - 1)
    torch.testing.assert_close(dists.flatten(), want, rtol=0, atol=0)


def test_spc_refuses_a_short_chunk():
    """25 frames (4000 samples) leave no current frame to draw."""
    head = minions.SPCMinion(16 * 6, 1, 8, 1)
    with pytest.raises(ValueError, match="43 frames"):
        head(torch.randn(2, 16, 25), generator=torch.Generator())


def test_trainer_draws_come_from_seed_and_step(jax_run):
    """Without injected indices a step's draws are those of a generator
    seeded with step_seed(seed + 2, step): the same step of two trainers
    gives the same losses; the draw differs from step to step."""
    raw = {k: v for k, v in jax_run[2].items() if not k.endswith("_idx")}
    a, b = _port(jax_run, "draws_a"), _port(jax_run, "draws_b")
    la, lb = a.train_step(raw), b.train_step(raw)
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    draws = [minions.spc_draw(FRAMES, 5, 16, torch.Generator().manual_seed(
        step_seed(a.seed + 2, s))) for s in range(4)]
    assert len({tuple(d.tolist()) for d in draws}) > 1


def test_v01_train_cli_on_the_cpu(tmp_path, monkeypatch):
    """python -m pase_tpu_torch.train on the narrow v0.1 bank plus Gap at
    2 steps an epoch: every logged loss finite, spc and gap among them."""
    import math
    from pase_tpu_torch import train as train_cli
    monkeypatch.setattr(train_cli, "SYNTHETIC_BPE", 2)
    fe, net = tmp_path / "fe.cfg", tmp_path / "net.cfg"
    fe.write_text(json.dumps(V01_FE))
    net.write_text(json.dumps(v01_workers()))
    tr = train_cli.main(["--synthetic", "--device", "cpu", "--net_cfg",
                         str(net), "--fe_cfg", str(fe), "--batch_size", "2",
                         "--chunk_size", str(CHUNK), "--epoch", "1",
                         "--log_freq", "1", "--save_path",
                         str(tmp_path / "run")])
    tr.logger.close()
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f if line.strip()]
    train = [r for r in recs if r["split"] == "train"]
    assert train and all("spc" in r and "gap" in r for r in train)
    for r in recs:
        if r["split"] in ("train", "eval"):
            for k, v in r.items():
                if k not in ("t", "split", "step"):
                    assert math.isfinite(v), (k, v)
