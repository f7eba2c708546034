"""The optimizers of the port (pase_tpu_torch/optim.py) against optax,
and their train-state layout against the JAX package's, on the CPU.

* Each rule (Adam, RAdam, AdamW, SGD, RMSprop) in one group with another
  rule in the other, 8 steps of seeded gradients at the poly schedule
  (RAdam rectifies from step 6 on): parameters within 1e-6 of their
  largest of the JAX package's ``build_optimizer`` (optax 0.2.6).
* A JAX TrainState with that optimizer's state (after two optax updates)
  loads into the port's Trainer (attention variant: its ``att_*``
  parameters and ``running_dist``) and comes back with the same keys and
  values, and the port's tree passes the JAX package's strict restore.
* An RMSprop run checkpointed after 2 steps resumes bit for bit."""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
import optax
from flax.traverse_util import flatten_dict, unflatten_dict

from pase_tpu.checkpoint import restore_train_state as jax_restore
from pase_tpu.checkpoint import train_state_to_tree as jax_state_tree
from pase_tpu.optim import build_optimizer as jax_build_optimizer
from pase_tpu.scheduling import PolicyState
from pase_tpu.trainer import TrainState
from pase_tpu_torch import optim
from pase_tpu_torch.checkpoint import (model_state_dict_to_variables,
                                       restore_train_state, rng_key,
                                       train_state_to_tree)
from pase_tpu_torch.trainer import Trainer
from test_torch_attention import ATT, BANK
from test_torch_train import SMALL_FE
from torch_port_common import port_test_guard  # noqa: F401

RULES = ["Adam", "RAdam", "adamw", "sgd", "rmsprop"]
# each rule in the encoder's group with the next one in the heads'
PAIRS = [(r, RULES[(i + 1) % len(RULES)]) for i, r in enumerate(RULES)]
FE_LR, MIN_LR = 1e-2, 3e-3


class _TwoGroups(nn.Module):
    def __init__(self):
        super().__init__()
        self.frontend = nn.Linear(5, 4)
        self.workers = nn.ModuleDict({"lps": nn.Linear(4, 3)})


def _jax_tree(model):
    return {"frontend": {"w": jnp.asarray(model.frontend.weight.detach()),
                         "b": jnp.asarray(model.frontend.bias.detach())},
            "lps": {"w": jnp.asarray(model.workers.lps.weight.detach()),
                    "b": jnp.asarray(model.workers.lps.bias.detach())}}


@pytest.mark.parametrize("fe_opt,min_opt", PAIRS)
def test_optimizers_match_optax(fe_opt, min_opt):
    torch.manual_seed(0)
    model = _TwoGroups()
    params = _jax_tree(model)
    kw = dict(fe_opt=fe_opt, min_opt=min_opt, fe_lr=FE_LR, min_lr=MIN_LR,
              lr_mode="poly", epochs=1, bpe=10)
    tx, _ = jax_build_optimizer(params, **kw)
    state = tx.init(params)
    update = jax.jit(tx.update)          # as the JAX train step runs it
    opt, scheds = optim.build_optimizer(model, **kw)
    assert [g["rule"] for g in opt.param_groups] == [
        fe_opt.lower(), min_opt.lower()]
    rng = np.random.RandomState(1)
    named = {("frontend", "w"): model.frontend.weight,
             ("frontend", "b"): model.frontend.bias,
             ("lps", "w"): model.workers.lps.weight,
             ("lps", "b"): model.workers.lps.bias}
    for step in range(8):
        grads = {k: rng.randn(*p.shape).astype(np.float32)
                 for k, p in named.items()}
        g_tree = unflatten_dict({k: jnp.asarray(v)
                                 for k, v in grads.items()})
        upd, state = update(g_tree, state, params)
        params = optax.apply_updates(params, upd)
        optim.set_lr(opt, scheds, step)
        for k, p in named.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        flat = flatten_dict(params)
        for k, p in named.items():
            want = np.asarray(flat[k])
            err = np.abs(p.detach().numpy() - want).max()
            assert err <= 1e-6 * np.abs(want).max(), (step, k, err)


def test_unknown_optimizer_raises_as_in_jax():
    with pytest.raises(ValueError, match="Unknown optimizer adagrad"):
        jax_build_optimizer({"frontend": {"w": jnp.ones(2)}},
                            fe_opt="Adagrad")
    with pytest.raises(ValueError, match="Unknown optimizer adagrad"):
        optim.build_optimizer(_TwoGroups(), fe_opt="Adagrad")


def test_radam_rectifier_is_optax_float32():
    """RAdam's ro equals optax's float32 value in a jitted step (XLA
    evaluates ro otherwise than an eager call: at step 6, 5.9747 against
    5.9548) at steps 1 to 3000, and r is within 1e-6 of it."""
    b2 = optim.B2
    ro_inf = 2.0 / (1.0 - b2) - 1.0

    @jax.jit
    def want(t):
        b2t = b2 ** t
        ro = ro_inf - 2 * t * b2t / (1 - b2t)
        return ro, jnp.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                            / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))

    ts = jnp.arange(1, 3001, dtype=jnp.int32)
    ro_w, r_w = jax.vmap(want)(ts)
    for t in range(1, 3001):
        ro, r = optim.radam_rectifier(t)
        assert ro == float(ro_w[t - 1]), t
        if ro >= optim.RADAM_THRESHOLD:
            assert abs(r - float(r_w[t - 1])) <= 1e-6 * r, t


def _trainer(tmp_path, fe_opt, min_opt, **over):
    cfg = dict(backprop_mode="base", hop=160, bpe=2, epoch=2, batch_size=2,
               chunk_size=4800, log_freq=1, fe_lr=1e-3, min_lr=5e-4,
               lr_mode="poly", save_path=str(tmp_path), fe_opt=fe_opt,
               min_opt=min_opt, att_cfg=ATT, **over)
    return Trainer(SMALL_FE, BANK, cfg, device="cpu")


def _jax_state(tr, fe_opt, min_opt):
    """A JAX TrainState on the port trainer's weights, after two optax
    updates of seeded gradients, with seeded policy state and alpha."""
    flat = model_state_dict_to_variables(tr.model.state_dict())
    tree = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                          sep="/")
    params = tree["params"]
    tx, _ = jax_build_optimizer(params, fe_opt=fe_opt, min_opt=min_opt,
                                fe_lr=1e-3, min_lr=5e-4, lr_mode="poly",
                                epochs=2, bpe=2)
    opt_state = tx.init(params)
    rng = np.random.RandomState(2)
    for _ in range(2):
        g = jax.tree.map(lambda p: jnp.asarray(
            rng.randn(*p.shape).astype(np.float32)), params)
        upd, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, upd)
    n = tr.num_workers

    def vec():
        return jnp.asarray(rng.rand(n).astype(np.float32))

    return TrainState(
        params=params, batch_stats=tree["batch_stats"], opt_state=opt_state,
        policy_state=PolicyState(q=vec(), last_loss=vec(), pi=vec(),
                                 count=jnp.asarray(3, jnp.int32)),
        alpha=vec(), rng=jnp.asarray(rng_key(tr.seed, 2)),
        step=jnp.asarray(2, jnp.int32))


@pytest.mark.parametrize("fe_opt,min_opt", PAIRS)
def test_optimizer_state_layout_both_ways(tmp_path, fe_opt, min_opt):
    tr = _trainer(tmp_path, fe_opt, min_opt)
    state = _jax_state(tr, fe_opt, min_opt)
    want = {k: np.asarray(v) for k, v in
            flatten_dict(jax_state_tree(state), sep="/").items()
            if v is not None}             # no GAN: d_params ... are None
    assert any(k.startswith("params/att_mi/") for k in want)
    assert "batch_stats/att_mi/running_dist" in want
    restore_train_state(tr, want)
    assert tr.step == 2 and tr.opt_count == 2
    back = train_state_to_tree(tr)
    assert back.pop("torch/seed") == tr.seed
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    restored = jax_restore(jax.device_get(state),
                           unflatten_dict(back, sep="/"))
    again = {k: np.asarray(v) for k, v in
             flatten_dict(jax_state_tree(restored), sep="/").items()
             if v is not None}
    assert set(again) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)


def test_rmsprop_resume_is_bit_identical(tmp_path):
    """RMSprop in both groups: 2 steps, save, a new Trainer resumes, 2
    more steps == 4 steps in one run (parameters, buffers and the
    optimizer's square averages, bit for bit; BatchNorm's
    num_batches_tracked has no JAX counterpart and is not saved)."""
    from pase_tpu_torch.data.dataset import DeviceSyntheticBatcher

    def batcher():
        return DeviceSyntheticBatcher(2, 4800, seed=1, device="cpu")

    whole = _trainer(tmp_path / "whole", "rmsprop", "rmsprop")
    whole.train_(batcher())
    first = _trainer(tmp_path / "cut", "rmsprop", "rmsprop")
    first.train_(batcher(), epochs=1)
    resumed = _trainer(tmp_path / "cut", "rmsprop", "rmsprop")
    resumed.train_(batcher())
    for tr in (whole, first, resumed):
        tr.logger.close()
    assert resumed.step == whole.step == 4
    for k, v in whole.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):     # not in the file
            assert torch.equal(resumed.model.state_dict()[k], v), k
    for (n, p), q in zip(whole.model.named_parameters(),
                         resumed.model.parameters()):
        assert set(whole.opt.state[p]) == {"square_avg"}, n
        assert torch.equal(whole.opt.state[p]["square_avg"],
                           resumed.opt.state[q]["square_avg"]), n


def test_optimizer_flags_reach_the_trainer(tmp_path, monkeypatch):
    """--fe_opt / --min_opt through the training CLI: each group's rule
    (the epoch loop is not run here)."""
    import json
    from pase_tpu_torch import train as port_cli
    fe, wk = tmp_path / "fe.cfg", tmp_path / "wk.cfg"
    fe.write_text(json.dumps(SMALL_FE))
    wk.write_text(json.dumps(BANK))
    monkeypatch.setattr(Trainer, "train_", lambda self, *a, **k: None)
    tr = port_cli.main(["--synthetic", "--device", "cpu", "--net_cfg",
                        str(wk), "--fe_cfg", str(fe), "--batch_size", "2",
                        "--chunk_size", "4800", "--epoch", "1",
                        "--save_path", str(tmp_path / "run"), "--fe_opt",
                        "RMSprop", "--min_opt", "RAdam"])
    assert isinstance(tr.opt, optim.OptaxOptimizer)
    assert [(g["name"], g["rule"]) for g in tr.opt.param_groups] == [
        ("frontend", "rmsprop"), ("minion", "radam")]
    opt = port_cli.main(
        ["--synthetic", "--device", "cpu", "--net_cfg", str(wk),
         "--fe_cfg", str(fe), "--batch_size", "2", "--chunk_size", "4800",
         "--epoch", "1", "--save_path", str(tmp_path / "adam")]).opt
    assert isinstance(opt, optim.OptaxOptimizer)
    assert [(g["name"], g["rule"]) for g in opt.param_groups] == [
        ("frontend", "adam"), ("minion", "adam")]
