"""The GAN workers of the port (pase_tpu_torch/adversarial.py and the
Trainer's gan_cfg) against the JAX package, on the CPU.

The discriminators and the GAN objectives against ``pase_tpu.adversarial``
at narrow widths, then one train step with a GAN against the JAX
Trainer's step: test_torch_train's narrow encoder with test_adversarial's
GAN bank (a narrow cchunk decoder and LIM) and the default
WaveDiscriminator, the recipe's gan_cfg (LSGAN, lr 4e-4, weight 1); and
the z-GAN (ZDiscriminator on the chunk embedding) with its cchunk prior
and with an N(0, 1) prior whose draw is handed to the port. Each JAX step
is compiled once for the module.

Bounds: a discriminator's output within 1e-5 of max|y| and its u within
1e-6; the GAN objectives within 1e-6 relative; a step's per-worker
losses, the G term and d_loss within 1e-5 relative; the model's
gradients within 1e-4 of each leaf's largest (the step's G gradients,
read back from Adam's first moment) and D's the same; D's parameters
after the step within 1e-5 absolute wherever D's gradient is above 1e-4
of its leaf's largest, and within 2 lr + 1e-5 elsewhere (Adam's first
step moves a weight by lr g / (|g| + 1e-8), so a gradient within
rounding of 0, here about 1e-8, may take either sign); u after the step
within 1e-6.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from pase_tpu import adversarial as jadv
from pase_tpu.checkpoint import restore_train_state as jax_restore
from pase_tpu.checkpoint import save_variables as jax_save
from pase_tpu.checkpoint import train_state_to_tree as jax_tree
from pase_tpu.data.dataset import SyntheticChunkBatcher as JaxBatcher
from pase_tpu.parallel.mesh import get_mesh
from pase_tpu.trainer import Trainer as JaxTrainer
from pase_tpu_torch import adversarial as padv
from pase_tpu_torch.checkpoint import (load_model_variables, load_variables,
                                       model_state_dict_to_variables,
                                       restore_train_state, save_variables,
                                       state_dict_to_variables,
                                       train_state_to_tree,
                                       variables_to_state_dict)
from pase_tpu_torch.trainer import Trainer, gan_ramp
from test_torch_train import (ADAM_B1, BATCH, BN_CANCELLED, CHUNK, SMALL_FE,
                              _cfg, _fresh, _init_state, _np_tree)
from torch_port_common import port_test_guard  # noqa: F401

D_REL = 1e-5
U_ATOL = 1e-6
OBJ_REL = 1e-6
LOSS_REL = 1e-5
GRAD_REL = 1e-4
D_PARAM_ATOL = 1e-5
# D's gradient elements above this share of their leaf's largest: where
# Adam's first step does not depend on the sign of rounding noise
D_LIVE_REL = 1e-4
GAN_CFG = {"worker": "cchunk", "loss": "LSGAN", "lr": 0.0004, "weight": 1.0}
Z_PRIOR_CFG = {"type": "z", "loss": "BCE", "lr": 5e-4, "weight": 0.1,
               "cchunk_prior": True}
Z_NORMAL_CFG = {"type": "z", "loss": "LSGAN", "lr": 5e-4, "weight": 0.5}
GAN_BANK = {
    "regr": [{"num_outputs": 1, "dropout": 0, "hidden_size": 32,
              "hidden_layers": 1, "name": "cchunk", "type": "decoder",
              "fmaps": [32, 16, 8], "strides": [4, 4, 10],
              "kwidths": [30, 30, 30], "loss": "L1Loss"}],
    "cls": [{"num_outputs": 1, "dropout": 0, "hidden_size": 32,
             "hidden_layers": 1, "name": "mi", "loss": "BCEWithLogitsLoss",
             "skip": False}]}
# a narrow WaveDiscriminator (test_adversarial.py's widths)
NARROW_D = dict(fmaps=(32, 32, 16), strides=(10, 4, 4), kwidths=(30, 30, 3))


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            flatten_dict(unfreeze(tree), sep="/").items()}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _load_d(module, params, stats):
    flat = {f"params/{k}": v for k, v in _flat(params).items()}
    flat.update({f"batch_stats/{k}": v for k, v in _flat(stats).items()})
    module.load_state_dict(variables_to_state_dict(flat), strict=True)
    return module


def _jax_d(jmod, x, seed=0, **kw):
    """Init a JAX discriminator, random PReLU slopes."""
    v = unfreeze(jax.jit(lambda k, a: jmod.init(k, a, **kw))(
        jax.random.PRNGKey(seed), x))
    rng = np.random.RandomState(seed + 5)
    for k in v["params"]:
        if k.startswith("act_"):
            v["params"][k]["weight"] = jnp.asarray(rng.uniform(
                0.1, 0.4, v["params"][k]["weight"].shape).astype(np.float32))
    return v


@pytest.mark.parametrize("cond", [False, True], ids=["plain", "cond"])
def test_wave_discriminator_matches_jax(cond):
    """Eval, then two train calls chained through u as d_objective does
    (real, then fake with the u the first call left)."""
    rng = np.random.RandomState(1)
    real = rng.randn(2, 4000).astype(np.float32) * 0.3
    fake = rng.randn(2, 4000).astype(np.float32) * 0.3
    c = rng.randn(2, 25, 16).astype(np.float32) if cond else None
    jmod = jadv.WaveDiscriminator(**NARROW_D)
    args = (real, c) if cond else (real,)
    v = _jax_d(jmod, real, cond=c) if cond else _jax_d(jmod, real)
    port = _load_d(padv.WaveDiscriminator(**NARROW_D,
                                          cond_dim=16 if cond else None),
                   v["params"], v["batch_stats"])
    pc = torch.from_numpy(c.transpose(0, 2, 1).copy()) if cond else None

    want = np.asarray(jmod.apply(v, *args, train=False))
    port.eval()
    got = port(torch.from_numpy(real), pc).detach().numpy()
    assert got.shape == (2, 1)
    assert _rel(got, want) <= D_REL

    stats = v["batch_stats"]
    port.train()
    for x in (real, fake):
        y, ups = jmod.apply({"params": v["params"], "batch_stats": stats},
                            x, c, train=True, mutable=["batch_stats"])
        stats = ups["batch_stats"]
        got = port(torch.from_numpy(x), pc).detach().numpy()
        assert _rel(got, np.asarray(y)) <= D_REL
        state = state_dict_to_variables(port.state_dict())
        for k, u in _flat(stats).items():
            assert np.abs(state["batch_stats/" + k] - u).max() <= U_ATOL, k


def test_z_discriminator_matches_jax():
    rng = np.random.RandomState(2)
    h = rng.randn(2, 30, 16).astype(np.float32)
    jmod = jadv.ZDiscriminator()
    v = _jax_d(jmod, h)
    port = padv.ZDiscriminator(16)
    port.load_state_dict(variables_to_state_dict(
        {f"params/{k}": a for k, a in _flat(v["params"]).items()}),
        strict=True)
    want = np.asarray(jmod.apply(v, h))
    got = port(torch.from_numpy(h.transpose(0, 2, 1).copy()))
    assert got.shape == (2, 30, 1)
    assert _rel(got.detach().numpy(), want) <= D_REL


@pytest.mark.parametrize("loss_type", ["L2", "LSGAN", "BCE", "GAN",
                                       "Hinge"])
def test_gan_objectives_match_jax(loss_type):
    rng = np.random.RandomState(3)
    dr = rng.randn(4, 7, 1).astype(np.float32) + 1.0
    df = rng.randn(4, 7, 1).astype(np.float32) - 1.0
    want_d = float(jadv.d_loss_fn(jnp.asarray(dr), jnp.asarray(df),
                                  loss_type))
    want_g = float(jadv.g_loss_fn(jnp.asarray(df), loss_type))
    got_d = padv.d_loss_fn(torch.from_numpy(dr), torch.from_numpy(df),
                           loss_type).item()
    got_g = padv.g_loss_fn(torch.from_numpy(df), loss_type).item()
    assert got_d == pytest.approx(want_d, rel=OBJ_REL)
    assert got_g == pytest.approx(want_g, rel=OBJ_REL)
    if loss_type == "Hinge":
        with pytest.raises(ValueError):
            jadv.gan_labels(loss_type)
        with pytest.raises(ValueError):
            padv.gan_labels(loss_type)
    else:
        assert padv.gan_labels(loss_type) == jadv.gan_labels(loss_type)


def _jax_setup(tmp, gan_cfg, seed):
    """A JAX Trainer with a GAN, its state (non-trivial norm affines and
    PReLU slopes, D included), a batch, and its step's (new state,
    losses, model gradients)."""
    jtr = JaxTrainer(SMALL_FE, GAN_BANK, _cfg(tmp / "jax"),
                     mesh=get_mesh(devices=jax.devices()[:1]),
                     gan_cfg=dict(gan_cfg))
    state = _init_state(jtr)
    z = gan_cfg.get("type") == "z"
    fake = (jnp.zeros((2, CHUNK // 160, jtr.model_emb_dim)) if z
            else jnp.zeros((2, CHUNK, 1)))
    dv = unfreeze(jax.jit(lambda k, a: jtr._d_module.init(
        k, a, train=False))(jax.random.PRNGKey(4), fake))
    jtr._d_tx = optax.adam(gan_cfg["lr"])
    params = _np_tree(state.params)
    rng = np.random.RandomState(seed)
    for k, v in params.items():
        if k.endswith("norm/weight"):
            params[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("norm/bias"):
            params[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("act/weight"):
            params[k] = rng.uniform(0.0, 0.3, v.shape).astype(np.float32)
    for k in dv["params"]:
        if k.startswith("act_"):
            dv["params"][k]["weight"] = jnp.asarray(rng.uniform(
                0.1, 0.4, dv["params"][k]["weight"].shape).astype(
                    np.float32))
    state = state._replace(
        params=unflatten_dict({k: jnp.asarray(v) for k, v in
                               params.items()}, sep="/"),
        d_params=dv["params"], d_batch_stats=dv.get("batch_stats", {}),
        d_opt_state=jtr._d_tx.init(dv["params"]))
    raw = next(iter(JaxBatcher(BATCH, CHUNK, seed=seed)))
    new_state, losses = jtr._make_train_step()(
        _fresh(state), {k: jnp.asarray(v) for k, v in raw.items()})
    grads = {}
    for group in new_state.opt_state.inner_states.values():
        adam = group.inner_state[0]
        for k, mu in flatten_dict(unfreeze(adam.mu), sep="/").items():
            if not isinstance(mu, optax.MaskedNode):
                grads[k] = np.asarray(mu, np.float64) / (1.0 - ADAM_B1)
    return dict(jtr=jtr, state=state, params=params,
                stats=_np_tree(state.batch_stats), raw=raw,
                new_state=new_state, grads=grads,
                losses={k: float(v) for k, v in losses.items()})


@pytest.fixture(scope="module")
def wave_run(tmp_path_factory):
    return _jax_setup(tmp_path_factory.mktemp("gan_wave"), GAN_CFG, 21)


@pytest.fixture(scope="module")
def z_prior_run(tmp_path_factory):
    return _jax_setup(tmp_path_factory.mktemp("gan_zp"), Z_PRIOR_CFG, 22)


@pytest.fixture(scope="module")
def z_normal_run(tmp_path_factory):
    return _jax_setup(tmp_path_factory.mktemp("gan_zn"), Z_NORMAL_CFG, 23)


def _port(run, tmp_path, gan_cfg):
    tr = Trainer(SMALL_FE, GAN_BANK, _cfg(tmp_path), device="cpu",
                 gan_cfg=dict(gan_cfg))
    flat = {f"params/{k}": v for k, v in run["params"].items()}
    flat.update({f"batch_stats/{k}": v for k, v in run["stats"].items()})
    load_model_variables(tr.model, flat)
    _load_d(tr.discriminator, run["state"].d_params,
            run["state"].d_batch_stats)
    return tr


def _z_draw(run):
    """The JAX step's N(0, 1) draw (fold_in(rng, 3) of the step's next
    key), in the port's [B, emb, F] layout."""
    state = run["state"]
    rng = jax.random.split(state.rng, 5)[0]
    shape = (BATCH, CHUNK // 160, run["jtr"].model_emb_dim)
    z = np.asarray(jax.random.normal(jax.random.fold_in(rng, 3), shape))
    return torch.from_numpy(z.transpose(0, 2, 1).copy())


def _check_step(run, tr, losses, g_name):
    want = run["losses"]
    assert set(losses) == set(want)
    for name in tr.ordered_names + [g_name, "d_loss", "total"]:
        got = float(losses[name])
        assert abs(got - want[name]) <= LOSS_REL * abs(want[name]), (
            name, got, want[name])
    port_grads = model_state_dict_to_variables(
        {k: p.grad for k, p in tr.model.named_parameters()})
    grads = run["grads"]
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
        assert err <= GRAD_REL * np.abs(g).max(), (k, err, np.abs(g).max())
    new = run["new_state"]
    d_now = state_dict_to_variables(tr.discriminator.state_dict())
    d_grads = state_dict_to_variables(
        {k: p.grad for k, p in tr.discriminator.named_parameters()})
    lr = tr.gan_cfg["lr"]
    for k, mu in _flat(new.d_opt_state[0].mu).items():
        g = mu / (1.0 - ADAM_B1)
        err = np.abs(d_grads["params/" + k] - g).max()
        assert err <= GRAD_REL * np.abs(g).max(), ("D grad", k, err)
        # Adam's first step moves a weight by lr g / (|g| + 1e-8): where g
        # lies within rounding of 0 either sign is right (at most 2 lr)
        live = np.abs(g) >= D_LIVE_REL * np.abs(g).max()
        err = np.abs(d_now["params/" + k] - _flat(new.d_params)[k])
        assert err[live].max() <= D_PARAM_ATOL, (k, err[live].max())
        assert err.max() <= 2 * lr + D_PARAM_ATOL, (k, err.max())
    for k, v in _flat(new.d_batch_stats).items():
        err = np.abs(d_now["batch_stats/" + k] - v).max()
        assert err <= U_ATOL, (k, err)


def test_wave_gan_step_matches_jax(wave_run, tmp_path):
    tr = _port(wave_run, tmp_path, GAN_CFG)
    d0 = {k: p.detach().clone()
          for k, p in tr.discriminator.named_parameters()}
    losses = tr.train_step(wave_run["raw"])
    _check_step(wave_run, tr, losses, "cchunk_g")
    # D trained, and G got no gradient into D's parameters from its term
    moved = [k for k, p in tr.discriminator.named_parameters()
             if not torch.equal(p.detach(), d0[k])]
    assert moved
    assert all(int(st["step"]) == 1 for st in tr.d_opt.state.values())


def test_z_gan_with_cchunk_prior_matches_jax(z_prior_run, tmp_path):
    tr = _port(z_prior_run, tmp_path, Z_PRIOR_CFG)
    assert tr.model.fwd_cchunk
    assert isinstance(tr.discriminator, padv.ZDiscriminator)
    losses = tr.train_step(z_prior_run["raw"])
    _check_step(z_prior_run, tr, losses, "z_g")


def test_z_gan_with_an_injected_normal_draw_matches_jax(z_normal_run,
                                                        tmp_path):
    tr = _port(z_normal_run, tmp_path, Z_NORMAL_CFG)
    assert not tr.model.fwd_cchunk
    losses = tr.train_step(z_normal_run["raw"], z_real=_z_draw(z_normal_run))
    _check_step(z_normal_run, tr, losses, "z_g")


def test_z_gan_draws_its_prior_from_the_step_seed(tmp_path):
    """Without an injected draw the N(0, 1) prior comes from
    step_seed(seed + 3, step): two trainers of one seed draw the same,
    the next step another."""
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    raw = next(iter(SyntheticChunkBatcher(BATCH, CHUNK, seed=1)))
    runs = []
    for name in ("a", "b"):
        tr = Trainer(SMALL_FE, GAN_BANK, _cfg(tmp_path / name),
                     device="cpu", gan_cfg=dict(Z_NORMAL_CFG))
        runs.append([float(tr.train_step(raw)["d_loss"])
                     for _ in range(2)])
    assert runs[0] == runs[1]
    assert runs[0][0] != runs[0][1]


def test_warmup_leaves_d_adam_untouched_then_ramps(tmp_path):
    """Before warmup the G term weighs 0 and D's Adam takes no step (no
    moments, no count; u still advances); at warmup D steps and the G term
    weighs weight * zinit_weight."""
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    cfg = dict(GAN_CFG, warmup=1, zinit_weight=0.5, zinc=0.25, weight=0.4)
    tr = Trainer(SMALL_FE, GAN_BANK, _cfg(tmp_path), device="cpu",
                 gan_cfg=cfg)
    it = iter(SyntheticChunkBatcher(BATCH, CHUNK, seed=2))
    d = tr.discriminator
    p0 = {k: p.detach().clone() for k, p in d.named_parameters()}
    u0 = {k: b.clone() for k, b in d.named_buffers()}
    l0 = tr.train_step(next(it))
    assert not tr.d_opt.state
    assert all(torch.equal(p.detach(), p0[k])
               for k, p in d.named_parameters())
    assert all(not torch.equal(b, u0[k]) for k, b in d.named_buffers())
    assert float(l0["total"]) == pytest.approx(
        float(l0["cchunk"]) + float(l0["mi"]), rel=1e-6)
    tree = train_state_to_tree(tr)
    assert int(tree["d_opt_state/0/count"]) == 0
    l1 = tr.train_step(next(it))
    assert all(int(st["step"]) == 1 for st in tr.d_opt.state.values())
    assert any(not torch.equal(p.detach(), p0[k])
               for k, p in d.named_parameters())
    assert float(l1["total"]) == pytest.approx(
        float(l1["cchunk"]) + float(l1["mi"])
        + 0.4 * 0.5 * float(l1["cchunk_g"]), rel=1e-6)
    assert gan_ramp(cfg, 0) == 0.0
    assert gan_ramp(cfg, 2) == pytest.approx(0.75)
    assert gan_ramp(cfg, 9) == 1.0
    assert gan_ramp(GAN_CFG, 0) == 1.0


def test_lsgan_worker_is_routed_to_the_gan_path(tmp_path):
    """A worker cfg with loss LSGAN becomes the GAN worker, its
    reconstruction loss zeroed, D's lr from z_lr, as the JAX Trainer
    routes it."""
    import copy
    bank = copy.deepcopy(GAN_BANK)
    bank["regr"][0]["loss"] = "LSGAN"
    cfg = dict(_cfg(tmp_path), z_lr=3e-4)
    jtr = JaxTrainer(SMALL_FE, copy.deepcopy(bank), cfg,
                     mesh=get_mesh(devices=jax.devices()[:1]))
    tr = Trainer(SMALL_FE, copy.deepcopy(bank), cfg, device="cpu")
    assert tr.gan_cfg == jtr.gan_cfg == {"worker": "cchunk",
                                         "loss": "LSGAN", "lr": 3e-4}
    assert tr.meta == jtr.meta
    assert isinstance(tr.discriminator, padv.WaveDiscriminator)
    assert tr.d_opt.param_groups[0]["lr"] == 3e-4


def test_train_state_crosses_both_ways(wave_run, tmp_path):
    """The port's GAN train state is read by the JAX restore_train_state
    and JAX's by the port's, D's leaves equal; a GAN-less trainer refuses
    a GAN checkpoint and a GAN trainer a GAN-less one."""
    tr = _port(wave_run, tmp_path / "p", GAN_CFG)
    tr.train_step(wave_run["raw"])
    flat = train_state_to_tree(tr)
    d_keys = {k for k in flat if k.startswith("d_")}
    want = {k for k in _flat(jax_tree(wave_run["new_state"]))
            if k.startswith("d_")}
    assert d_keys == want
    path = save_variables(str(tmp_path / "port.npz"), flat, tr.step)
    from pase_tpu.checkpoint import load_variables as jax_load
    tree, _ = jax_load(path)
    restored = jax_restore(jax.device_get(wave_run["new_state"]), tree)
    for k, v in _flat(jax_tree(restored)).items():
        if k.startswith("d_"):
            np.testing.assert_array_equal(v, flat[k], err_msg=k)
    assert int(restored.d_opt_state[0].count) == 1

    jpath = jax_save(str(tmp_path / "jax.npz"),
                     jax_tree(jax.device_get(wave_run["new_state"])), 1)
    jflat, _ = load_variables(jpath)
    back = _port(wave_run, tmp_path / "q", GAN_CFG)
    restore_train_state(back, jflat)
    got = train_state_to_tree(back)
    for k, v in jflat.items():
        if k.startswith("d_"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert back.step == 1

    plain = Trainer(SMALL_FE, GAN_BANK, _cfg(tmp_path / "n"), device="cpu")
    with pytest.raises(ValueError, match="no gan_cfg"):
        restore_train_state(plain, flat)
    no_d = {k: v for k, v in flat.items() if not k.startswith("d_")}
    with pytest.raises(ValueError, match="missing"):
        restore_train_state(_port(wave_run, tmp_path / "r", GAN_CFG), no_d)
    restore_train_state(plain, no_d)        # GAN-less into GAN-less


def test_gan_resume_is_bit_for_bit(tmp_path):
    """Two steps, save, a new trainer resumes and takes two more: the
    same losses, model and D state as four uninterrupted steps (the z
    prior's draws too)."""
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    batches = list(zip(range(4), SyntheticChunkBatcher(BATCH, CHUNK,
                                                       seed=4)))
    cfg = dict(Z_NORMAL_CFG, warmup=1)

    def run(trainer, steps):
        return [{k: float(v) for k, v in
                 trainer.train_step(batches[i][1]).items()} for i in steps]

    full = Trainer(SMALL_FE, GAN_BANK, _cfg(tmp_path / "full"),
                   device="cpu", gan_cfg=dict(cfg))
    want = run(full, range(4))
    first = Trainer(SMALL_FE, GAN_BANK, _cfg(tmp_path / "cut"),
                    device="cpu", gan_cfg=dict(cfg))
    run(first, range(2))
    first.save(0)
    second = Trainer(SMALL_FE, GAN_BANK, _cfg(tmp_path / "cut"),
                     device="cpu", gan_cfg=dict(cfg))
    assert second.try_resume() == 2
    assert run(second, range(2, 4)) == want[2:]
    a, b = train_state_to_tree(full), train_state_to_tree(second)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert os.path.exists(tmp_path / "cut" / "FE_e0.npz")


def test_wave_discriminator_under_the_bf16_policy_matches_jax():
    """D's cast points under the bf16 compute policy are the JAX
    package's (each SN conv in bf16, its bias promoting the sum to
    float32): the output within 2^-8 of max|y|."""
    from pase_tpu.precision import compute_dtype as jax_compute_dtype
    from pase_tpu_torch.precision import compute_dtype
    rng = np.random.RandomState(4)
    x = rng.randn(2, 4000).astype(np.float32) * 0.3
    jmod = jadv.WaveDiscriminator(**NARROW_D)
    v = _jax_d(jmod, x)
    port = _load_d(padv.WaveDiscriminator(**NARROW_D), v["params"],
                   v["batch_stats"]).eval()
    with jax_compute_dtype(jnp.bfloat16):
        want = np.asarray(jmod.apply(v, x, train=False))
    with compute_dtype(torch.bfloat16):
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert _rel(got.detach().numpy(), want) <= 2.0 ** -8


def test_bf16_wave_gan_step_matches_jax(tmp_path):
    """One wave-GAN step under the bf16 policy (the recipe's
    compute_dtype), port vs JAX from the same weights and batch: every
    loss, the G term and d_loss within 2^-7 relative (the bound of
    test_torch_precision's bf16 step)."""
    cfg = dict(_cfg(tmp_path / "jax"), compute_dtype="bfloat16")
    jtr = JaxTrainer(SMALL_FE, GAN_BANK, cfg,
                     mesh=get_mesh(devices=jax.devices()[:1]),
                     gan_cfg=dict(GAN_CFG))
    state = _init_state(jtr)
    dv = unfreeze(jax.jit(lambda k, a: jtr._d_module.init(
        k, a, train=False))(jax.random.PRNGKey(4), jnp.zeros((2, CHUNK, 1))))
    jtr._d_tx = optax.adam(GAN_CFG["lr"])
    state = state._replace(d_params=dv["params"],
                           d_batch_stats=dv["batch_stats"],
                           d_opt_state=jtr._d_tx.init(dv["params"]))
    raw = next(iter(JaxBatcher(BATCH, CHUNK, seed=24)))
    _, jlosses = jtr._make_train_step()(
        _fresh(state), {k: jnp.asarray(v) for k, v in raw.items()})
    run = {"params": _np_tree(state.params),
           "stats": _np_tree(state.batch_stats), "state": state}
    tr = Trainer(SMALL_FE, GAN_BANK,
                 dict(_cfg(tmp_path / "port"), compute_dtype="bfloat16"),
                 device="cpu", gan_cfg=dict(GAN_CFG))
    flat = {f"params/{k}": v for k, v in run["params"].items()}
    flat.update({f"batch_stats/{k}": v for k, v in run["stats"].items()})
    load_model_variables(tr.model, flat)
    _load_d(tr.discriminator, state.d_params, state.d_batch_stats)
    losses = tr.train_step(raw)
    assert set(losses) == set(jlosses)
    for name, want in jlosses.items():
        got, want = float(losses[name]), float(want)
        assert abs(got - want) <= 2.0 ** -7 * abs(want), (name, got, want)
