"""The port's recurrent layers against the JAX package on the CPU: the
bidirectional ``BiRNN`` (lstm / gru context of WaveFe), the flax-cell
``FlaxRNN`` and the ``GRUMinion`` head, on the same weights and the same
seeded numpy inputs.

The JAX side runs its ``lax.scan`` recurrences at 'highest' matmul
precision (tests/conftest.py); the torch side runs torch's GRU / LSTM in
float32 on the CPU (cuDNN's on the card: tests/test_torch_cuda.py).

Bounds (float32 sums in different orders):
  * forwards: max|y_torch - y_jax| <= 1e-5 x max|y_jax|;
  * gradients: 1e-4 x max|g| of each parameter leaf (a bias that feeds a
    BatchNorm has gradient 0: both sides below 1e-5 of the encoder's
    largest gradient, as tests/test_torch_train.py holds them);
  * a train step's per-worker losses: 1e-5 relative;
  * parameters after one Adam step from shared weights: 1e-6 absolute;
  * Adam moments of a resumed checkpoint: 1e-6 absolute; the weight
    bridge and the artifacts' inputs: exact; an exported artifact against
    the JAX artifact: 1e-5, as tests/test_torch_serving.py holds it.
"""

import argparse
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from pase_tpu import frontend as jax_frontend
from pase_tpu.minions import GRUMinion as JaxGRUMinion
from pase_tpu.nn import BiRNN as JaxBiRNN
from pase_tpu_torch import frontend, serving, streaming
from pase_tpu_torch.checkpoint import (load_model_variables,
                                       model_state_dict_to_variables,
                                       model_variables_to_state_dict,
                                       state_dict_to_variables,
                                       variables_to_state_dict)
from pase_tpu_torch.minions import GRUMinion
from pase_tpu_torch.nn import BiRNN, FlaxRNN
from pase_tpu_torch.trainer import Trainer
from test_torch_train import (ADAM_B1, BN_CANCELLED, _cfg, _fresh,
                              _init_state, _np_tree)
from torch_port_common import flat_variables, jax_variables, rel_err
from torch_port_common import port_test_guard  # noqa: F401

FWD_REL = 1e-5
GRAD_REL = 1e-4
LOSS_REL = 1e-5
ADAM_ATOL = 1e-6
# tests/test_rnn_types.py's narrow WaveFe with a context layer
RNN_FE = {"kwidths": [65, 10, 5, 5], "strides": [1, 10, 4, 4],
          "fmaps": [32, 32, 64, 64], "emb_dim": 64, "norm_out": True,
          "rnn_pool": True, "rnn_dim": 64, "denseskips": True}
# a worker bank with an MLP head and a GRU head (prosody and its deltas)
BANK = {"regr": [
    {"num_outputs": 39, "dropout": 0, "hidden_size": 32, "hidden_layers": 1,
     "name": "mfcc", "context": 1, "r": 1, "loss": "MSELoss",
     "skip": False},
    {"num_outputs": 12, "dropout": 0, "hidden_size": 16, "hidden_layers": 2,
     "name": "prosody", "type": "gru", "loss": "MSELoss", "skip": False}],
    "cls": []}


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in
            flatten_dict(unfreeze(tree), sep="/").items()}


def _perturbed(variables, seed, scale=0.1):
    """Every leaf plus seeded noise (biases away from their 0 init)."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda v: jnp.asarray(
        (np.asarray(v) + rng.randn(*np.shape(v)) * scale)
        .astype(np.float32)), variables)


def _grads_of(module):
    return state_dict_to_variables(
        {k: p.grad for k, p in module.named_parameters()})


def _assert_grads(got, want, rel=GRAD_REL):
    assert set(got) == set(want)
    for k, g in want.items():
        err = np.abs(got[k] - np.asarray(g)).max()
        assert err <= rel * np.abs(g).max(), (k, err, np.abs(g).max())


# ---------------------------------------------------------------------------
# BiRNN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_birnn_matches_jax(cell, layers):
    """Forward within 1e-5, gradients of sum(y * r) with respect to every
    parameter and the input within 1e-4 of each leaf's largest."""
    rng = np.random.RandomState(layers)
    x = rng.randn(2, 23, 6).astype(np.float32)
    r = rng.randn(2, 23, 10).astype(np.float32)
    jm = JaxBiRNN(hidden=5, layers=layers, cell=cell)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def loss(params, xin):
        return jnp.sum(jm.apply({"params": params}, xin) * r)

    y_jax = np.asarray(jm.apply(v, jnp.asarray(x)))
    g_params, g_x = jax.grad(loss, argnums=(0, 1))(v["params"],
                                                   jnp.asarray(x))
    pm = BiRNN(6, 5, layers=layers, cell=cell)
    pm.load_state_dict(variables_to_state_dict(flat_variables(v)),
                       strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    y = pm(xt)
    assert y.shape == y_jax.shape == (2, 23, 10)
    assert rel_err(y.detach().numpy(), y_jax) <= FWD_REL
    (y * torch.from_numpy(r)).sum().backward()
    _assert_grads(_grads_of(pm), {f"params/{k}": g for k, g in
                                  _flat_np(g_params).items()})
    assert rel_err(xt.grad.numpy(), g_x) <= GRAD_REL


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_birnn_is_torch_rnn_in_its_layout(cell):
    """The port's parameter names are torch's nn.LSTM / nn.GRU ones: a
    reference state dict loads strictly and the outputs agree."""
    ref = {"lstm": torch.nn.LSTM, "gru": torch.nn.GRU}[cell](
        6, 5, num_layers=2, bidirectional=True, batch_first=True)
    pm = BiRNN(6, 5, layers=2, cell=cell)
    pm.load_state_dict(ref.state_dict(), strict=True)
    x = torch.from_numpy(np.random.RandomState(4).randn(3, 17, 6)
                         .astype(np.float32))
    with torch.no_grad():
        want, _ = ref(x)
        got = pm(x)
    assert rel_err(got.numpy(), want.numpy()) <= FWD_REL


def test_birnn_dropout_between_layers_only():
    """Train-mode dropout falls between layers, its masks drawn from the
    module's dropout_generator (not torch's global RNG): two seeds differ,
    one seed repeats whatever the global RNG does; with p = 0 the
    layer-by-layer path is the one cuDNN-style call; eval ignores it; one
    layer has none; no generator raises."""
    pm = BiRNN(6, 5, layers=2, cell="lstm", dropout=0.5).train()
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 9, 6)
                         .astype(np.float32))
    gen = torch.Generator()
    pm.dropout_generator = gen

    def run(seed):
        gen.manual_seed(seed)
        torch.manual_seed(seed + 100)
        with torch.no_grad():
            return pm(x)

    assert not torch.equal(run(0), run(1))
    assert torch.equal(run(0), run(0))
    with torch.no_grad():
        assert torch.equal(pm.eval()(x), pm(x))
        whole = pm.train()._run(x, pm._flat_weights, 2)
        pm.dropout = 1e-30
        torch.testing.assert_close(pm(x), whole, rtol=1e-6, atol=1e-7)
        pm.dropout = 0.5
    one = BiRNN(6, 5, layers=1, cell="lstm", dropout=0.5)
    with torch.no_grad():
        assert torch.equal(one.train()(x), one.eval()(x))
    pm.dropout_generator = None
    with pytest.raises(ValueError, match="torch.Generator"):
        pm(x)


def test_unknown_rnn_type_raises():
    with pytest.raises(TypeError, match="Unrecognized rnn type"):
        frontend.build_wavefe(dict(RNN_FE, rnn_type="elman"))
    with pytest.raises(TypeError, match="Unrecognized rnn type"):
        BiRNN(4, 4, cell="elman")


# ---------------------------------------------------------------------------
# WaveFe with an lstm / gru context layer
# ---------------------------------------------------------------------------


def _encoders(rnn_type, seed=0, layers=1):
    cfg = dict(RNN_FE, rnn_type=rnn_type, rnn_layers=layers)
    jm = jax_frontend.build_wavefe(cfg)
    variables = jax_variables(jm, 4800, seed=seed)
    pm = frontend.build_wavefe(cfg).eval()
    sd = variables_to_state_dict(flat_variables(variables))
    pm.load_state_dict(dict(pm.state_dict(), **sd), strict=True)
    return cfg, jm, variables, pm


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_wavefe_eval_matches_jax(rnn_type):
    _, jm, variables, pm = _encoders(rnn_type, layers=2)
    x = (np.random.RandomState(1).randn(2, 4800) * 0.1).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 30, 64)
    assert rel_err(got, want) <= FWD_REL, rel_err(got, want)


@pytest.fixture(scope="module", params=["lstm", "gru"])
def rnn_setup(request, tmp_path_factory):
    """The JAX Trainer of an lstm / gru WaveFe with BANK, its seeded state
    (BatchNorm affine params randomized), its compiled step and three
    synthetic batches."""
    from pase_tpu.data.dataset import SyntheticChunkBatcher as JaxBatcher
    from pase_tpu.parallel.mesh import get_mesh
    from pase_tpu.trainer import Trainer as JaxTrainer
    rnn_type = request.param
    tmp = tmp_path_factory.mktemp(f"rnn_{rnn_type}")
    fe = dict(RNN_FE, rnn_type=rnn_type)
    jtr = JaxTrainer(fe, BANK, _cfg(tmp / "jax"),
                     mesh=get_mesh(devices=jax.devices()[:1]))
    state = _init_state(jtr)
    params = _np_tree(state.params)
    rng = np.random.RandomState(7)
    for k, v in params.items():
        if k.endswith("norm/weight"):
            params[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("norm/bias") or "gru_" in k and k.endswith("bias"):
            params[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    state = state._replace(params=unflatten_dict(
        {k: jnp.asarray(v) for k, v in params.items()}, sep="/"))
    it = iter(JaxBatcher(2, 4800, seed=3))
    return (rnn_type, fe, jtr, state, jtr._make_train_step(),
            [next(it) for _ in range(3)], tmp)


def _port_trainer(setup, name):
    _, fe, _, state, _, _, tmp = setup
    tr = Trainer(fe, BANK, _cfg(tmp / name), device="cpu")
    flat = {f"params/{k}": v for k, v in _np_tree(state.params).items()}
    flat.update({f"batch_stats/{k}": v
                 for k, v in _np_tree(state.batch_stats).items()})
    load_model_variables(tr.model, flat)
    return tr


def test_wavefe_train_step_matches_jax(rnn_setup):
    """One base-policy step: per-worker losses within 1e-5, gradients
    (read from the JAX step's Adam first moment) within 1e-4 a leaf,
    BiRNN and GRU head leaves included."""
    _, _, _, state, step, batches, _ = rnn_setup
    new_state, jlosses = step(_fresh(state), {k: jnp.asarray(v) for k, v
                                              in batches[0].items()})
    grads = {}
    for group in new_state.opt_state.inner_states.values():
        for k, mu in flatten_dict(unfreeze(group.inner_state[0].mu),
                                  sep="/").items():
            if not isinstance(mu, optax.MaskedNode):
                grads[k] = np.asarray(mu, np.float64) / (1.0 - ADAM_B1)
    tr = _port_trainer(rnn_setup, "one")
    losses = tr.train_step(batches[0])
    for name in tr.ordered_names + ["total"]:
        got, want = float(losses[name]), float(jlosses[name])
        assert abs(got - want) <= LOSS_REL * abs(want), (name, got, want)
    port = model_state_dict_to_variables(
        {k: p.grad for k, p in tr.model.named_parameters()})
    assert {k[len("params/"):] for k in port} == set(grads)
    assert any("/rnn/l0_bw_w_hh" in k for k in grads)
    assert any("prosody/gru_1/hn/bias" in k for k in grads)
    fe_max = max(np.abs(g).max() for k, g in grads.items()
                 if k.startswith("frontend/"))
    for k, g in grads.items():
        got = port["params/" + k]
        if k in BN_CANCELLED:
            assert np.abs(g).max() <= 1e-5 * fe_max, k
            assert np.abs(got).max() <= 1e-5 * fe_max, k
            continue
        err = np.abs(got - g).max()
        assert err <= GRAD_REL * np.abs(g).max(), (k, err, np.abs(g).max())


def test_jax_rnn_checkpoint_resumes_in_the_port(rnn_setup, tmp_path):
    """A JAX Trainer's lstm / gru checkpoint after one step resumes in the
    port (its Adam moments within 1e-6 after the bridge), and the port's
    train state passes the JAX strict restore with the port's numbers."""
    from pase_tpu.checkpoint import load_variables, restore_train_state
    _, fe, jtr, state, step, batches, _ = rnn_setup
    jtr.save_path = jtr.saver.save_path = str(tmp_path / "jax")
    jtr.saver.index_path = str(tmp_path / "jax" / "PASE-checkpoints")
    state, _ = step(_fresh(state), {k: jnp.asarray(v)
                                    for k, v in batches[0].items()})
    jtr.save(state, 0)
    tr = Trainer(fe, BANK, _cfg(tmp_path / "jax"), device="cpu")
    assert tr.try_resume() == 1 and tr.opt_count == 1
    for gst in state.opt_state.inner_states.values():
        adam = gst.inner_state[0]
        for leaf, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            want = {k: np.asarray(v) for k, v in flatten_dict(
                getattr(adam, leaf), sep="/").items()
                if isinstance(v, jax.Array)}
            got = model_state_dict_to_variables(
                {n: tr.opt.state[p][key]
                 for n, p in tr.model.named_parameters()})
            for k, w in want.items():
                assert np.abs(got["params/" + k] - w).max() <= ADAM_ATOL, k
    port = _port_trainer(rnn_setup, "port_ckpt")
    port.train_step(batches[1])
    port.save(0)
    tree, meta = load_variables(
        f"{port.save_path}/weights_PASE-Pase_base-1.npz")
    restored = restore_train_state(jax.device_get(state), tree)
    assert int(restored.step) == 1 and meta == {"step": 1}
    got = {"params/" + k: np.asarray(v) for k, v in
           flatten_dict(restored.params, sep="/").items()}
    want = model_state_dict_to_variables(port.model.state_dict())
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_rnn_encoder_checkpoints_both_ways(rnn_type, tmp_path):
    """A native npz (the JAX writer) and the reference-layout .ckpt of the
    JAX CLI's export-torch load strictly into the port with equal arrays
    (BiRNN leaves copied, no transpose); the port's npz loads in JAX."""
    import util_scripts
    from pase_tpu.checkpoint import load_variables, save_variables
    from pase_tpu_torch.checkpoint import save_variables_npz
    cfg, _, variables, _ = _encoders(rnn_type, seed=3, layers=2)
    flat = flat_variables(variables)
    npz = str(tmp_path / "FE_e0.npz")
    save_variables(npz, variables, step=0)
    ckpt = str(tmp_path / "FE_e0.ckpt")
    util_scripts.export_torch(argparse.Namespace(in_ckpt=npz,
                                                 out_ckpt=ckpt))
    for path in (npz, ckpt):
        enc = frontend.wf_builder(cfg, device="cpu", seed=5)
        enc.load_pretrained(path)
        got = state_dict_to_variables(enc.module.state_dict())
        assert sorted(got) == sorted(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    np.testing.assert_array_equal(
        enc.module.state_dict()["rnn.weight_hh_l1_reverse"].numpy(),
        flat["params/rnn/l1_bw_w_hh"])
    back = save_variables_npz(str(tmp_path / "port.npz"),
                              enc.module.state_dict())
    jflat = flat_variables(load_variables(back)[0])
    for k, v in flat.items():
        np.testing.assert_array_equal(jflat[k], v, err_msg=k)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_rnn_encoder_exports_as_jax_does(rnn_type, tmp_path):
    """The JAX CLI's export takes an lstm / gru encoder, so the port's
    does: its artifact serves within 1e-5 of the JAX artifact."""
    from pase_tpu.serving import ServingEncoder as JaxServing
    from pase_tpu.serving import export_encoder as jax_export
    cfg = {"kwidths": [65, 10, 4, 4], "strides": [1, 10, 4, 4],
           "fmaps": [16, 16, 24, 24], "emb_dim": 24, "norm_out": True,
           "rnn_pool": True, "rnn_dim": 24, "denseskips": True,
           "rnn_type": rnn_type}
    jm = jax_frontend.build_wavefe(cfg)
    variables = jax_variables(jm, 3200, seed=2)

    jout, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_export(argparse.Namespace(module=jm, variables=variables, cfg=cfg),
               jout, chunk_sizes=(1600, 3200), platforms=("cpu",))
    enc = frontend.wf_builder(cfg, device="cpu")
    sd = variables_to_state_dict(flat_variables(variables))
    enc.module.load_state_dict(dict(enc.module.state_dict(), **sd))
    serving.export_encoder(enc, out, chunk_sizes=(1600, 3200))
    wav = (np.random.RandomState(3).randn(7000) * 0.2).astype(np.float32)
    want = np.asarray(JaxServing(jout).encode(wav))
    got = serving.ServingEncoder(out).encode(wav)
    assert got.shape == want.shape == (24, 43)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_streaming_refuses_rnn_encoders_as_jax_does(rnn_type):
    from pase_tpu.streaming import StreamingEncoder as JaxStream
    cfg = dict(RNN_FE, rnn_type=rnn_type)
    jenc = jax_frontend.wf_builder(cfg)
    jenc.init(example_len=4800)
    with pytest.raises(NotImplementedError):
        JaxStream(jenc)
    with pytest.raises(NotImplementedError, match="only the QRNN streams"):
        streaming.StreamingEncoder(frontend.wf_builder(cfg, device="cpu"))


# ---------------------------------------------------------------------------
# the flax-cell layer and the GRU head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_flax_rnn_matches_flax_cell(cell):
    """nn.RNN of a flax GRUCell / LSTMCell from h = 0: forward within
    1e-5, gradients within 1e-4 a leaf; one step of ``step`` equals the
    cell's; the bridge back to flax's tree is exact."""
    import flax.linen as fnn
    rng = np.random.RandomState(2)
    x = rng.randn(2, 19, 6).astype(np.float32)
    r = rng.randn(2, 19, 7).astype(np.float32)
    flax_cell = {"gru": fnn.GRUCell, "lstm": fnn.LSTMCell}[cell]
    jm = fnn.RNN(flax_cell(7))
    v = _perturbed(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), 3)

    def loss(params):
        return jnp.sum(jm.apply({"params": params}, jnp.asarray(x)) * r)

    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    g = jax.grad(loss)(v["params"])
    pm = FlaxRNN(6, 7, cell).load_flax(v["params"]["cell"])
    y = pm(torch.from_numpy(x))
    assert rel_err(y.detach().numpy(), want) <= FWD_REL
    (y * torch.from_numpy(r)).sum().backward()
    got = state_dict_to_variables(
        {f"cell.{k}": p.grad for k, p in pm.named_parameters()})
    _assert_grads(got, {f"params/{k}": w for k, w in _flat_np(g).items()})
    back = state_dict_to_variables(
        {f"cell.{k}": p for k, p in pm.state_dict().items()})
    for k, w in _flat_np(v).items():
        np.testing.assert_array_equal(back[k], w, err_msg=k)
    h0 = torch.zeros(2, 7)
    carry = h0 if cell == "gru" else (h0, h0)
    with torch.no_grad():
        h1 = pm.step(torch.from_numpy(x[:, 0]), carry)
    h1 = h1 if cell == "gru" else h1[0]
    assert rel_err(h1.numpy(), want[:, 0]) <= FWD_REL


def _gru_pair(seed=0, din=6, dout=3):
    jm = JaxGRUMinion(num_outputs=dout, hidden_size=8, hidden_layers=2)
    x = np.random.RandomState(seed).randn(2, 21, din).astype(np.float32)
    v = _perturbed(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)),
                   seed + 1)
    pm = GRUMinion(din, dout, hidden_size=8, hidden_layers=2)
    load_model_variables(_Wrap(pm), {f"params/head/{k}": w for k, w in
                                     _flat_np(v["params"]).items()})
    return jm, v, pm, x


class _Wrap(torch.nn.Module):
    """A head at ``workers.head`` (the model bridge's layout)."""

    def __init__(self, head):
        super().__init__()
        self.workers = torch.nn.ModuleDict({"head": head})


def test_gru_minion_matches_jax():
    jm, v, pm, x = _gru_pair()
    r = np.random.RandomState(9).randn(2, 21, 3).astype(np.float32)

    def loss(params, xin):
        return jnp.sum(jm.apply({"params": params}, xin) * r)

    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    g_p, g_x = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    xt = torch.from_numpy(x.transpose(0, 2, 1).copy()).requires_grad_()
    y = pm(xt, alpha=1.0).transpose(1, 2)
    assert y.shape == want.shape == (2, 21, 3)
    assert rel_err(y.detach().numpy(), want) <= FWD_REL
    (y * torch.from_numpy(r)).sum().backward()
    got = model_state_dict_to_variables(
        {f"workers.head.{k}": p.grad for k, p in pm.named_parameters()})
    _assert_grads(got, {f"params/head/{k}": w
                        for k, w in _flat_np(g_p).items()})
    assert rel_err(xt.grad.numpy().transpose(0, 2, 1), g_x) <= GRAD_REL


def _adam_step_matches_optax(jm_apply, jparams, pm, loss_port, lr=1e-3):
    """One optax.adam step on JAX's loss and one torch Adam step (b1 0.9,
    b2 0.999, eps 1e-8) on the port's, from the same parameters: every
    JAX leaf within 1e-6, and the port holds exactly as many trainable
    numbers as JAX (no parameter for a bias flax does not have)."""
    tx = optax.adam(lr)
    grads = jax.grad(jm_apply)(jparams)
    upd, _ = tx.update(grads, tx.init(jparams), jparams)
    want = _flat_np(optax.apply_updates(jparams, upd))
    n_jax = sum(w.size for w in want.values())
    assert sum(p.numel() for p in pm.parameters()) == n_jax
    opt = torch.optim.Adam(pm.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    opt.zero_grad()
    loss_port().backward()
    opt.step()
    return want


def test_gru_minion_adam_step_matches_optax():
    jm, v, pm, x = _gru_pair(seed=4)
    r = np.random.RandomState(5).randn(2, 21, 3).astype(np.float32)
    want = _adam_step_matches_optax(
        lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) * r),
        v["params"], pm,
        lambda: (pm(torch.from_numpy(x.transpose(0, 2, 1).copy()))
                 .transpose(1, 2) * torch.from_numpy(r)).sum())
    got = model_state_dict_to_variables(
        {f"workers.head.{k}": p for k, p in pm.state_dict().items()})
    for k, w in want.items():
        err = np.abs(got[f"params/head/{k}"] - w).max()
        assert err <= ADAM_ATOL, (k, err)
    # the r and z rows of the GRU's hidden bias stay exactly 0
    for i in range(2):
        b_hh = getattr(pm, f"gru_{i}").weights()[3]
        assert torch.count_nonzero(b_hh[:16]) == 0


def test_gru_head_model_bridge_round_trip():
    """The GRU head's flax cells <-> FlaxRNN through the model bridge:
    exact both ways, every port key covered."""
    _, v, pm, _ = _gru_pair(seed=6)
    flat = {f"params/head/{k}": w for k, w in _flat_np(v["params"]).items()}
    sd = model_variables_to_state_dict(flat)
    assert set(sd) == {f"workers.head.{k}" for k in pm.state_dict()}
    back = model_state_dict_to_variables(sd)
    assert set(back) == set(flat)
    for k, w in flat.items():
        np.testing.assert_array_equal(back[k], w, err_msg=k)


def test_gru_head_builds_in_the_bank():
    from pase_tpu_torch.model import build_pase
    model, _ = build_pase(dict(RNN_FE, rnn_type="gru"), BANK)
    assert isinstance(model.workers["prosody"], GRUMinion)
    assert isinstance(model.workers["prosody"].gru_1, FlaxRNN)


def test_rnn_classifier_layers_hold_no_absent_bias():
    """The probes' GRU / LSTM heads share the flax-cell layer: a GRU
    holds 3H input and H hidden biases, an LSTM 4H hidden ones, as the
    flax cells do."""
    from pase_tpu_torch.probes.classifier import RNNClassifier
    gru = RNNClassifier(6, 3, hidden=8, cell_type="gru").rnns[0]
    lstm = RNNClassifier(6, 3, hidden=8, cell_type="lstm").rnns[0]
    assert {k: tuple(p.shape) for k, p in gru.named_parameters()} == {
        "weight_ih": (24, 6), "weight_hh": (24, 8), "bias_ih": (24,),
        "bias_hn": (8,)}
    assert {k: tuple(p.shape) for k, p in lstm.named_parameters()} == {
        "weight_ih": (32, 6), "weight_hh": (32, 8), "bias_hh": (32,)}


def test_rnn_encoder_cfg_files_build():
    """PASE+.cfg with rnn_type lstm / gru builds, hidden rnn_dim // 2 each
    way, rnn_dim features into W."""
    with open("cfg/frontend/PASE+.cfg") as f:
        cfg = json.load(f)
    for rt in ("lstm", "gru"):
        m = frontend.build_wavefe(dict(cfg, rnn_type=rt))
        assert isinstance(m.rnn, BiRNN) and m.rnn.hidden_size == 256
        assert m.W.weight.shape[1] == 512
