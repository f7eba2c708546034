"""The overlap worker head of the port (pase_tpu_torch.model) against the
JAX Trainer, on the CPU.

A small bank of LIM (``mi``, which reads the concatenated pos/neg pair,
2 x emb channels) and ``overlap`` (an MLP on the chunk stream alone, emb
channels, BCE on the frame label of the overlap distortion) on
``test_torch_train``'s narrow encoder. The batch carries its own 0/1
overlap label, which both prepares pass through. Bounds are those of
``test_torch_train``: per-worker losses within 1e-5 relative, gradients
within 1e-4 x max|g| per parameter leaf.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import unflatten_dict

from pase_tpu.data.dataset import SyntheticChunkBatcher as JaxBatcher
from pase_tpu.parallel.mesh import get_mesh
from pase_tpu.trainer import Trainer as JaxTrainer
from pase_tpu_torch.checkpoint import (load_model_variables,
                                       model_state_dict_to_variables,
                                       model_variables_to_state_dict)
from pase_tpu_torch.model import build_pase
from pase_tpu_torch.trainer import Trainer
from test_torch_train import (ADAM_B1, BATCH, BN_CANCELLED, CHUNK, SMALL_FE,
                              _cfg, _fresh, _init_state, _np_tree)
from torch_port_common import port_test_guard  # noqa: F401

HEAD = {"num_outputs": 1, "dropout": 0, "hidden_size": 32,
        "hidden_layers": 1, "loss": "BCEWithLogitsLoss", "skip": False}
BANK = {"cls": [dict(HEAD, name="mi"), dict(HEAD, name="overlap")],
        "regr": []}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX trainer's state with randomized BatchNorm affine and PReLU
    slopes, a batch with an overlap label, and the JAX step's losses and
    gradient (read back from Adam's first moment)."""
    import optax
    from flax.core import unfreeze
    from flax.traverse_util import flatten_dict
    tmp = tmp_path_factory.mktemp("overlap")
    jtr = JaxTrainer(SMALL_FE, BANK, _cfg(tmp / "jax"),
                     mesh=get_mesh(devices=jax.devices()[:1]))
    state = _init_state(jtr)
    params = _np_tree(state.params)
    rng = np.random.RandomState(11)
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
    raw = next(iter(JaxBatcher(BATCH, CHUNK, seed=5)))
    raw["overlap"] = (rng.rand(BATCH, CHUNK // 160) > 0.5).astype(
        np.float32)
    new_state, losses = jtr._make_train_step()(
        _fresh(state), {k: jnp.asarray(v) for k, v in raw.items()})
    grads = {}
    for group in new_state.opt_state.inner_states.values():
        adam = group.inner_state[0]
        for k, mu in flatten_dict(unfreeze(adam.mu), sep="/").items():
            if not isinstance(mu, optax.MaskedNode):
                grads[k] = np.asarray(mu, np.float64) / (1.0 - ADAM_B1)
    return (params, stats, raw, {k: float(v) for k, v in losses.items()},
            grads, tmp)


def _port(jax_run_, name):
    params, stats, _, _, _, tmp = jax_run_
    tr = Trainer(SMALL_FE, BANK, _cfg(tmp / name), device="cpu")
    flat = {f"params/{k}": v for k, v in params.items()}
    flat.update({f"batch_stats/{k}": v for k, v in stats.items()})
    load_model_variables(tr.model, flat)
    return tr


def test_overlap_head_reads_the_chunk_stream():
    """overlap's first conv takes emb channels, mi's 2 x emb; both end in
    one logit per frame."""
    model, _ = build_pase(SMALL_FE, BANK)
    emb = model.frontend.output_dim
    assert model.workers["overlap"].blocks[0].W.weight.shape[1] == emb
    assert model.workers["mi"].blocks[0].W.weight.shape[1] == 2 * emb
    assert model.workers["overlap"].W.weight.shape[0] == 1


def test_overlap_weight_bridge_round_trip(jax_run):
    """The JAX variables of the bank, the overlap head's included, map to
    the port's state dict and back exactly, and load strictly."""
    params, stats = jax_run[0], jax_run[1]
    assert any(k.startswith("overlap/") for k in params)
    flat = {f"params/{k}": v for k, v in params.items()}
    flat.update({f"batch_stats/{k}": v for k, v in stats.items()})
    tr = _port(jax_run, "bridge")
    sd = model_variables_to_state_dict(flat)
    assert set(sd) == {k for k in tr.model.state_dict()
                       if not k.endswith("num_batches_tracked")}
    back = model_state_dict_to_variables(tr.model.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_overlap_train_step_matches_jax(jax_run):
    _, _, raw, jlosses, grads, _ = jax_run
    tr = _port(jax_run, "step")
    losses = tr.train_step(raw)
    assert tr.ordered_names == ["mi", "overlap"]
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


@pytest.mark.parametrize("bank", [
    {"cls": [dict(HEAD, name="mi", dropin=0.5)], "regr": []},
    {"cls": [], "regr": [], "regu": [dict(HEAD, name="cchunk_regu")]},
], ids=["gru_head", "regu_worker"])
def test_unported_heads_still_raise(bank):
    """SPC and Gap build since they were ported (tests/test_torch_spc_gap),
    the GRU head too (tests/test_torch_recurrent.py); a dropin MLP head
    (item 9e; the case keeps its id) and a regularizer worker still
    raise, naming their ROADMAP item."""
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md, queue 1: off-path model variants"):
        build_pase(SMALL_FE, bank)
