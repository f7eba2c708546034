"""The attention and chunking variants of the port (pase_tpu_torch/
attention.py, the per-worker view and the regularizer group of model.py)
against the JAX package, on the CPU, from bridged weights.

Bounds: an AttentionBlock's masked output and mask 1e-5, its
``running_dist`` 1e-6 after two train calls; ``make_chunk_masks`` equal
(both draw with numpy). The small PASE (the SMALL_FE encoder of
tests/test_torch_train.py; mi, cmi, mfcc and prosody heads; a
'regu_cchunk' regularizer) with attention or chunking in train mode:
each stream's hidden 1e-5 of its largest, per-worker losses 1e-5
relative, gradients 1e-4 of each leaf's largest (a bias before a
BatchNorm: both below 1e-5 of the encoder's largest gradient), running
statistics 1e-6."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from pase_tpu.attention import AttentionBlock as JaxAttention
from pase_tpu.attention import make_chunk_masks as jax_chunk_masks
from pase_tpu.model import build_pase as jax_build_pase
from pase_tpu.model import worker_losses as jax_worker_losses
from pase_tpu_torch.attention import AttentionBlock, make_chunk_masks
from pase_tpu_torch.checkpoint import (load_model_variables,
                                       model_state_dict_to_variables,
                                       variables_to_state_dict)
from pase_tpu_torch.model import build_pase, worker_losses
from test_torch_train import BN_CANCELLED, SMALL_FE
from torch_port_common import flat_variables, port_test_guard  # noqa: F401

B, T, HOP = 2, 4800, 160
FRAMES = T // HOP
ATT = {"K": 6, "avg_factor": 0.3, "att_mode": "avg_time", "hidden": [8]}
BANK = {
    "cls": [{"name": "mi", "num_outputs": 1, "hidden_size": 8,
             "hidden_layers": 1, "loss": "BCEWithLogitsLoss"},
            {"name": "cmi", "num_outputs": 1, "hidden_size": 8,
             "hidden_layers": 1, "loss": "BCEWithLogitsLoss"}],
    "regr": [{"name": "mfcc", "num_outputs": 39, "hidden_size": 8,
              "hidden_layers": 1, "loss": "MSELoss"},
             {"name": "prosody", "num_outputs": 12, "hidden_size": 8,
              "hidden_layers": 1, "loss": "L1Loss", "r": 3}],
    "regu": [{"name": "regu_cchunk", "loss": "MSELoss"}]}


def _block_case(mode):
    rng = np.random.RandomState(11)
    h = rng.randn(3, 7, 16).astype(np.float32)         # JAX [B, F, D]
    kw = dict(emb_dim=16, K=5, avg_factor=0.3, att_mode=mode, hidden=(8,))
    jmod = JaxAttention(**kw)
    v = unfreeze(jmod.init(jax.random.PRNGKey(3), jnp.asarray(h)))
    port = AttentionBlock(frames=7, **kw)
    port.load_state_dict(variables_to_state_dict(flat_variables(v)),
                         strict=True)
    return h, jmod, v, port


@pytest.mark.parametrize("mode", ["concat", "avg_time", "avg_time_batch"])
def test_attention_block_matches_jax(mode):
    h, jmod, v, port = _block_case(mode)
    ht = torch.from_numpy(h).transpose(1, 2)
    for _ in range(2):                               # train: the EMA moves
        (want, wmask), ups = jmod.apply(v, jnp.asarray(h), train=True,
                                        mutable=["batch_stats"])
        v = {**v, "batch_stats": ups["batch_stats"]}
        got, mask = port.train()(ht)
        np.testing.assert_allclose(got.transpose(1, 2).detach().numpy(),
                                   np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(mask.numpy(), np.asarray(wmask),
                                   atol=1e-5)
        assert (mask.sum(dim=1) == 5).all()
        np.testing.assert_allclose(
            port.running_dist.numpy(),
            np.asarray(v["batch_stats"]["running_dist"]), atol=1e-6)
    want, wmask = jmod.apply(v, jnp.asarray(h), train=False)
    before = port.running_dist.clone()
    got, mask = port.eval()(ht)
    np.testing.assert_allclose(mask.numpy(), np.asarray(wmask), atol=1e-5)
    assert torch.equal(port.running_dist, before)
    assert abs(float(port.running_dist.sum()) - 1.0) < 1e-5


def test_attention_ties_keep_the_lower_index_as_jax_top_k():
    """A zero scoring MLP makes every channel's score 1/D: both packages
    keep channels 0..K-1 (a stable descending sort, as jax.lax.top_k)."""
    h, jmod, v, port = _block_case("avg_time")
    v = jax.tree.map(jnp.zeros_like, v)
    v["batch_stats"]["running_dist"] = jnp.full((16,), 1 / 16)
    port.load_state_dict(variables_to_state_dict(flat_variables(v)),
                         strict=True)
    _, wmask = jmod.apply(v, jnp.asarray(h), train=False)
    _, mask = port.eval()(torch.from_numpy(h).transpose(1, 2))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    np.testing.assert_array_equal(mask[0].numpy(),
                                  (np.arange(16) < 5).astype(np.float32))


def test_chunk_masks_equal_jax():
    names = ["mi", "cmi", "lps", "mfcc", "prosody"]
    for k, emb in ((64, 256), (3, 16), (40, 32)):
        want = jax_chunk_masks(names, emb, k)
        got = make_chunk_masks(names, emb, k)
        for n in names:
            np.testing.assert_array_equal(got[n].numpy(),
                                          np.asarray(want[n]))
            assert got[n].sum() == min(k, emb)


def _batch(seed=12):
    rng = np.random.RandomState(seed)
    clean = (rng.randn(B, T) * 0.1).astype(np.float32)
    batch = {"cchunk": clean,
             "chunk": clean + (rng.randn(B, T) * 0.05).astype(np.float32),
             "chunk_ctxt": (rng.randn(B, T) * 0.1).astype(np.float32),
             "chunk_rand": (rng.randn(B, T) * 0.1).astype(np.float32),
             "mfcc": rng.randn(B, FRAMES, 39).astype(np.float32),
             "prosody": rng.randn(B, FRAMES, 12).astype(np.float32)}
    return batch


VARIANTS = {"attention": dict(att_cfg=ATT),
            "chunking": dict(chunking_K=5)}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    """The JAX model of a variant with randomized BatchNorm / PReLU
    parameters, one train-mode forward + gradient of the summed losses:
    (kind, variables, batch, JAX hidden, losses, gradients, new
    batch_stats)."""
    kind = request.param
    model, meta = jax_build_pase(SMALL_FE, BANK, **VARIANTS[kind])
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    v = jax.jit(lambda b: model.init(
        {"params": key, "sample": key, "dropout": key}, b, train=False))(
        jbatch)
    flat = flat_variables(v)
    rng = np.random.RandomState(7)
    for k, a in flat.items():
        if k.endswith("norm/weight"):
            flat[k] = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif k.endswith("norm/bias") or k.endswith("running_dist"):
            flat[k] = (rng.randn(*a.shape) * 0.1).astype(np.float32)
        elif k.endswith("act/weight"):
            flat[k] = rng.uniform(0.0, 0.3, a.shape).astype(np.float32)
    flat = {k: (np.abs(a) / np.abs(a).sum() if k.endswith("running_dist")
                else a) for k, a in flat.items()}
    tree = unflatten_dict({k: jnp.asarray(a) for k, a in flat.items()},
                          sep="/")

    def loss(params):
        (h, _, preds, labels), ups = model.apply(
            {"params": params, "batch_stats": tree["batch_stats"]}, jbatch,
            1.0, train=True, rngs={"sample": key, "dropout": key},
            mutable=["batch_stats"])
        losses = jax_worker_losses(meta, preds, labels)
        return sum(losses.values()), (losses, ups["batch_stats"], h)

    (_, (losses, new_bs, h)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(tree["params"])
    return (kind, flat, batch, {k: np.asarray(x) for k, x in h.items()},
            {k: float(x) for k, x in losses.items()},
            {k: np.asarray(g) for k, g in flatten_dict(
                unfreeze(grads), sep="/").items()},
            {k: np.asarray(x) for k, x in flatten_dict(
                unfreeze(new_bs), sep="/").items()})


@pytest.fixture(scope="module")
def port_step(variant):
    """The port's model from the same variables: one train-mode forward
    and backward of the summed losses on the same batch."""
    kind, flat, batch = variant[:3]
    model, meta = build_pase(SMALL_FE, BANK, frames=FRAMES,
                             **VARIANTS[kind])
    load_model_variables(model, flat)
    model.train()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    h, _, preds, labels = model(tbatch)
    losses = worker_losses(meta, preds, labels)
    sum(losses.values()).backward()
    losses = {k: v.detach() for k, v in losses.items()}
    grads = model_state_dict_to_variables(
        {n: (p.grad if p.grad is not None else torch.zeros_like(p))
         for n, p in model.named_parameters()})
    stats = model_state_dict_to_variables(
        {k: b for k, b in model.state_dict().items()
         if "running" in k})
    return (model, h, {k: v.item() for k, v in losses.items()}, grads,
            stats)


def test_variant_forward_and_losses_match_jax(variant, port_step):
    kind, _, _, jh, jlosses = variant[:5]
    model, h, losses = port_step[:3]
    assert set(h) == set(jh) == {"chunk", "chunk_ctxt", "chunk_rand",
                                 "cchunk"}
    for k, want in jh.items():
        got = h[k].transpose(1, 2).detach().numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), k
    assert set(losses) == set(jlosses)
    assert jlosses["regu_cchunk"] > 0
    for k, want in jlosses.items():
        assert abs(losses[k] - want) <= 1e-5 * abs(want), (k, losses[k],
                                                           want)
    assert model.worker_names == ["mi", "cmi", "mfcc", "prosody",
                                  "regu_cchunk"]


def test_variant_gradients_match_jax(variant, port_step):
    jgrads = variant[5]
    grads = port_step[3]
    assert {k[len("params/"):] for k in grads} == set(jgrads)
    fe_max = max(np.abs(g).max() for k, g in jgrads.items()
                 if k.startswith("frontend/"))
    for k, g in jgrads.items():
        got = grads["params/" + k]
        if k in BN_CANCELLED:
            assert np.abs(g).max() <= 1e-5 * fe_max, k
            assert np.abs(got).max() <= 1e-5 * fe_max, k
            continue
        if k.startswith("att_"):
            # the mask is not differentiated: the scoring MLP gets none
            assert not np.any(g) and not np.any(got), k
            continue
        err = np.abs(got - g).max()
        assert err <= 1e-4 * np.abs(g).max(), (k, err, np.abs(g).max())


def test_variant_running_statistics_match_jax(variant, port_step):
    kind, new_bs = variant[0], variant[6]
    stats = port_step[4]
    assert {k[len("batch_stats/"):] for k in stats} == set(new_bs)
    assert any(k.endswith("running_dist") for k in new_bs) == (
        kind == "attention")
    for k, want in new_bs.items():
        err = np.abs(stats["batch_stats/" + k] - want).max()
        assert err <= 1e-6, (k, err)
