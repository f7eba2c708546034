"""The port's Kaldi MFCC / PLP worker targets (pase_tpu_torch.ops
.kaldi_feats), their worker dispatch, ZNorm statistics and one training
step with both heads, against the JAX package on the CPU.

Bounds: each target within 1e-4 of its largest value (FFTs of another
library, sums in another order) on speech-like noise, the synthetic
batcher's speech, zeros, near-silence and the MFCC of pure tones. PLP of a
pure tone is ill-conditioned: its order-20 Levinson-Durbin on 22 bark
bins of a one-line spectrum moves JAX's own output by about 1e-3 of its
largest value when JAX's float32 spectrum is replaced by the float64 one.
There the port's error to the float64 evaluation of the same pipeline must
be at most twice JAX's own, or within 1e-4. Against the golden fixture the
golden test's own tolerance (atol 5e-5, rtol 1e-4,
tests/test_features.py); the step's losses within 1e-5 relative of JAX's;
the ZNorm statistics within 1e-4 of each target's largest."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pase_tpu.data import pipeline as jax_pipeline
from pase_tpu.data.dataset import SyntheticChunkBatcher as JaxBatcher
from pase_tpu.model import parse_workers_cfg as jax_parse_workers
from pase_tpu.ops import features as jax_features
from pase_tpu.ops import kaldi_feats as jax_kaldi
from pase_tpu.parallel.mesh import get_mesh
from pase_tpu.trainer import Trainer as JaxTrainer
from pase_tpu_torch.checkpoint import load_model_variables
from pase_tpu_torch.data import pipeline
from pase_tpu_torch.model import parse_workers_cfg
from pase_tpu_torch.ops import features, kaldi_feats
from pase_tpu_torch.trainer import Trainer
from test_torch_train import SMALL_FE, _cfg, _init_state, _np_tree
from torch_port_common import rel_err
from torch_port_common import port_test_guard  # noqa: F401

REL = 1e-4
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "features_golden.npz")
T = 16000
# the two heads of the Kaldi worker bank, each shaped like workers+'s
# mfcc head at a narrow width; der_order set explicitly (kaldiplp's dim
# defaults to der_order 2, kaldi_plp's features to 0)
KALDI_HEADS = [
    {"num_outputs": 39, "dropout": 0, "hidden_size": 32, "hidden_layers": 1,
     "name": "kaldimfcc", "r": 7, "loss": "MSELoss", "skip": False,
     "transform": {"num_ceps": 13, "der_order": 2}},
    {"num_outputs": 20, "dropout": 0, "hidden_size": 32, "hidden_layers": 1,
     "name": "kaldiplp", "r": 7, "loss": "MSELoss", "skip": False,
     "transform": {"num_ceps": 20, "der_order": 0}}]
WORKERS = {"regr": [{"num_outputs": 39, "dropout": 0, "hidden_size": 32,
                     "hidden_layers": 1, "name": "mfcc", "r": 7,
                     "loss": "MSELoss", "skip": False}] + KALDI_HEADS,
           "cls": [{"num_outputs": 1, "dropout": 0, "hidden_size": 32,
                    "hidden_layers": 1, "name": "mi",
                    "loss": "BCEWithLogitsLoss", "skip": False}]}


def _signals():
    rng = np.random.RandomState(0)
    batch = next(iter(JaxBatcher(2, T, seed=3)))
    return {
        "noise": rng.randn(2, T).astype(np.float32) * 0.1,
        "speech": np.asarray(batch["chunk"], np.float32),
        "zeros": np.zeros((2, T), np.float32),
        "near_silence": (rng.randn(2, T) * 1e-7).astype(np.float32),
        "short": rng.randn(1, 1600).astype(np.float32) * 0.1,
    }


FNS = {"mfcc": ("kaldi_mfcc", {}),
       "mfcc_d0": ("kaldi_mfcc", {"der_order": 0, "num_ceps": 20}),
       "plp": ("kaldi_plp", {}),
       "plp_d2": ("kaldi_plp", {"der_order": 2, "lpc_order": 12})}


@pytest.mark.parametrize("signal", sorted(_signals()))
@pytest.mark.parametrize("fn", sorted(FNS))
def test_kaldi_target_matches_jax(signal, fn):
    name, kw = FNS[fn]
    x = _signals()[signal]
    want = np.asarray(getattr(jax_kaldi, name)(jnp.asarray(x), **kw))
    got = getattr(kaldi_feats, name)(torch.from_numpy(x), **kw).numpy()
    assert got.shape == want.shape
    assert got.shape[:2] == (x.shape[0], x.shape[1] // 160)
    assert np.isfinite(want).all()
    assert rel_err(got, want) <= REL, rel_err(got, want)


@pytest.mark.parametrize("freq", [150, 440, 1234, 3000])
def test_kaldi_targets_of_tones(freq):
    """MFCC within 1e-4 of max|y|; PLP, ill-conditioned on a pure tone, no
    further from the float64 evaluation of the pipeline than twice JAX."""
    x = (np.sin(2 * np.pi * freq * np.arange(T) / 16000)[None]
         * 0.3).astype(np.float32)
    for name in ("kaldi_mfcc", "kaldi_plp"):
        want = np.asarray(getattr(jax_kaldi, name)(jnp.asarray(x)))
        fn = getattr(kaldi_feats, name)
        got = fn(torch.from_numpy(x)).numpy()
        if name == "kaldi_mfcc":
            assert rel_err(got, want) <= REL, (name, rel_err(got, want))
            continue
        exact = fn(torch.from_numpy(x).double()).numpy()
        port, jax_own = rel_err(got, exact), rel_err(want, exact)
        assert port <= max(2 * jax_own, REL), (port, jax_own)


def test_reflect_pad_matches_numpy():
    """Pads longer than the signal reflect again, as numpy's and JAX's
    'reflect' do; a one-sample signal repeats."""
    rng = np.random.RandomState(1)
    for t in (1, 2, 3, 7, 400, 401):
        x = rng.randn(2, t).astype(np.float32)
        for left, right in ((120, 400), (0, 3), (5, 0), (1000, 1)):
            want = np.pad(x, ((0, 0), (left, right)), mode="reflect")
            got = kaldi_feats.reflect_pad(torch.from_numpy(x), left, right)
            np.testing.assert_array_equal(got.numpy(), want)
    x = rng.randn(1, 7).astype(np.float32)
    np.testing.assert_array_equal(
        kaldi_feats.reflect_pad(torch.from_numpy(x), 120, 400).numpy(),
        np.asarray(jnp.pad(jnp.asarray(x), ((0, 0), (120, 400)),
                           mode="reflect")))


def test_kaldi_constants_equal_jax():
    np.testing.assert_array_equal(kaldi_feats.povey_window(400),
                                  jax_kaldi._povey_window(400))
    for n in (13, 20):
        np.testing.assert_array_equal(kaldi_feats.lifter(n, 22.0),
                                      jax_kaldi._lifter(n, 22.0))


@pytest.mark.parametrize("name", ["kaldimfcc", "kaldiplp"])
def test_kaldi_targets_match_golden_fixture(name):
    """The frozen outputs of tests/fixtures/features_golden.npz, at the
    golden test's tolerance; no JAX involved."""
    data = np.load(GOLDEN)
    fn = {"kaldimfcc": kaldi_feats.kaldi_mfcc,
          "kaldiplp": kaldi_feats.kaldi_plp}[name]
    got = fn(torch.from_numpy(data["input"])).numpy()
    assert got.shape == data[name].shape
    np.testing.assert_allclose(got, data[name], atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("name,cfg,shape", [
    ("kaldimfcc", {"num_ceps": 13}, (1, 30, 39)),
    ("kaldiplp", {"num_ceps": 20, "der_order": 0}, (1, 30, 20)),
    ("kaldiplp", {"num_ceps": 20}, (1, 30, 20)),
    ("kaldimfcc", {"num_ceps": 20, "der_order": 1}, (1, 30, 40)),
])
def test_kaldi_dispatch_and_dims_match_jax(name, cfg, shape):
    """A kaldimfcc worker gets the Kaldi MFCC (not the plain one, whose key
    is a substring of its name); the dims are JAX's, including kaldiplp's
    default der_order 2 in the dim where the features default to 0."""
    x = np.random.RandomState(2).randn(1, 4800).astype(np.float32) * 0.1
    fn = features.feature_fn_for_worker(name, cfg)
    got = fn(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_features.feature_fn_for_worker(name, cfg)(
        jnp.asarray(x)))
    assert got.shape == want.shape == shape
    assert rel_err(got, want) <= REL
    plain = features.feature_fn_for_worker("mfcc", cfg)(torch.from_numpy(x))
    assert plain.shape != got.shape or not torch.allclose(
        plain, torch.from_numpy(got))
    for c in (cfg, None):
        assert features.feature_dim_for_worker(name, c) == \
            jax_features.feature_dim_for_worker(name, c)


def test_kaldi_stats_and_prepare_match_jax():
    """compute_stats and make_prepare_fn build the ZNorm statistics and
    the ZNorm'd targets of the Kaldi workers as JAX does."""
    meta, jmeta = parse_workers_cfg(WORKERS), jax_parse_workers(WORKERS)
    want = jax_pipeline.compute_stats(JaxBatcher(2, 4800, seed=9), jmeta,
                                      max_batches=2)
    got = pipeline.compute_stats(JaxBatcher(2, 4800, seed=9), meta,
                                 max_batches=2, device="cpu")
    assert set(got) == set(want) >= {"kaldimfcc", "kaldiplp", "mfcc"}
    for k in ("kaldimfcc", "kaldiplp"):
        for m in ("mean", "std"):
            assert got[k][m].shape == (features.feature_dim_for_worker(
                k, WORKERS["regr"][1 + (k == "kaldiplp")]["transform"]),)
            assert rel_err(got[k][m], want[k][m]) <= REL, (k, m)
    raw = next(iter(JaxBatcher(2, 4800, seed=4)))
    prep = jax.jit(jax_pipeline.make_prepare_fn(jmeta, stats=want))(
        {k: jnp.asarray(v) for k, v in raw.items()}, jax.random.PRNGKey(0))
    mine = pipeline.make_prepare_fn(meta, stats=want)(
        {k: torch.from_numpy(v) for k, v in raw.items()})
    for k in ("kaldimfcc", "kaldiplp"):
        assert rel_err(mine[k].numpy(), np.asarray(prep[k])) <= REL, k


def test_kaldi_heads_step_matches_jax(tmp_path):
    """One narrow PASE+ step with the mfcc, kaldimfcc and kaldiplp heads
    and mi, from JAX's initial weights on one batch: every loss within
    1e-5 of JAX's."""
    jtr = JaxTrainer(SMALL_FE, WORKERS, _cfg(tmp_path / "jax"),
                     mesh=get_mesh(devices=jax.devices()[:1]))
    state = _init_state(jtr)
    raw = next(iter(JaxBatcher(2, 4800, seed=3)))
    flat = {f"params/{k}": v for k, v in _np_tree(state.params).items()}
    flat.update({f"batch_stats/{k}": v
                 for k, v in _np_tree(state.batch_stats).items()})
    _, losses = jtr._make_train_step()(
        state, {k: jnp.asarray(v) for k, v in raw.items()})
    tr = Trainer(SMALL_FE, WORKERS, _cfg(tmp_path / "port"), device="cpu")
    load_model_variables(tr.model, flat)
    got = tr.train_step(raw)
    assert set(tr.ordered_names) == {"mi", "mfcc", "kaldimfcc", "kaldiplp"}
    for name in tr.ordered_names + ["total"]:
        g, w = float(got[name]), float(losses[name])
        assert np.isfinite(g) and abs(g - w) <= 1e-5 * abs(w), (name, g, w)
