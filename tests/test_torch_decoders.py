"""The port's spectrum decoders (pase_tpu_torch/decoders.py) against
pase_tpu.decoders with the JAX weights carried across by
checkpoint.variables_to_state_dict, on the CPU.

Bounds: SpectrogramDecoder and GConv1DBlock within 1e-5 of max|y|
(float32 convolutions summed in other orders); SpectrumLM's frames and
final state within 1e-4 absolute over 20 closed-loop steps (the rounding
of each step feeds the next).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from pase_tpu import decoders as J
from pase_tpu_torch import decoders as P
from pase_tpu_torch.checkpoint import (state_dict_to_variables,
                                       variables_to_state_dict)
from torch_port_common import port_test_guard  # noqa: F401

REL = 1e-5
LM_ATOL = 1e-4


def _flat(v):
    return {k: np.array(a) for k, a in
            flatten_dict(unfreeze(v), sep="/").items()}


def _randomize(flat, seed=7):
    """Non-trivial PReLU slopes, norm affines and running stats (their
    inits, 0 / 1 / 0 / 1, hide mistakes)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, a in flat.items():
        if k.endswith("act/weight"):
            a = rng.uniform(0.0, 0.3, a.shape)
        elif k.endswith("norm/weight") or k.endswith("/var"):
            a = rng.uniform(0.5, 1.5, a.shape)
        elif k.endswith("norm/bias") or k.endswith("/mean"):
            a = rng.randn(*a.shape) * 0.1
        out[k] = np.asarray(a, np.float32)
    return out


def _tree(flat):
    return unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                          sep="/")


def _load(module, flat):
    sd = variables_to_state_dict(flat)
    missing = set(module.state_dict()) - set(sd)
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    module.load_state_dict(dict(module.state_dict(), **sd), strict=True)
    back = state_dict_to_variables(module.state_dict())
    assert set(back) == set(flat)
    for k, a in flat.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)
    return module


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


SPEC_CASES = {
    "stride1": dict(strides=(1, 1, 1), kwidths=(3, 3, 3), fmaps=(16, 16, 8),
                    norm_type=None),
    "upsample_bnorm": dict(strides=(1, 4, 2), kwidths=(3, 8, 5),
                           fmaps=(16, 12, 8), norm_type="bnorm"),
    "even_kw_affinorm": dict(strides=(1, 2), kwidths=(4, 4), fmaps=(8, 8),
                             norm_type="affinorm"),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_spectrogram_decoder_matches_jax(case, train):
    """[B, T, 24] -> [B, T x prod(strides), nfft // 2 + 1] within 1e-5 of
    max|y|, in eval mode and in train mode (BatchNorm on the batch's
    statistics), from the JAX weights."""
    kw = SPEC_CASES[case]
    jm = J.SpectrogramDecoder(nfft=64, **kw)
    x = np.random.RandomState(1).randn(3, 25, 24).astype(np.float32)
    flat = _randomize(_flat(jm.init(jax.random.PRNGKey(0), x)))
    v = _tree(flat)
    if train:
        want, _ = jm.apply(v, x, train=True, mutable=["batch_stats"])
    else:
        want = jm.apply(v, x, train=False)
    want = np.asarray(want)
    pm = _load(P.SpectrogramDecoder(24, nfft=64, **kw), flat).train(train)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    up = int(np.prod(kw["strides"]))
    assert got.shape == want.shape == (3, 25 * up, 33)
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("act", ["prelu", "glu", "relu", "tanh"])
def test_gconv_block_matches_jax(act):
    """GConv1DBlock: reflect pad, conv, the activation BEFORE the norm
    (bnorm, eval), stride 2 with an odd kwidth (the strided pad)."""
    jm = J.GConv1DBlock(8, 5, stride=2, norm_type="bnorm", act=act)
    x = np.random.RandomState(2).randn(2, 30, 6).astype(np.float32)
    flat = _randomize(_flat(jm.init(jax.random.PRNGKey(1), x)))
    want = np.asarray(jm.apply(_tree(flat), x))
    pm = _load(P.GConv1DBlock(6, 8, 5, stride=2, norm_type="bnorm", act=act),
               flat).eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    assert got.shape == want.shape == (2, 15, 8)
    assert _rel(got.numpy(), want) <= REL


def _lm_pair(rnn_type, size=16, layers=2, out=10, seed=0):
    jm = J.SpectrumLM(size, layers, out, rnn_type=rnn_type)
    x = np.random.RandomState(seed).randn(4, out).astype(np.float32)
    v = jm.init({"params": jax.random.PRNGKey(seed),
                 "sample": jax.random.PRNGKey(seed + 1)}, x, 3)
    pm = _load(P.SpectrumLM(size, layers, out, rnn_type=rnn_type),
               _flat(v))
    return jm, v, pm, x


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
def test_spectrum_lm_matches_jax(rnn_type):
    """2 layers, 20 closed-loop steps, teacher-forcing frames at steps 6
    ([B, F]) and 13 ([B, 1, F]), the random initial state passed in: the
    frames and the final state (flax's carries) within 1e-4."""
    jm, v, pm, x = _lm_pair(rnn_type)
    state = jm.init_state(jax.random.PRNGKey(9), 4)
    rng = np.random.RandomState(3)
    cps = {6: rng.randn(4, 10).astype(np.float32),
           13: rng.randn(4, 1, 10).astype(np.float32)}
    want, wstate = jm.apply(v, x, 20, state=state,
                            dec_cps={k: jnp.asarray(a)
                                     for k, a in cps.items()})
    with torch.no_grad():
        got, gstate = pm(torch.from_numpy(x), 20, state=_to_torch(state),
                         dec_cps={k: torch.from_numpy(a)
                                  for k, a in cps.items()})
    assert got.shape == want.shape == (4, 20, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LM_ATOL)
    assert jax.tree.structure(wstate) == jax.tree.structure(
        jax.tree.map(lambda t: 0, gstate, is_leaf=torch.is_tensor))
    for g, w in zip(jax.tree.leaves(gstate, is_leaf=torch.is_tensor),
                    jax.tree.leaves(wstate)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=LM_ATOL)


@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
def test_spectrum_lm_is_closed_loop(rnn_type):
    """Step t's input is step t-1's output: 20 steps equal 10 steps and
    10 more seeded with the 10th frame from the 10th state; a forced
    frame changes that step and the ones after it, not the ones before."""
    _, _, pm, x = _lm_pair(rnn_type, seed=4)
    gen = torch.Generator().manual_seed(2)
    state = pm.init_state(4, gen)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        whole, _ = pm(xt, 20, state=state)
        first, mid = pm(xt, 10, state=state)
        second, _ = pm(first[:, -1], 10, state=mid)
        forced, _ = pm(xt, 20, state=state,
                       dec_cps={12: torch.zeros(4, 10)})
    assert torch.equal(torch.cat([first, second], 1), whole)
    assert torch.equal(forced[:, :12], whole[:, :12])
    assert not torch.allclose(forced[:, 12:], whole[:, 12:])


def test_spectrum_lm_state_draws_dropout_and_refusals():
    """The initial state from the generator passed in (the same seed the
    same state; LSTM: (c, h) per layer), the dropout between the layers
    from dropout_generator in train mode (none in eval; none without a
    generator raises), and JAX's refusals."""
    pm = P.SpectrumLM(8, 3, 5, dropout=0.5, rnn_type="LSTM")
    s1 = pm.init_state(2, torch.Generator().manual_seed(1))
    s2 = pm.init_state(2, torch.Generator().manual_seed(1))
    assert len(s1) == 3 and all(len(s) == 2 for s in s1)
    assert all(torch.equal(a, b) for x, y in zip(s1, s2)
               for a, b in zip(x, y))
    assert P.SpectrumLM(8, 2, 5, rnn_type="GRU").init_state(
        2, torch.Generator())[0].shape == (2, 8)
    x = torch.randn(2, 5)
    with torch.no_grad():
        ev = pm.eval()(x, 6, state=s1)[0]
        pm.train()
        with pytest.raises(ValueError, match="torch.Generator"):
            pm(x, 6, state=s1)
        gen = torch.Generator()
        pm.dropout_generator = gen
        runs = []
        for seed in (0, 0, 1):
            gen.manual_seed(seed)
            runs.append(pm(x, 6, state=s1)[0])
        assert torch.equal(runs[0], runs[1])
        assert not torch.equal(runs[0], runs[2])
        assert not torch.equal(runs[0], ev)
        with pytest.raises(ValueError, match="needs a torch.Generator"):
            pm.eval()(x, 3)
        a = pm(x, 3, generator=torch.Generator().manual_seed(4))[0]
        b = pm(x, 3, state=pm.init_state(
            2, torch.Generator().manual_seed(4)))[0]
        assert torch.equal(a, b)
        with pytest.raises(ValueError, match="features expected"):
            pm(torch.randn(2, 4), 3, state=s1)
    for bad in ("RNN", "lstm", "QRNN"):
        with pytest.raises(ValueError, match="rnn_type must be LSTM or GRU"):
            P.SpectrumLM(8, 1, 5, rnn_type=bad)
        with pytest.raises(ValueError, match="rnn_type must be LSTM or GRU"):
            J.SpectrumLM(8, 1, 5, rnn_type=bad).init(
                {"params": jax.random.PRNGKey(0),
                 "sample": jax.random.PRNGKey(0)}, jnp.zeros((2, 5)), 2)
