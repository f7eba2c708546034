"""The port's encoder (pase_tpu_torch.frontend) against the JAX WaveFe on
the same weights and the same numpy inputs, in eval mode.

The JAX side runs its Pallas QRNN kernel in interpret mode
(qrnn_impl='pallas', as tests/test_qrnn.py runs it) at 'highest' matmul
precision (tests/conftest.py); the torch side runs in float32 on the CPU,
where the QRNN wrapper takes its plain version.

Bound: max|y_torch - y_jax| / max|y_jax| <= 1e-4 (float32 convolutions
summed in different orders). Measured on an x86 CPU: 1.7e-7 for the
narrow config, 4.0e-7 for full-width PASE+."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.experimental.pallas.tpu as pltpu

from pase_tpu import frontend as jax_frontend
from pase_tpu.ops import pad as jax_pad
from pase_tpu.ops import sinc as jax_sinc
from pase_tpu_torch import frontend, wf_builder
from pase_tpu_torch.checkpoint import variables_to_state_dict
from pase_tpu_torch.nn import JAX_ACTIVATIONS, NamedActivation
from pase_tpu_torch.ops import pad, sinc
from torch_port_common import (NARROW_CFG, PASEP_CFG, flat_variables,
                               jax_variables, rel_err)
from torch_port_common import port_test_guard  # noqa: F401

REL_BOUND = 1e-4


def _port_and_jax(cfg, b, t, seed):
    jax_module = jax_frontend.build_wavefe(
        dict(jax_frontend.load_cfg(cfg), qrnn_impl="pallas"))
    x = (np.random.RandomState(seed).randn(b, t) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        variables = jax_variables(jax_module, t, seed=seed)
        y_jax = np.asarray(jax.jit(jax_module.apply, static_argnames="train")(
            variables, jnp.asarray(x), train=False))
    port = frontend.build_wavefe(cfg).eval()
    sd = variables_to_state_dict(flat_variables(variables))
    port.load_state_dict(dict(port.state_dict(), **sd), strict=True)
    with torch.no_grad():
        y = port(torch.from_numpy(x)).numpy()
    return y, y_jax


def test_wavefe_matches_jax_narrow():
    y, y_jax = _port_and_jax(NARROW_CFG, b=2, t=8000, seed=0)
    assert y.shape == y_jax.shape == (2, 200, 8)
    assert rel_err(y, y_jax) <= REL_BOUND, rel_err(y, y_jax)


def test_wavefe_matches_jax_pase_plus():
    y, y_jax = _port_and_jax(PASEP_CFG, b=1, t=8000, seed=1)
    assert y.shape == y_jax.shape == (1, 50, 256)
    assert rel_err(y, y_jax) <= REL_BOUND, rel_err(y, y_jax)


def test_encoder_contract_pase_plus():
    """(1,1,100000) -> (1,256,625) for PASE+, finite."""
    enc = wf_builder(PASEP_CFG, device="cpu", seed=0)
    x = np.random.RandomState(0).randn(1, 1, 100000).astype(np.float32)
    y = enc(x * 0.1)
    assert tuple(y.shape) == (1, 256, 625)
    assert torch.isfinite(y).all()


def test_encoder_is_seeded_and_refuses_train():
    a = wf_builder(NARROW_CFG, device="cpu", seed=3).module.state_dict()
    b = wf_builder(NARROW_CFG, device="cpu", seed=3).module.state_dict()
    c = wf_builder(NARROW_CFG, device="cpu", seed=4).module.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["W.weight"], c["W.weight"])
    enc = wf_builder(NARROW_CFG, device="cpu")
    with pytest.raises(ValueError):
        enc(np.zeros((1, 1, 800), np.float32), train=True)


# the options this test once held to NotImplementedError, now ported: the
# named activations of WaveFe's blocks, and the three encoder families at
# narrow widths (tests/test_torch_encoders.py holds each module)
FORMERLY_UNPORTED = [
    dict(NARROW_CFG, kwidths=[251, 21, 11, 11], resblocks=True,
         activation="relu"),
    {"name": "Resnet50", "sinc_out": 4, "hidden_dim": 8, "sinc_kernel": 33,
     "stage_fmaps": [8, 8, 16, 16], "stage_blocks": [1, 1, 1, 1]},
    dict(NARROW_CFG, activation="gelu"),
    {"name": "asppRes", "sinc_out": 4, "hidden_dim": 8, "sinc_kernel": 33,
     "fmaps": [4, 4, 4, 4], "concat": [False, True, False, True]},
    dict(NARROW_CFG, activation="ELU"),
    {"name": "tdnn", "emb_dim": 8, "fmaps": 8, "kwidth": 161,
     "rnn_pool": True}]


@pytest.mark.parametrize("cfg", FORMERLY_UNPORTED,
                         ids=["resblocks_relu", "Resnet50", "gelu",
                              "asppRes", "ELU", "tdnn"])
def test_formerly_unported_options_match_jax(cfg):
    """wf_builder builds each, and its forward matches the JAX module's
    within 1e-5 of max|y| on bridged weights (an activation name is
    looked up lower-cased, as JAX's getattr(jax.nn, act.lower()))."""
    jax_module = jax_frontend.build_frontend_module(cfg)
    x = (np.random.RandomState(3).randn(2, 3200) * 0.1).astype(np.float32)
    variables = jax_variables(jax_module, 3200, seed=3)
    y_jax = np.asarray(jax.jit(jax_module.apply, static_argnames="train")(
        variables, jnp.asarray(x), train=False))
    enc = wf_builder(cfg, device="cpu")
    sd = variables_to_state_dict(flat_variables(variables))
    enc.module.load_state_dict(dict(enc.module.state_dict(), **sd),
                               strict=True)
    y = enc(x).transpose(1, 2).numpy()
    assert y.shape == y_jax.shape
    assert rel_err(y, y_jax) <= 1e-5, rel_err(y, y_jax)


# what still raises, in the port as in JAX: a name that is no jax.nn
# activation (unknown, 'PReLU' looked up as jax.nn.prelu, one that is not
# an activation), an unknown encoder family or rnn type, and affinorm
# (InstanceNorm over the whole utterance) in the stream
@pytest.mark.parametrize("extra", [
    {"activation": "swishy"}, {"activation": "PReLU"},
    {"activation": "one_hot"}, {"name": "wav2vec"},
    {"name": "tdnn", "rnn_pool": True, "rnn_type": "elman"},
    {"norm_type": "affinorm", "stream": True}])
def test_unported_options_raise(extra):
    from pase_tpu_torch.streaming import StreamingEncoder
    cfg = dict(NARROW_CFG, **{k: v for k, v in extra.items()
                              if k != "stream"})
    if "activation" in extra:
        with pytest.raises(AttributeError, match="jax.nn has no"):
            wf_builder(cfg, device="cpu")
        if extra["activation"] != "one_hot":
            with pytest.raises(AttributeError):
                jax_frontend.build_frontend_module(cfg).init(
                    jax.random.PRNGKey(0), jnp.zeros((1, 800)))
    elif "stream" in extra:
        with pytest.raises(NotImplementedError, match="InstanceNorm"):
            StreamingEncoder(wf_builder(cfg, device="cpu"))
    else:
        with pytest.raises(TypeError, match="Unrecognized"):
            wf_builder(cfg, device="cpu")


def _jax_activation_input(seed):
    """[B, T, C] values around every kink of the jax.nn activations (0,
    +-1, +-3, 6) and beyond."""
    x = np.random.RandomState(seed).randn(2, 9, 6) * 3
    x.flat[:8] = [0.0, 1.0, -1.0, 3.0, -3.0, 6.0, 25.0, -25.0]
    return x.astype(np.float32)


@pytest.mark.parametrize("name", sorted(JAX_ACTIVATIONS))
def test_named_activation_matches_jax(name):
    """Each jax.nn activation a block can take by name against jax.nn's
    own on the CPU (gelu the tanh approximation, leaky_relu 0.01, elu /
    celu alpha 1, softmax / log_softmax / standardize over the channels),
    forward within 1e-6 (relative, 1e-6 absolute) and the gradient of
    sum(y * r) within 1e-5; the name is taken lower-cased."""
    x = _jax_activation_input(len(name))
    r = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    fn = getattr(jax.nn, name)
    want = np.asarray(fn(jnp.asarray(x)))
    g_want = np.asarray(jax.grad(lambda v: jnp.sum(fn(v) * r))(
        jnp.asarray(x)))
    act = NamedActivation(name.upper())
    xt = torch.from_numpy(x).transpose(1, 2).requires_grad_()
    y = act(xt)
    (y * torch.from_numpy(r).transpose(1, 2)).sum().backward()
    got = y.detach().transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                               equal_nan=True)
    finite = np.isfinite(g_want)
    np.testing.assert_allclose(xt.grad.transpose(1, 2).numpy()[finite],
                               g_want[finite], rtol=1e-5, atol=1e-5)


def test_every_jax_nn_name_is_mapped_or_refused():
    """Every public jax.nn name is either a named activation of the port
    or refused by it (it changes the width, reduces, or is no function of
    one array)."""
    public = {n for n in dir(jax.nn) if not n.startswith("_")}
    refused = public - set(JAX_ACTIVATIONS)
    assert set(JAX_ACTIVATIONS) <= public
    assert "glu" in refused and "one_hot" in refused
    for n in refused:
        with pytest.raises(AttributeError):
            NamedActivation(n)


@pytest.mark.parametrize("act", ["relu", "gelu", "Tanh"])
def test_deconv_block_named_activation_matches_jax(act):
    """GDeconv1DBlock with a named activation against the JAX block."""
    from pase_tpu.nn import GDeconv1DBlock as JaxBlock
    from pase_tpu_torch.nn import GDeconv1DBlock
    x = np.random.RandomState(2).randn(2, 7, 5).astype(np.float32)
    jm = JaxBlock(fmaps=4, kwidth=5, stride=2, norm_type="bnorm", act=act)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    pm = GDeconv1DBlock(5, 4, 5, 2, norm_type="bnorm", act=act).eval()
    sd = variables_to_state_dict(flat_variables(v))
    pm.load_state_dict(dict(pm.state_dict(), **sd), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    assert got.shape == want.shape
    assert rel_err(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("mode", [None, "avg_norm", "avg_concat",
                                  "avg_norm_concat"])
def test_select_output_matches_jax(mode):
    h = np.random.RandomState(0).randn(2, 4, 10).astype(np.float32)
    ref = np.asarray(jax_frontend.select_output(jnp.asarray(h), mode))
    got = frontend.select_output(torch.from_numpy(h), mode).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("kwidth,stride,sinc_layer,want", [
    (251, 1, True, (125, 125)), (20, 10, False, (9, 10)),
    (11, 2, False, (4, 5)), (11, 1, False, (5, 5))])
def test_pase_plus_pads_match_jax(kwidth, stride, sinc_layer, want):
    fn, jfn = ((pad.sinc_same_pad, jax_pad.sinc_same_pad) if sinc_layer
               else (pad.feblock_pad, jax_pad.feblock_pad))
    assert fn(kwidth, stride) == jfn(kwidth, stride) == want
    x = np.random.RandomState(kwidth).randn(2, 300, 3).astype(np.float32)
    ref = np.asarray(jax_pad.pad_1d(jnp.asarray(x), want, "reflect"))
    got = pad.pad_1d(torch.from_numpy(x).transpose(1, 2), want, "reflect")
    np.testing.assert_array_equal(got.transpose(1, 2).numpy(), ref)


def test_sinc_filters_match_jax():
    low, band = sinc.mel_init_hz(64)
    jlow, jband = jax_sinc.mel_init_hz(64)
    np.testing.assert_array_equal(low, jlow)
    np.testing.assert_array_equal(band, jband)
    n_, window_ = sinc.sinc_time_axes(251)
    ref = np.asarray(jax_sinc.build_sinc_filters(
        jnp.asarray(low), jnp.asarray(band), jnp.asarray(n_),
        jnp.asarray(window_)))
    got = sinc.build_sinc_filters(*map(torch.from_numpy,
                                       (low, band, n_, window_))).numpy()
    assert got.shape == ref.shape == (64, 251)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
