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
from pase_tpu_torch.ops import pad, sinc
from torch_port_common import (NARROW_CFG, PASEP_CFG, flat_variables,
                               jax_variables, rel_err)

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


@pytest.mark.parametrize("extra", [
    {"resblocks": True}, {"vq_K": 64}, {"rnn_type": "lstm"},
    {"norm_type": "snorm"}, {"activation": "glu"}, {"name": "tdnn"}])
def test_unported_options_raise(extra):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        wf_builder(dict(NARROW_CFG, **extra), device="cpu")


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
