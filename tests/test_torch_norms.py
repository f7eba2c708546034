"""The weight reparameterizations and the other norms of the port
(pase_tpu_torch/nn.py: SNConv1D, WNConv1D, LayerNorm1d, InstanceNorm1d,
and the blocks and the encoder that take them) against the JAX package,
on the CPU.

Inputs are seeded numpy arrays; the JAX modules' variables (with random
norm affines and PReLU slopes, whose inits hide mistakes) are carried to
the port through the weight bridge. Bounds (float32 sums in other
orders): a layer's forward within 1e-6 of max|y|, a block's and the
encoder's within 1e-5; gradients of the SN / WN convs within 1e-5 of the
gradient's largest value; SN's u within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from pase_tpu import nn as jnn
from pase_tpu.frontend import WaveFe as JaxWaveFe
from pase_tpu_torch import nn as pnn
from pase_tpu_torch.checkpoint import (state_dict_to_variables,
                                       variables_to_state_dict)
from pase_tpu_torch.frontend import WaveFe, build_wavefe
from pase_tpu_torch.streaming import StreamingEncoder
from torch_port_common import port_test_guard  # noqa: F401

LAYER_REL = 1e-6
BLOCK_REL = 1e-5
GRAD_REL = 1e-5
U_ATOL = 1e-6
NORM_TYPES = ["snorm", "wnorm", "bsnorm", "lnorm", "inorm", "affinorm"]
# a narrow encoder without the sinc layer (it takes no reparameterization)
NARROW_FE = {"sincnet": False, "kwidths": [31, 20, 11, 11],
             "strides": [1, 10, 2, 2], "fmaps": [8, 8, 16, 16],
             "emb_dim": 8, "rnn_pool": True, "rnn_dim": 16,
             "denseskips": True}


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _randomize(variables, seed):
    """Random norm affines, PReLU slopes, WN gains and BatchNorm stats."""
    flat = flatten_dict(unfreeze(variables))
    rng = np.random.RandomState(seed)
    for k, v in flat.items():
        shape = np.shape(v)
        if k[-1] == "mean":
            flat[k] = rng.randn(*shape) * 0.1
        elif k[-1] in ("var", "g"):
            flat[k] = rng.uniform(0.5, 1.5, shape)
        elif len(k) > 1 and k[-2].startswith(("norm", "act")):
            flat[k] = (rng.uniform(0.0, 0.3, shape) if k[-2].startswith("act")
                       else rng.uniform(0.5, 1.5, shape) if k[-1] == "weight"
                       else rng.randn(*shape) * 0.1)
        else:
            continue
        flat[k] = jnp.asarray(np.asarray(flat[k], np.float32))
    return unflatten_dict(flat)


def _flat(variables):
    return {k: np.asarray(v) for k, v in
            flatten_dict(unfreeze(variables), sep="/").items()}


def _load(module, variables):
    """JAX variables into a port module (strict; only BatchNorm's
    num_batches_tracked keeps the module's value)."""
    sd = variables_to_state_dict(_flat(variables))
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
    module.load_state_dict(sd, strict=True)
    return module


def _nct(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


def _ntc(t):
    return t.detach().numpy().transpose(0, 2, 1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _jax_apply(module, variables, x, train):
    """(y, new batch_stats or None) of a module that takes ``train``."""
    if train and "batch_stats" in variables:
        y, ups = module.apply(variables, x, train=True,
                              mutable=["batch_stats"])
        return y, ups["batch_stats"]
    return module.apply(variables, x, train=train), None


@pytest.mark.parametrize("kind", ["lnorm", "inorm", "affinorm"])
def test_norm_layers_match_jax(kind):
    x = _x((3, 37, 6)) * 2.0 + 0.5
    jmod = jnn.build_norm(kind, 6)
    v = jmod.init(jax.random.PRNGKey(0), x)
    rng = np.random.RandomState(3)
    v = jax.tree.map(lambda a: jnp.asarray(
        rng.uniform(0.5, 1.5, a.shape).astype(np.float32)), v)
    want = np.asarray(jmod.apply(v, x))
    port = _load(pnn.build_norm(kind, 6), v)
    got = _ntc(port(_nct(x)))
    assert _rel(got, want) <= LAYER_REL
    assert sum(p.numel() for p in port.parameters()) == (
        0 if kind == "inorm" else 12)


def test_split_and_build_norm_match_jax():
    for t in [None, "bnorm"] + NORM_TYPES:
        assert pnn.split_norm(t) == jnn.split_norm(t), t
    for t in ("snorm", "wnorm", "bsnorm", "gnorm"):
        with pytest.raises(TypeError):
            jnn.build_norm(t, 4)
        with pytest.raises(TypeError):
            pnn.build_norm(t, 4)


def _conv_pair(cls, stride=2, dilation=1):
    x = _x((2, 41, 5))
    jmod = getattr(jnn, cls)(7, 4, stride, dilation)
    v = jmod.init(jax.random.PRNGKey(1), x)
    v = _randomize(v, 4)
    port = getattr(pnn, cls)(5, 7, 4, stride, dilation)
    return x, jmod, v, _load(port, v)


def test_wn_conv_forward_and_gradients_match_jax():
    x, jmod, v, port = _conv_pair("WNConv1D")
    r = _x((2, 19, 7), seed=9)

    def jloss(params, xin):
        return jnp.sum(jmod.apply({"params": params}, xin) * r)

    want_y = np.asarray(jmod.apply(v, x))
    gp, gx = jax.grad(jloss, argnums=(0, 1))(v["params"], x)
    xt = _nct(x).requires_grad_()
    y = port(xt)
    assert _rel(_ntc(y), want_y) <= LAYER_REL
    torch.sum(y * _nct(r)).backward()
    assert _rel(_ntc(xt.grad), gx) <= GRAD_REL
    got = state_dict_to_variables(
        {k: p.grad for k, p in port.named_parameters()})
    for k, g in _flat({"params": gp}).items():
        assert _rel(got[k], g) <= GRAD_REL, k


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_sn_conv_forward_u_and_gradients_match_jax(train):
    x, jmod, v, port = _conv_pair("SNConv1D", stride=1, dilation=2)
    r = _x((2, 35, 7), seed=8)
    u0 = np.asarray(v["batch_stats"]["u"])

    def jloss(params, xin):
        y, ups = jmod.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, xin,
                            train=train, mutable=["batch_stats"])
        return jnp.sum(y * r), (y, ups["batch_stats"]["u"])

    (_, (want_y, want_u)), (gp, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(v["params"], x)
    port.train(train)
    xt = _nct(x).requires_grad_()
    y = port(xt)
    assert _rel(_ntc(y), want_y) <= LAYER_REL
    u = port.u.numpy()
    assert np.abs(u - np.asarray(want_u)).max() <= U_ATOL
    if train:
        assert np.abs(u - u0).max() > 1e-3        # one power iteration
    else:
        np.testing.assert_array_equal(u, u0)      # eval: u stays
    torch.sum(y * _nct(r)).backward()
    assert _rel(_ntc(xt.grad), gx) <= GRAD_REL
    got = state_dict_to_variables(
        {k: p.grad for k, p in port.named_parameters()})
    for k, g in _flat({"params": gp}).items():
        assert _rel(got[k], g) <= GRAD_REL, k


def test_sn_conv_bounds_the_gain():
    """After enough training calls u converges and the normalized
    weight's largest singular value is 1 (the JAX test's property)."""
    conv = pnn.SNConv1D(4, 8, 3, generator=torch.Generator().manual_seed(0))
    x = torch.zeros(1, 4, 16)
    for _ in range(30):
        conv(x)
    w = conv.normalized_weight().detach().reshape(8, -1)
    assert torch.linalg.matrix_norm(w, ord=2).item() == pytest.approx(
        1.0, abs=0.02)


def _block_pair(kind, norm_type, act=None):
    if kind == "FeBlock":
        x = _x((2, 64, 6)) + 0.3
        jmod = jnn.FeBlock(fmaps=8, kwidth=5, stride=2, norm_type=norm_type,
                           act=act)
        port = pnn.FeBlock(6, 8, 5, 2, norm_type=norm_type, act=act)
    elif kind == "FeResBlock":
        x = _x((2, 48, 6)) + 0.3
        jmod = jnn.FeResBlock(fmaps=8, kwidth=3, downsample=2,
                              norm_type=norm_type)
        port = pnn.FeResBlock(6, 8, 3, downsample=2, norm_type=norm_type)
    else:
        x = _x((2, 12, 6)) + 0.3
        jmod = jnn.GDeconv1DBlock(fmaps=4, kwidth=8, stride=4,
                                  norm_type=norm_type, act=act)
        port = pnn.GDeconv1DBlock(6, 4, 8, 4, norm_type=norm_type, act=act)
    v = _randomize(jmod.init(jax.random.PRNGKey(2), x, train=False), 5)
    return x, jmod, v, _load(port, v)


def _check_block(x, jmod, v, port):
    for train in (True, False):
        want, new = _jax_apply(jmod, v, x, train)
        port.train(train)
        got = port(_nct(x))
        assert _rel(_ntc(got), want) <= BLOCK_REL, train
        if new is not None:
            state = state_dict_to_variables(
                {k: b for k, b in port.state_dict().items()
                 if not k.endswith("num_batches_tracked")})
            for k, w in _flat({"batch_stats": new}).items():
                assert np.abs(state[k] - w).max() <= U_ATOL, k
            _load(port, v)          # the eval pass from the same state


@pytest.mark.parametrize("norm_type", NORM_TYPES)
@pytest.mark.parametrize("kind", ["FeBlock", "FeResBlock"])
def test_blocks_take_every_norm_type(kind, norm_type):
    _check_block(*_block_pair(kind, norm_type))


@pytest.mark.parametrize("norm_type", [None, "bnorm", "lnorm", "inorm",
                                       "affinorm"])
def test_deconv_block_takes_build_norms_types(norm_type):
    _check_block(*_block_pair("GDeconv1DBlock", norm_type))


@pytest.mark.parametrize("norm_type", ["snorm", "wnorm", "bsnorm"])
def test_deconv_block_refuses_reparameterizations_as_jax(norm_type):
    x = _x((1, 8, 6))
    with pytest.raises(TypeError):
        jnn.GDeconv1DBlock(fmaps=4, kwidth=8, stride=4,
                           norm_type=norm_type).init(jax.random.PRNGKey(0),
                                                     x)
    with pytest.raises(TypeError):
        pnn.GDeconv1DBlock(6, 4, 8, 4, norm_type=norm_type)


@pytest.mark.parametrize("kind", ["FeBlock", "GDeconv1DBlock"])
def test_glu_blocks_match_jax(kind):
    _check_block(*_block_pair(kind, "bnorm", act="glu"))


def test_glu_resblock_and_sinc_reparameterization_refused_as_jax():
    with pytest.raises(TypeError):
        jnn.FeResBlock(fmaps=4, kwidth=3, act="glu").init(
            jax.random.PRNGKey(0), _x((1, 8, 4)))
    with pytest.raises(TypeError, match="glu"):
        pnn.FeResBlock(4, 4, 3, act="glu")
    with pytest.raises(TypeError):
        jnn.FeBlock(fmaps=4, kwidth=31, stride=1, norm_type="snorm",
                    sincnet=True).init(jax.random.PRNGKey(0),
                                       _x((1, 64, 1)))
    with pytest.raises(TypeError, match="sinc"):
        pnn.FeBlock(1, 4, 31, 1, norm_type="snorm", sincnet=True)


def _encoder_pair(cfg, t=3200):
    x = _x((2, t), seed=6)
    jmod = JaxWaveFe(**{k: (tuple(v) if isinstance(v, list) else v)
                        for k, v in cfg.items()})
    v = _randomize(jax.jit(jmod.init, static_argnames="train")(
        jax.random.PRNGKey(3), x, train=False), 7)
    port = _load(build_wavefe(cfg), v)
    return x, jmod, v, port


@pytest.mark.parametrize("norm_type,norm_out", [
    ("snorm", True), ("wnorm", True), ("bsnorm", True), ("lnorm", True),
    ("inorm", False), ("bnorm", True)])
def test_encoder_norm_types_and_norm_out_match_jax(norm_type, norm_out):
    """A narrow encoder of each norm type; norm_out is affine-free
    BatchNorm with bnorm and InstanceNorm with every other type."""
    cfg = dict(NARROW_FE, norm_type=norm_type, norm_out=norm_out)
    x, jmod, v, port = _encoder_pair(cfg)
    want_cls = pnn.BatchNorm1d if norm_type == "bnorm" else \
        pnn.InstanceNorm1d
    assert isinstance(port.norm_out, want_cls) or not norm_out
    for train in (True, False):
        want, _ = _jax_apply(jmod, v, x, train)
        port.train(train)
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
        assert _rel(got, want) <= BLOCK_REL, train
        _load(port, v)


@pytest.mark.parametrize("norm_type", ["snorm", "wnorm", "lnorm"])
def test_stream_matches_offline_for_norm_types(norm_type):
    """The stream of a narrow encoder in eval mode, in two chunkings, is
    within the streaming contract (rtol 1e-3 / atol 2e-4) of the offline
    encoder, which is within 1e-5 of JAX's; SN's u does not move."""
    cfg = dict(NARROW_FE, norm_type=norm_type)
    x, jmod, v, port = _encoder_pair(cfg, t=4000)
    port.eval()
    with torch.no_grad():
        off = port(torch.from_numpy(x)).transpose(1, 2).numpy()
    want = np.asarray(jmod.apply(v, x, train=False)).transpose(0, 2, 1)
    assert _rel(off, want) <= BLOCK_REL
    u0 = {k: b.clone() for k, b in port.state_dict().items()
          if k.endswith(".u")}
    assert bool(u0) == (norm_type == "snorm")
    for piece in (1000, 730):
        stream = StreamingEncoder(port)
        outs = [stream.push(x[:, i:i + piece])
                for i in range(0, x.shape[1], piece)] + [stream.flush()]
        got = torch.cat([o for o in outs if o is not None], dim=2).numpy()
        assert got.shape == off.shape
        np.testing.assert_allclose(got, off, rtol=1e-3, atol=2e-4)
    for k, u in u0.items():
        assert torch.equal(port.state_dict()[k], u), k


@pytest.mark.parametrize("cfg", [
    dict(NARROW_FE, norm_type="inorm"),
    dict(NARROW_FE, norm_type="affinorm", norm_out=True),
    dict(NARROW_FE, norm_type="lnorm", norm_out=True),
    dict(NARROW_FE, norm_type="affinorm", resblocks=True,
         kwidths=[31, 21, 11, 11])],
    ids=["inorm", "affinorm", "lnorm_norm_out", "affinorm_resblocks"])
def test_stream_refuses_instance_norm(cfg):
    """What JAX's stream refuses: inorm FeBlocks, norm_out's InstanceNorm
    (affinorm and lnorm with norm_out), InstanceNorm inside resblocks.
    affinorm FeBlocks without norm_out stream (tests/
    test_torch_parallel.py holds them to JAX's stream)."""
    enc = build_wavefe(cfg).eval()
    with pytest.raises(NotImplementedError, match="InstanceNorm"):
        StreamingEncoder(enc)


def test_bridge_round_trip_of_v_g_u():
    """v [K, Cin, F] <-> [F, Cin, K], g and bias as they are, u under
    batch_stats; both ways exact, strict."""
    cfg = dict(NARROW_FE, norm_type="wnorm")
    _, _, v, port = _encoder_pair(cfg)
    flat = _flat(v)
    assert flat["params/blocks_1/conv/v"].shape == (20, 8, 8)
    assert port.blocks[1].conv.v.shape == (8, 8, 20)
    back = state_dict_to_variables(port.state_dict())
    assert set(back) == set(flat)
    for k, a in flat.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)
    cfg = dict(NARROW_FE, norm_type="bsnorm")
    _, _, v, port = _encoder_pair(cfg)
    flat = _flat(v)
    assert "batch_stats/blocks_2/conv/u" in flat
    back = state_dict_to_variables(
        {k: b for k, b in port.state_dict().items()
         if not k.endswith("num_batches_tracked")})
    assert set(back) == set(flat)
    for k, a in flat.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)


def test_reparameterized_convs_use_no_torch_hooks():
    """The port writes SN and WN itself: no torch.nn.utils spectral_norm
    / weight_norm hook or parametrization is attached."""
    enc = WaveFe(sincnet=False, kwidths=(5, 5), strides=(2, 2),
                 fmaps=(4, 4), emb_dim=4, norm_type="snorm")
    for m in enc.modules():
        assert not hasattr(m, "parametrizations")
        assert not any("spectral" in type(h).__name__.lower()
                       for h in m._forward_pre_hooks.values())
