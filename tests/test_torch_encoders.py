"""The port's alternative encoders (pase_tpu_torch.encoders) against the
JAX package's (pase_tpu.encoders) on the CPU, on the same weights (carried
by the weight bridge) and the same seeded numpy inputs: TDNN (its three
methods), TDNNFe (no context layer, qrnn, lstm, gru), ASPP (eval, and
train with dropout off on both sides), ASPPResEncoder (concat levels, the
all-False fallback, rnn_pool / rnn_add), ResBlock1D, ResnetEncoder (its
40-sample hop), a TDNN + workers+ train step against the JAX Trainer's,
the bridge both ways, a TDNN export served on the CPU and the TDNN
recipe's CLI flags.

Float32 on both sides: JAX at 'highest' matmul precision
(tests/conftest.py), torch on the CPU (TF32 does not arise there).

Bounds (float32 sums in different orders):
  * forwards: max|y_torch - y_jax| <= 1e-5 x max|y_jax|;
  * gradients of sum(y * r) and of a train step: 1e-4 x max|g| of each
    leaf (a bias that feeds a BatchNorm has gradient 0: both sides below
    1e-5 of the encoder's largest gradient, as tests/test_torch_train.py
    holds them);
  * a train step's per-worker losses: 1e-5 relative;
  * BatchNorm running statistics after a train-mode forward: 1e-5 of
    their largest;
  * the weight bridge: exact; an exported artifact against the module:
    2e-5.

Every case is narrow (the TDNN trunk's widths are fixed at 512 / 1500 in
both packages) and ASPP runs at T <= 3200.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen
import optax
from flax.core import unfreeze
from flax.traverse_util import flatten_dict

from pase_tpu import encoders as jax_encoders
from pase_tpu import frontend as jax_frontend
from pase_tpu_torch import encoders, frontend, serving, streaming
from pase_tpu_torch.checkpoint import (load_model_variables,
                                       model_state_dict_to_variables,
                                       save_variables_npz,
                                       state_dict_to_variables,
                                       variables_to_state_dict)
from pase_tpu_torch.trainer import Trainer
from test_torch_train import ADAM_B1, _cfg, _fresh, _init_state, _np_tree
from test_torch_train import small_workers
from torch_port_common import flat_variables, rel_err
from torch_port_common import port_test_guard  # noqa: F401

FWD_REL = 1e-5
GRAD_REL = 1e-4
LOSS_REL = 1e-5
STATS_REL = 1e-5
SERVE_TOL = 2e-5

TDNN_FE = {"name": "tdnn", "emb_dim": 16, "fmaps": 8, "kwidth": 161}
ASPP_RES = {"name": "asppRes", "sinc_out": 4, "hidden_dim": 8,
            "sinc_kernel": 33, "kernel_sizes": [5, 5, 5, 5],
            "fmaps": [4, 4, 4, 4]}
RESNET = {"name": "Resnet50", "sinc_out": 4, "hidden_dim": 8,
          "sinc_kernel": 33, "stage_fmaps": [8, 8, 16, 16],
          "stage_blocks": [1, 2, 1, 1]}


def _no_jax_dropout(rate, deterministic=False):
    """flax.linen.Dropout replaced by the identity (the port's rate is 0)."""
    return lambda h: h


def _randomized(variables, seed):
    """Every BatchNorm's running stats and affine params and every PReLU
    slope drawn at random (their init values, 0 and 1, hide mistakes)."""
    flat = flatten_dict(unfreeze(variables))
    rng = np.random.RandomState(seed)
    for k, arr in flat.items():
        shape = np.shape(arr)
        if k[0] == "batch_stats" and k[-1] == "mean":
            new = rng.randn(*shape) * 0.1
        elif k[0] == "batch_stats" and k[-1] == "var":
            new = rng.uniform(0.5, 1.5, shape)
        elif k[-1] == "weight" and k[-2] == "act":
            new = rng.uniform(0.0, 0.3, shape)
        elif k[-1] == "weight":
            new = rng.uniform(0.5, 1.5, shape)
        elif k[-1] == "bias" and len(shape) == 1:
            new = rng.randn(*shape) * 0.1
        else:
            continue
        flat[k] = jnp.asarray(new.astype(np.float32))
    from flax.traverse_util import unflatten_dict
    return unflatten_dict(flat)


def _pair(jax_module, port_module, x, seed=0):
    """JAX variables (randomized) of ``jax_module`` at input x, and the
    port's module loaded with them through the bridge."""
    v = jax.jit(jax_module.init, static_argnames="train")(
        jax.random.PRNGKey(seed), jnp.asarray(x), train=False)
    v = _randomized(v, seed + 1)
    sd = variables_to_state_dict(flat_variables(v))
    port_module.load_state_dict(dict(port_module.state_dict(), **sd),
                                strict=True)
    return v


def _eval_pair(jax_module, port_module, x, v):
    want = np.asarray(jax.jit(jax_module.apply, static_argnames="train")(
        v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port_module.eval()(torch.from_numpy(x)).numpy()
    return got, want


def _ntc(x):
    return np.ascontiguousarray(np.transpose(x, (0, 2, 1)))


def _train_pair(jax_module, port_module, x, v, seed=5, nct=False):
    """A train-mode forward and the gradients of sum(y * r) on both
    sides: (y, y_jax, grads, grads_jax, stats, stats_jax) with the grads
    and the updated running statistics as JAX flat variables. ``nct``:
    the port's module runs on [B, C, T] (x, y and r are NTC)."""
    params = v["params"]
    stats = v.get("batch_stats", {})

    def run(p, xin):
        y, upd = jax_module.apply({"params": p, "batch_stats": stats}, xin,
                                  train=True, mutable=["batch_stats"])
        return y, upd

    y_jax, upd = jax.jit(run)(params, jnp.asarray(x))
    r = np.random.RandomState(seed).randn(*y_jax.shape).astype(np.float32)
    g_jax = jax.jit(jax.grad(
        lambda p: jnp.sum(run(p, jnp.asarray(x))[0] * r)))(params)
    port_module.train()
    if nct:
        y = port_module(torch.from_numpy(_ntc(x))).transpose(1, 2)
    else:
        y = port_module(torch.from_numpy(x))
    (y * torch.from_numpy(r)).sum().backward()
    grads = state_dict_to_variables(
        {k: p.grad for k, p in port_module.named_parameters()})
    want_g = {f"params/{k}": np.asarray(g) for k, g in
              flatten_dict(unfreeze(g_jax), sep="/").items()}
    got_stats = {k: t for k, t in state_dict_to_variables(
        port_module.state_dict()).items() if k.startswith("batch_stats/")}
    want_stats = {f"batch_stats/{k}": np.asarray(a) for k, a in flatten_dict(
        unfreeze(upd["batch_stats"]), sep="/").items()}
    return (y.detach().numpy(), np.asarray(y_jax), grads, want_g, got_stats,
            want_stats)


def _assert_grads(got, want, cancelled=()):
    """Per leaf within GRAD_REL of its largest; ``cancelled`` leaves (a
    bias before a BatchNorm) hold rounding noise only."""
    assert set(got) == set(want)
    top = max(np.abs(g).max() for g in want.values())
    for k, g in want.items():
        if k in cancelled:
            assert np.abs(g).max() <= 1e-5 * top, k
            assert np.abs(got[k]).max() <= 1e-5 * top, k
            continue
        err = np.abs(got[k] - g).max()
        assert err <= GRAD_REL * np.abs(g).max(), (k, err, np.abs(g).max())


def _assert_stats(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= STATS_REL * max(
            np.abs(w).max(), 1.0), k


# ---------------------------------------------------------------------------
# StatisticalPooling and TDNN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frames", [1, 2, 7])
def test_statistical_pooling_matches_jax(frames):
    """Mean and unbiased std over time; one frame gives std 0 (not NaN)."""
    x = np.random.RandomState(frames).randn(3, frames, 5).astype(np.float32)
    want = np.asarray(jax_encoders.StatisticalPooling().apply(
        {}, jnp.asarray(x)))
    got = encoders.StatisticalPooling()(torch.from_numpy(_ntc(x))).numpy()
    assert got.shape == (3, 10, 1) and want.shape == (3, 1, 10)
    assert np.isfinite(got).all()
    assert rel_err(_ntc(got), want) <= FWD_REL
    if frames == 1:
        assert np.all(got[:, 5:] == 0)


@pytest.mark.parametrize("method", ["unpooled", "xvector", "cls"])
def test_tdnn_matches_jax(method):
    """Eval forward, and a train-mode forward with its gradients and
    running statistics. cls ends in a log-softmax over the outputs.
    Batch 4: the segment layers' BatchNorm normalizes B values a channel,
    and at B = 2 two close values make JAX's one-pass variance and
    torch's two-pass one differ by more than rounding."""
    x = np.random.RandomState(2).randn(4, 12, 6).astype(np.float32)
    jm = jax_encoders.TDNN(num_outputs=3, method=method)
    pm = encoders.TDNN(6, num_outputs=3, method=method)
    v = _pair(jm, pm, x)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = _ntc(pm.eval()(torch.from_numpy(_ntc(x))).numpy())
    width = {"unpooled": 1500, "xvector": 512, "cls": 3}[method]
    assert got.shape == want.shape == (
        (4, 12, width) if method == "unpooled" else (4, 1, width))
    assert rel_err(got, want) <= FWD_REL
    if method == "cls":
        np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, rtol=1e-5)
    y, y_jax, g, g_jax, st, st_jax = _train_pair(jm, pm, x, v, nct=True)
    assert rel_err(y, y_jax) <= FWD_REL
    # biases that feed a BatchNorm: the trunk's convs, and in cls both
    # segment layers
    cancelled = {f"params/conv_{i}/bias" for i in range(5)}
    if method == "cls":
        cancelled |= {"params/seg_0/bias", "params/seg_1/bias"}
    _assert_grads(g, g_jax, cancelled)
    _assert_stats(st, st_jax)


# ---------------------------------------------------------------------------
# TDNNFe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rnn", [None, "qrnn", "lstm", "gru"])
def test_tdnnfe_matches_jax(rnn):
    """The sinc FeBlock, the unpooled TDNN, the context layer (none, the
    QRNN of emb_dim, a BiRNN of emb_dim // 2 each way) and W, in eval;
    T // 160 frames."""
    cfg = dict(TDNN_FE, rnn_pool=rnn is not None, rnn_type=rnn or "qrnn")
    jm = jax_frontend.build_frontend_module(cfg)
    pm = frontend.build_frontend_module(cfg)
    x = (np.random.RandomState(3).randn(2, 3200) * 0.1).astype(np.float32)
    v = _pair(jm, pm, x)
    got, want = _eval_pair(jm, pm, x, v)
    assert got.shape == want.shape == (2, 20, 16)
    assert pm.output_dim == jm.output_dim == 16 and pm.hop == 160
    assert rel_err(got, want) <= FWD_REL, rel_err(got, want)


def test_tdnnfe_unknown_rnn_type_raises():
    cfg = dict(TDNN_FE, rnn_pool=True, rnn_type="elman")
    with pytest.raises(TypeError, match="Unrecognized rnn type"):
        frontend.build_frontend_module(cfg)
    jm = jax_frontend.build_frontend_module(cfg)
    with pytest.raises(TypeError, match="Unrecognized rnn type"):
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 1600)))


# ---------------------------------------------------------------------------
# ASPP
# ---------------------------------------------------------------------------


def test_aspp_eval_matches_jax():
    x = np.random.RandomState(4).randn(2, 50, 6).astype(np.float32)
    jm = jax_encoders.ASPP(emb_dim=8, fmaps=4)
    pm = encoders.ASPP(6, 8, fmaps=4)
    v = _pair(jm, pm, x)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = _ntc(pm.eval()(torch.from_numpy(_ntc(x))).numpy())
    assert got.shape == want.shape == (2, 50, 8)
    assert rel_err(got, want) <= FWD_REL


def test_aspp_train_matches_jax(monkeypatch):
    """Train mode with dropout off on both sides (flax.linen.Dropout the
    identity, the port's rate 0): the output, the gradients and the
    running statistics (the global branch's BatchNorm on [B, C, 1]
    included)."""
    monkeypatch.setattr(flax.linen, "Dropout", _no_jax_dropout)
    x = np.random.RandomState(5).randn(3, 40, 6).astype(np.float32)
    jm = jax_encoders.ASPP(emb_dim=8, fmaps=4)
    pm = encoders.ASPP(6, 8, fmaps=4)
    pm.dropout = 0.0
    v = _pair(jm, pm, x)
    y, y_jax, g, g_jax, st, st_jax = _train_pair(jm, pm, x, v, nct=True)
    assert rel_err(y, y_jax) <= FWD_REL
    _assert_grads(g, g_jax)
    _assert_stats(st, st_jax)


def test_aspp_dropout_masks_come_from_the_generator():
    """Rate 0.5 in train mode only: kept values doubled, the masks drawn
    from the generator set on the encoder (the same seed, the same
    masks; another seed, others)."""
    enc = encoders.ASPPResEncoder(**{k: v for k, v in ASPP_RES.items()
                                     if k != "name"}).train()
    x = torch.from_numpy((np.random.RandomState(6).randn(2, 1600) * 0.1)
                         .astype(np.float32))
    gen = torch.Generator()
    enc.dropout_generator = gen
    assert all(m.dropout_generator is gen for m in enc.modules()
               if isinstance(m, encoders.ASPP))

    def run(seed):
        gen.manual_seed(seed)
        with torch.no_grad():
            return enc(x)

    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1))
    aspp = encoders.ASPP(6, 8, fmaps=4).train()
    h = torch.from_numpy(np.random.RandomState(7).randn(3, 6, 40)
                         .astype(np.float32))
    assert aspp.dropout == 0.5
    with torch.no_grad():
        dropped = aspp(h)
        aspp.dropout = 0.0
        kept = aspp(h)
    zero = dropped == 0
    assert 0.3 < zero[kept != 0].float().mean().item() < 0.7
    torch.testing.assert_close(dropped[~zero], 2 * kept[~zero])
    with torch.no_grad():
        enc.eval()
        assert torch.equal(enc(x), enc(x))


@pytest.mark.parametrize("concat,rnn_pool,rnn_add", [
    ((False, False, False, True), False, False),
    ((True, False, True, True), False, False),
    ((False, True, False, True), False, False),
    ((False, False, False, False), False, False),
    ((False, False, True, True), True, False),
    ((False, False, False, True), True, True)])
def test_aspp_res_encoder_matches_jax(concat, rnn_pool, rnn_add):
    """The concat levels mean-pooled onto the last level's frames (an
    all-False concat: the trunk's output), the QRNN of the output's width
    with and without rnn_add; output_dim = hidden_dim x max(#concat, 1)."""
    cfg = dict(ASPP_RES, concat=list(concat), rnn_pool=rnn_pool,
               rnn_add=rnn_add)
    jm = jax_frontend.build_frontend_module(cfg)
    pm = frontend.build_frontend_module(cfg)
    x = (np.random.RandomState(7).randn(2, 3200) * 0.1).astype(np.float32)
    v = _pair(jm, pm, x)
    got, want = _eval_pair(jm, pm, x, v)
    width = 8 * max(sum(concat), 1)
    assert got.shape == want.shape == (2, 20, width)
    assert pm.output_dim == jm.output_dim == width and pm.hop == 160
    assert rel_err(got, want) <= FWD_REL, rel_err(got, want)


def test_aspp_res_encoder_train_matches_jax(monkeypatch):
    """A train-mode forward of the encoder (two blocks, both concat
    levels, the QRNN with rnn_add), dropout off on both sides: output,
    gradients of every leaf and the running statistics. Two blocks: in
    train mode every BatchNorm normalizes by its batch statistics, JAX's
    variance taken in one pass and torch's in two; at four blocks the
    last levels hold 40 and 20 frames and the global branches B values
    a channel, and the two variances' rounding compounds to 2e-5 of
    max|y| through the eight ASPPs."""
    monkeypatch.setattr(flax.linen, "Dropout", _no_jax_dropout)
    cfg = dict(ASPP_RES, kernel_sizes=[5, 5], strides=[10, 4],
               fmaps=[4, 4], concat=[True, True], rnn_pool=True,
               rnn_add=True)
    jm = jax_frontend.build_frontend_module(cfg)
    pm = frontend.build_frontend_module(cfg)
    for m in pm.modules():
        if isinstance(m, encoders.ASPP):
            m.dropout = 0.0
    x = (np.random.RandomState(8).randn(4, 3200) * 0.1).astype(np.float32)
    v = _pair(jm, pm, x)
    y, y_jax, g, g_jax, st, st_jax = _train_pair(jm, pm, x, v)
    assert rel_err(y, y_jax) <= FWD_REL
    _assert_grads(g, g_jax)
    _assert_stats(st, st_jax)


# ---------------------------------------------------------------------------
# ResBlock1D and ResnetEncoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cin,fmaps,stride", [(6, 6, 1), (6, 8, 1),
                                              (6, 6, 2), (6, 8, 2)])
def test_resblock1d_matches_jax(cin, fmaps, stride):
    """Without a projection (same width, stride 1) and with one (the width
    or the stride changes): eval, and train mode with gradients and
    running statistics."""
    x = np.random.RandomState(cin + fmaps + stride).randn(2, 31, cin).astype(
        np.float32)
    jm = jax_encoders.ResBlock1D(fmaps, stride)
    pm = encoders.ResBlock1D(cin, fmaps, stride)
    assert (pm.proj is None) == (cin == fmaps and stride == 1)
    v = _pair(jm, pm, x)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = _ntc(pm.eval()(torch.from_numpy(_ntc(x))).numpy())
    assert got.shape == want.shape == (2, -(-31 // stride), fmaps)
    assert rel_err(got, want) <= FWD_REL
    y, y_jax, g, g_jax, st, st_jax = _train_pair(jm, pm, x, v, nct=True)
    assert rel_err(y, y_jax) <= FWD_REL
    _assert_grads(g, g_jax)
    _assert_stats(st, st_jax)


def test_resnet_encoder_matches_jax():
    jm = jax_frontend.build_frontend_module(RESNET)
    pm = frontend.build_frontend_module(RESNET)
    x = (np.random.RandomState(9).randn(2, 1600) * 0.1).astype(np.float32)
    v = _pair(jm, pm, x)
    got, want = _eval_pair(jm, pm, x, v)
    assert got.shape == want.shape == (2, 40, 8)
    assert rel_err(got, want) <= FWD_REL, rel_err(got, want)


def test_resnet_hop_is_40(tmp_path):
    """At its default strides the ResNet emits a frame every 5 x 2 x 2 x 2
    = 40 samples (200 for 8000, as the JAX module): ``hop`` says 40, and
    an export of it records hop 40 and serves all 200 frames."""
    cfg = dict(RESNET, stage_blocks=[1, 1, 1, 1])
    jm = jax_frontend.build_frontend_module(cfg)
    enc = frontend.wf_builder(cfg, device="cpu")
    x = (np.random.RandomState(10).randn(1, 8000) * 0.1).astype(np.float32)
    v = _pair(jm, enc.module, x)
    got, want = _eval_pair(jm, enc.module, x, v)
    assert got.shape == want.shape == (1, 200, 8)
    assert enc.module.hop == 40
    out = serving.export_encoder(enc, str(tmp_path / "art"),
                                 chunk_sizes=(8000,))
    with open(tmp_path / "art" / "meta.json") as f:
        meta = json.load(f)
    assert meta["hop"] == 40 and meta["halo"] is None
    served = serving.ServingEncoder(out).encode(x[0])
    assert served.shape == (8, 200)
    assert np.abs(served - got[0].T).max() <= SERVE_TOL


# ---------------------------------------------------------------------------
# dispatch and the weight bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,fields", [
    ("tdnn", encoders.TDNNFE_FIELDS), ("asppRes", encoders.ASPP_RES_FIELDS),
    ("Resnet50", encoders.RESNET_FIELDS)])
def test_dispatch_fields_are_the_jax_modules(name, fields):
    """The port's copy of each family's fields is the JAX module's; keys
    that are not fields are dropped, as in JAX."""
    jm = jax_frontend.build_frontend_module({"name": name})
    want = set(type(jm).__dataclass_fields__) - {"parent", "name"}
    assert set(fields) == want
    pm = frontend.build_frontend_module({"name": name, "kwidths": [3],
                                         "norm_out": True})
    assert type(pm).__name__ == type(jm).__name__


def test_unknown_frontend_name_raises():
    with pytest.raises(TypeError, match="Unrecognized frontend type"):
        frontend.build_frontend_module({"name": "wav2vec"})


@pytest.mark.parametrize("cfg", [dict(TDNN_FE, rnn_pool=True),
                                 dict(TDNN_FE, rnn_pool=True,
                                      rnn_type="lstm"),
                                 dict(ASPP_RES, rnn_pool=True), RESNET],
                         ids=["tdnn", "tdnn_lstm", "asppRes", "Resnet50"])
def test_bridge_round_trips_exactly(cfg, tmp_path):
    """JAX variables -> the port's state dict -> JAX variables, bit for
    bit and key for key (conv_0, bn_4, aspp_blocks_0, block1_aspp,
    layer1_0 unmangled); a JAX-written npz loads into wf_builder and the
    port's npz into JAX, with equal arrays."""
    from pase_tpu.checkpoint import load_variables, save_variables
    jm = jax_frontend.build_frontend_module(cfg)
    pm = frontend.build_frontend_module(cfg)
    v = _pair(jm, pm, np.zeros((1, 3200), np.float32), seed=11)
    flat = flat_variables(v)
    sd = variables_to_state_dict(flat)
    back = state_dict_to_variables(sd)
    assert set(back) == set(flat)
    for k, a in flat.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)
    keys = set(pm.state_dict())
    name = cfg["name"]
    expect = {"tdnn": ["tdnn.conv_0.weight", "tdnn.bn_4.running_var",
                       "feblock.conv.low_hz_", "W.weight"],
              "asppRes": ["aspp_blocks_0.block1_aspp.aspp2.atrous_conv"
                          ".weight", "aspp_blocks_3.block2_bn.bias",
                          "rnn.layers.0.linear.weight"],
              "Resnet50": ["layer1_0.conv1.weight", "layer4_0.proj.weight",
                           "head.bias", "sinc.band_hz_"]}[name]
    assert set(expect) <= keys
    npz = str(tmp_path / "jax.npz")
    save_variables(npz, v, step=0)
    enc = frontend.wf_builder(cfg, device="cpu", seed=3).load_pretrained(npz)
    got = state_dict_to_variables(enc.module.state_dict())
    for k, a in flat.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    port_npz = save_variables_npz(str(tmp_path / "port.npz"),
                                  enc.module.state_dict())
    loaded, _ = load_variables(port_npz)
    for k, a in flatten_dict(unfreeze(loaded), sep="/").items():
        np.testing.assert_array_equal(np.asarray(a), flat[k], err_msg=k)


# ---------------------------------------------------------------------------
# a TDNN + workers+ train step against the JAX Trainer's
# ---------------------------------------------------------------------------

TDNN_STEP_FE = dict(TDNN_FE, kwidth=641, rnn_pool=True)
# the TDNN convs' biases feed a BatchNorm
TDNN_CANCELLED = {f"frontend/tdnn/conv_{i}/bias" for i in range(5)}


@pytest.fixture(scope="module")
def tdnn_setup(tmp_path_factory):
    from pase_tpu.data.dataset import SyntheticChunkBatcher as JaxBatcher
    from pase_tpu.parallel.mesh import get_mesh
    from pase_tpu.trainer import Trainer as JaxTrainer
    tmp = tmp_path_factory.mktemp("tdnn_step")
    jtr = JaxTrainer(TDNN_STEP_FE, small_workers(), _cfg(tmp / "jax"),
                     mesh=get_mesh(devices=jax.devices()[:1]))
    state = _init_state(jtr)
    batch = next(iter(JaxBatcher(2, 4800, seed=3)))
    return jtr, state, batch, tmp


def test_tdnn_train_step_matches_jax(tdnn_setup):
    """One base-policy step of TDNNFe (TDNN.cfg's kwidth and QRNN, narrow
    emb_dim) with the narrow workers+ bank: per-worker losses within
    1e-5, gradients (from the JAX step's Adam first moment) within 1e-4
    a leaf."""
    jtr, state, batch, tmp = tdnn_setup
    new_state, jlosses = jtr._make_train_step()(
        _fresh(state), {k: jnp.asarray(v) for k, v in batch.items()})
    grads = {}
    for group in new_state.opt_state.inner_states.values():
        for k, mu in flatten_dict(unfreeze(group.inner_state[0].mu),
                                  sep="/").items():
            if not isinstance(mu, optax.MaskedNode):
                grads[k] = np.asarray(mu, np.float64) / (1.0 - ADAM_B1)
    tr = Trainer(TDNN_STEP_FE, small_workers(), _cfg(tmp / "port"),
                 device="cpu")
    flat = {f"params/{k}": v for k, v in _np_tree(state.params).items()}
    flat.update({f"batch_stats/{k}": v
                 for k, v in _np_tree(state.batch_stats).items()})
    load_model_variables(tr.model, flat)
    losses = tr.train_step(batch)
    for name in tr.ordered_names + ["total"]:
        got, want = float(losses[name]), float(jlosses[name])
        assert abs(got - want) <= LOSS_REL * abs(want), (name, got, want)
    port = model_state_dict_to_variables(
        {k: p.grad for k, p in tr.model.named_parameters()})
    assert {k[len("params/"):] for k in port} == set(grads)
    assert "frontend/rnn/layers_0_linear/kernel" in grads
    fe_max = max(np.abs(g).max() for k, g in grads.items()
                 if k.startswith("frontend/"))
    for k, g in grads.items():
        got = port["params/" + k]
        if k in TDNN_CANCELLED:
            assert np.abs(g).max() <= 1e-5 * fe_max, k
            assert np.abs(got).max() <= 1e-5 * fe_max, k
            continue
        err = np.abs(got - g).max()
        assert err <= GRAD_REL * np.abs(g).max(), (k, err, np.abs(g).max())


def test_resnet_step_fails_as_in_jax(tmp_path):
    """A Resnet50 cfg gives 4 frames per 160-sample target frame: the JAX
    train step refuses at the first regression loss (the cchunk decoder's
    19200 samples against the 4800 of the chunk), and so does the port."""
    from pase_tpu.data.dataset import SyntheticChunkBatcher as JaxBatcher
    from pase_tpu.parallel.mesh import get_mesh
    from pase_tpu.trainer import Trainer as JaxTrainer
    cfg = dict(RESNET, stage_blocks=[1, 1, 1, 1])
    jtr = JaxTrainer(cfg, small_workers(), _cfg(tmp_path / "jax"),
                     mesh=get_mesh(devices=jax.devices()[:1]))
    state = _init_state(jtr)
    batch = next(iter(JaxBatcher(2, 4800, seed=3)))
    with pytest.raises(TypeError, match=r"\(2, 19200, 1\), \(2, 4800, 1\)"):
        jtr._make_train_step()(state, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    tr = Trainer(cfg, small_workers(), _cfg(tmp_path / "port"),
                 device="cpu")
    with pytest.raises(RuntimeError, match="19200.*4800"):
        tr.train_step(batch)


# ---------------------------------------------------------------------------
# serving, streaming and the CLIs
# ---------------------------------------------------------------------------


def test_tdnn_export_on_the_cpu(tmp_path):
    """A TDNN artifact traced on the CPU: halo null, hop 160; a request
    shorter than the largest bucket is routed there (zero-padded, frames
    trimmed), and its frames equal the module's forward of that padded
    bucket; a batch of two as one call equals each alone."""
    enc = frontend.wf_builder(dict(TDNN_FE, rnn_pool=True), device="cpu")
    out = serving.export_encoder(enc, str(tmp_path / "art"),
                                 chunk_sizes=(1600, 3200))
    srv = serving.ServingEncoder(out)
    assert srv.meta["halo"] is None and srv.hop == 160
    rng = np.random.RandomState(12)
    wavs = [(rng.randn(n) * 0.1).astype(np.float32) for n in (2500, 1000)]
    for wav in wavs:
        got = srv.encode(wav)
        padded = np.pad(wav, (0, 3200 - len(wav)))[None, None]
        want = enc(padded)[0, :, :len(wav) // 160].numpy()
        assert got.shape == want.shape == (16, len(wav) // 160)
        assert np.abs(got - want).max() <= SERVE_TOL
    both = srv.encode_batch(wavs)
    for one, wav in zip(both, wavs):
        np.testing.assert_allclose(one, srv.encode(wav), rtol=0,
                                   atol=SERVE_TOL)


@pytest.mark.parametrize("cfg", [dict(TDNN_FE, rnn_pool=True), ASPP_RES,
                                 RESNET], ids=["tdnn", "asppRes",
                                               "Resnet50"])
def test_new_families_refuse_the_stream(cfg, tmp_path):
    """StreamingEncoder and the streaming export raise the JAX stream's
    TypeError for a family other than WaveFe."""
    from pase_tpu.streaming import StreamingEncoder as JaxStream
    jenc = jax_frontend.wf_builder(cfg)
    with pytest.raises(TypeError, match="supports the WaveFe trunk"):
        JaxStream(jenc)
    enc = frontend.wf_builder(cfg, device="cpu")
    with pytest.raises(TypeError, match="supports the WaveFe trunk"):
        streaming.StreamingEncoder(enc)
    with pytest.raises(TypeError, match="supports the WaveFe trunk"):
        serving.export_streaming_encoder(enc, str(tmp_path / "s"),
                                         chunk=1600)


def test_tdnn_cfg_takes_the_clis(tmp_path):
    """cfg/frontend/TDNN.cfg through forward-chunk, export + serve-encode
    (halo null; frames within 2e-5 of forward-chunk at the largest
    bucket) and the probes' extractor, on the CPU."""
    from pase_tpu_torch import util_scripts
    from pase_tpu_torch.data.io import write_wav
    from pase_tpu_torch.probes.extract import FeatureExtractor
    cfg = "cfg/frontend/TDNN.cfg"
    wav = (np.random.RandomState(13).randn(4000) * 0.1).astype(np.float32)
    write_wav(str(tmp_path / "a.wav"), wav)
    enc = frontend.wf_builder(cfg, device="cpu", seed=2)
    npz = save_variables_npz(str(tmp_path / "fe.npz"),
                             enc.module.state_dict())
    util_scripts.main(["forward-chunk", "--device", "cpu", "--fe_cfg", cfg,
                       "--fe_ckpt", npz, "--in_wav", str(tmp_path / "a.wav"),
                       "--out_file", str(tmp_path / "fc.npy"),
                       "--chunk_size", "3200"])
    util_scripts.main(["export", "--device", "cpu", "--fe_cfg", cfg,
                       "--fe_ckpt", npz, "--out_dir", str(tmp_path / "art"),
                       "--chunk_sizes", "1600,3200"])
    util_scripts.main(["serve-encode", "--export_dir", str(tmp_path / "art"),
                       "--in_wav", str(tmp_path / "a.wav"), "--out_file",
                       str(tmp_path / "se.npy")])
    fc, se = np.load(tmp_path / "fc.npy"), np.load(tmp_path / "se.npy")
    assert fc.shape == se.shape == (256, 25)
    assert np.abs(fc - se).max() <= SERVE_TOL
    with open(tmp_path / "art" / "meta.json") as f:
        assert json.load(f)["halo"] is None
    ex = FeatureExtractor(cfg, npz, device="cpu")
    feats = ex.extract(wav)
    assert feats.shape == (25, 256) and np.isfinite(feats).all()


def test_tdnn_recipe_cli_runs_steps(tmp_path, monkeypatch):
    """recipes/run_pase_tdnn.sh's flags with --synthetic pass every check
    of the port's CLI and build TDNN.cfg with workers+ (bf16, poly lr,
    random scale); at a tiny batch and chunk its trainer's steps log
    finite losses and launch through the QRNN of TDNN.cfg. The recipe's
    distortion cfg is dropped: its corpora are not in the repository."""
    import math
    import chip_smoke
    from pase_tpu_torch import train as port_cli
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    argv = chip_smoke.recipe_argv("recipes/run_pase_tdnn.sh")
    assert argv[argv.index("--fe_cfg") + 1] == "cfg/frontend/TDNN.cfg"
    opts = port_cli.build_argparser().parse_args(
        argv + ["--synthetic", "--device", "cpu"])
    port_cli.compat_notes(opts)
    port_cli.check_ported(opts)
    monkeypatch.setattr(Trainer, "train_", lambda self, *a, **k: None)
    flags = [f for f in argv if f not in ("--dtrans_cfg",
                                          "cfg/distortions/pase+.cfg")]
    tr = port_cli.main(flags + [
        "--synthetic", "--device", "cpu", "--batch_size", "2",
        "--chunk_size", "3360", "--save_path", str(tmp_path / "run")])
    assert isinstance(tr.model.frontend, encoders.TDNNFe)
    assert tr.cfg["compute_dtype"] == "bfloat16" and tr.cfg["fast_loader"]
    assert tr.cfg["lr_mode"] == "poly" and tr.cfg["random_scale"]
    it = iter(SyntheticChunkBatcher(2, 3360, seed=4))
    for _ in range(2):
        losses = tr.train_step(next(it))
        assert all(math.isfinite(float(v)) for v in losses.values())
    ev = tr.eval_step(next(it))
    assert math.isfinite(float(ev["total"]))
