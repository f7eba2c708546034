"""The port's bf16 compute policy (pase_tpu_torch.precision) against the
JAX package's (pase_tpu.precision), cast site by cast site, on the CPU.

Each site runs the same inputs and weights through the JAX function under
``compute_dtype(jnp.bfloat16)`` and through the port's under
``compute_dtype(torch.bfloat16)``: the outputs must have the same type and
agree within 2^-8 of max|y| (one bf16 rounding of the sums, taken in
another order, and of the ops after them). One small bf16 train step is
held to the JAX bf16 step: per-worker losses within 2^-7 relative
(measured on the CPU: at most 2.3e-4, mi).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as flax_nn
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from pase_tpu import losses as jax_losses
from pase_tpu import nn as jnn
from pase_tpu.data import pipeline as jax_pipeline
from pase_tpu.model import parse_workers_cfg as jax_parse_workers
from pase_tpu.ops import features as jax_features
from pase_tpu.parallel.mesh import get_mesh
from pase_tpu.precision import compute_dtype as jax_compute_dtype
from pase_tpu.trainer import Trainer as JaxTrainer
from pase_tpu_torch import losses as port_losses
from pase_tpu_torch import nn as pnn
from pase_tpu_torch import precision
from pase_tpu_torch.checkpoint import (load_model_variables,
                                       variables_to_state_dict)
from pase_tpu_torch.data import pipeline
from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
from pase_tpu_torch.model import parse_workers_cfg
from pase_tpu_torch.ops import cuda_qrnn
from pase_tpu_torch.ops import features as port_features
from pase_tpu_torch.trainer import Trainer
from torch_port_common import flat_variables
from torch_port_common import port_test_guard  # noqa: F401

REL = 2.0 ** -8
STEP_REL = 2.0 ** -7
BF16 = torch.bfloat16


def _x(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _dtype_name(a):
    return str(a.dtype).replace("torch.", "")


def _check(got, want, rel=REL, layout="same"):
    """got (torch) vs want (JAX): the same type, within rel of max|want|.
    ``layout='nct'``: got is [B, C, T], want [B, T, C]."""
    assert _dtype_name(got) == np.dtype(want.dtype).name, (got.dtype,
                                                          want.dtype)
    g = got.detach().float().numpy()
    if layout == "nct":
        g = g.transpose(0, 2, 1)
    w = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(g - w).max() / np.abs(w).max()
    assert err <= rel, err
    return err


def _randomize(variables, seed=3):
    """Give BatchNorm stats and affine params and PReLU slopes random
    values (their inits hide mistakes)."""
    flat = flatten_dict(unfreeze(variables))
    rng = np.random.RandomState(seed)
    for k, v in flat.items():
        shape = np.shape(v)
        if k[-1] == "mean":
            new = rng.randn(*shape) * 0.1
        elif k[-1] == "var":
            new = rng.uniform(0.5, 1.5, shape)
        elif k[0] == "params" and k[-1] == "weight" and len(shape) == 1:
            new = rng.uniform(0.5, 1.5, shape) if "act" not in k[-2] \
                else rng.uniform(0.0, 0.3, shape)
        elif k[0] == "params" and k[-1] == "bias" and "norm" in "".join(k):
            new = rng.randn(*shape) * 0.1
        else:
            continue
        flat[k] = jnp.asarray(new.astype(np.float32))
    return unflatten_dict(flat)


def _jax_run(module, variables, *args, train=False, **kw):
    """module.apply under the JAX bf16 policy; (out, new batch_stats)."""
    with jax_compute_dtype(jnp.bfloat16):
        if train:
            out, ups = module.apply(variables, *args, train=True,
                                    mutable=["batch_stats"], **kw)
            return out, ups["batch_stats"]
        return module.apply(variables, *args, **kw), None


def _port_module(port, variables):
    port.load_state_dict({**port.state_dict(), **variables_to_state_dict(
        flat_variables(variables))}, strict=True)
    return port


def test_resolve_names_and_typos():
    assert precision.resolve(None) is None
    assert precision.resolve("float32") is None
    assert precision.resolve("bf16") is torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        precision.resolve("bfloat61")
    with pytest.raises(ValueError, match="compute_dtype"):
        Trainer({"kwidths": [11], "strides": [1], "fmaps": [4]},
                {"regr": [], "cls": []}, {"compute_dtype": "fp16"},
                device="cpu")


@pytest.mark.parametrize("bias", [True, False])
def test_conv1d_site(bias):
    """Conv1D: x cast to bf16, the conv's output bf16; the float32 bias
    promotes it to float32 (JAX type promotion)."""
    x = _x((2, 300, 8))
    jm = jnn.Conv1D(12, 5, stride=2, use_bias=bias)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want, _ = _jax_run(jm, v, jnp.asarray(x))
    port = _port_module(pnn.Conv1D(8, 12, 5, stride=2, bias=bias), v)
    with precision.compute_dtype(BF16):
        got = port(torch.from_numpy(x).transpose(1, 2))
    _check(got, want, layout="nct")
    assert got.dtype == (torch.float32 if bias else BF16)


def test_sincconv_site():
    x = _x((2, 1200, 1), scale=0.3)
    jm = jnn.SincConv(16, 65)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, _ = _jax_run(jm, v, jnp.asarray(x))
    port = _port_module(pnn.SincConv(16, 65), v)
    with precision.compute_dtype(BF16):
        got = port(torch.from_numpy(x).transpose(1, 2))
    _check(got, want, layout="nct")


@pytest.mark.parametrize("kind", ["sinc", "conv_f32_in", "conv_bf16_in"])
def test_feblock_site(kind):
    """FeBlock with its reflect pad: the sinc block (bf16 out, BatchNorm
    and PReLU in bf16), a strided conv block on a float32 and on a bf16
    input (the bias makes both float32). The running stats after the
    train-mode call within 1e-5 of JAX's."""
    if kind == "sinc":
        jm = jnn.FeBlock(8, 65, 1, sincnet=True)
        pm = pnn.FeBlock(1, 8, 65, 1, sincnet=True)
        x = _x((2, 800, 1), scale=0.3)
    else:
        jm = jnn.FeBlock(16, 11, 2)
        pm = pnn.FeBlock(8, 16, 11, 2)
        x = _x((2, 400, 8))
    xj = jnp.asarray(x)
    xt = torch.from_numpy(x).transpose(1, 2)
    if kind == "conv_bf16_in":
        xj, xt = xj.astype(jnp.bfloat16), xt.to(BF16)
    v = _randomize(jm.init(jax.random.PRNGKey(0), xj, train=False))
    pm = _port_module(pm, v)
    want, stats = _jax_run(jm, v, xj, train=True)
    pm.train()
    with precision.compute_dtype(BF16):
        got = pm(xt)
    _check(got, want, layout="nct")
    for k, w in flatten_dict(unfreeze(stats), sep="/").items():
        tk = {"mean": "running_mean", "var": "running_var"}[k.split("/")[-1]]
        err = np.abs(pm.norm.state_dict()[tk].numpy() - np.asarray(w)).max()
        assert err <= 1e-5, (k, err)
    pm.eval()
    want_eval, _ = _jax_run(jm, {"params": v["params"], "batch_stats": stats},
                            xj)
    with precision.compute_dtype(BF16):
        _check(pm(xt), want_eval, layout="nct")


@pytest.mark.parametrize("kind", ["proj_f32_in", "same_bf16_in",
                                  "proj_bf16_in"])
def test_feresblock_site(kind):
    """FeResBlock (downsample 2): conv1 and conv2 cast x to bf16, their
    biases make both float32, so norm1, the PReLUs and norm2 run in
    float32; the 1x1 resproj (bias) hands on float32; without it a bf16
    input's identity (the sinc block's output) is added to the float32
    path as bf16, which promotes. Train mode, then eval."""
    cin = 12 if kind.startswith("proj") else 16
    jm = jnn.FeResBlock(fmaps=16, kwidth=5, downsample=2, norm_type="bnorm")
    pm = pnn.FeResBlock(cin, 16, 5, downsample=2, norm_type="bnorm")
    x = _x((2, 300, cin))
    xj = jnp.asarray(x)
    xt = torch.from_numpy(x).transpose(1, 2)
    if kind.endswith("bf16_in"):
        xj, xt = xj.astype(jnp.bfloat16), xt.to(BF16)
    v = _randomize(jm.init(jax.random.PRNGKey(0), xj, train=False))
    pm = _port_module(pm, v)
    want, stats = _jax_run(jm, v, xj, train=True)
    pm.train()
    with precision.compute_dtype(BF16):
        got = pm(xt)
    _check(got, want, layout="nct")
    pm.eval()
    want_eval, _ = _jax_run(jm, {"params": v["params"], "batch_stats": stats},
                            xj)
    with precision.compute_dtype(BF16):
        _check(pm(xt), want_eval, layout="nct")


def test_vq_stays_float32():
    """The quantizer's distances, EMA update and gather stay float32
    under the bf16 policy (plain matmuls, no cast site), as in JAX: the
    port's output and EMA state under the policy equal its float32 run
    bit for bit, and JAX's under its policy within 1e-6."""
    x = _x((2, 40, 6))
    jm = jnn.VQEMA(32, 6)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    (_, want, _, _), stats = _jax_run(jm, v, jnp.asarray(x), train=True)
    runs = []
    for policy in (BF16, None):
        pm = _port_module(pnn.VQEMA(32, 6), v).train()
        with precision.compute_dtype(policy):
            runs.append((pm(torch.from_numpy(x)), pm.state_dict()))
    (got, sd), (ref, ref_sd) = runs
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    for k in sd:
        torch.testing.assert_close(sd[k], ref_sd[k], rtol=0, atol=0)
    _check(got, want, rel=1e-6)
    for k, w in flatten_dict(unfreeze(stats), sep="/").items():
        w = np.asarray(w)
        assert np.abs(sd[k].numpy() - w).max() <= 1e-6 * np.abs(w).max(), k


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_site(train):
    """BatchNorm1d on a bf16 x: float32 statistics in one pass, the
    normalization and affine in bf16; train and eval."""
    x = _x((3, 200, 6), scale=2.0) + 1.5
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    jm = jnn.BatchNorm1d(6)
    v = _randomize(jm.init(jax.random.PRNGKey(0), xj))
    want, stats = _jax_run(jm, v, xj, train=train)
    pm = _port_module(pnn.BatchNorm1d(6), v).train(train)
    with precision.compute_dtype(BF16):
        got = pm(torch.from_numpy(x).transpose(1, 2).to(BF16))
    _check(got, want, layout="nct")
    if train:
        for leaf, tk in (("mean", "running_mean"), ("var", "running_var")):
            err = np.abs(getattr(pm, tk).numpy()
                         - np.asarray(stats[leaf])).max()
            assert err <= 1e-5, (leaf, err)


def test_prelu_site():
    x = _x((2, 50, 5))
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    jm = jnn.PReLU(5, init=0.25)
    # the module's ``init`` field (the slope) shadows Module.init
    v = _randomize(flax_nn.Module.init(jm, jax.random.PRNGKey(0), xj))
    want, _ = _jax_run(jm, v, xj)
    pm = _port_module(pnn.PReLU(5, init=0.25), v)
    got = pm(torch.from_numpy(x).transpose(1, 2).to(BF16))
    _check(got, want, layout="nct")


def test_qrnn_site(monkeypatch):
    """The QRNN's linear in bf16; the pooling gets float32 gates."""
    x = _x((2, 40, 8))
    jm = jnn.QRNN(hidden=12, impl="scan")
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want, _ = _jax_run(jm, v, jnp.asarray(x))
    pm = _port_module(pnn.QRNN(8, 12), v)
    seen = []
    pool = cuda_qrnn.qrnn_pool

    def spy(y, c0=None):
        seen.append(y.dtype)
        return pool(y, c0)

    monkeypatch.setattr(cuda_qrnn, "qrnn_pool", spy)
    with precision.compute_dtype(BF16):
        got = pm(torch.from_numpy(x))
    assert seen == [torch.float32]
    _check(got, want)


def test_deconv_site():
    """Deconv1D: x and kernel in bf16, the bias added in bf16."""
    x = _x((2, 20, 8))
    jm = jnn.Deconv1D(6, 30, 4, 13)
    v = jm.init(jax.random.PRNGKey(4), jnp.asarray(x))
    want, _ = _jax_run(jm, v, jnp.asarray(x))
    pm = _port_module(pnn.Deconv1D(8, 6, 30, 4, 13), v)
    with precision.compute_dtype(BF16):
        got = pm(torch.from_numpy(x).transpose(1, 2))
    _check(got, want, layout="nct")


@pytest.mark.parametrize("h_dtype", ["bfloat16", "float32"])
def test_fused_head_loss_site(h_dtype):
    """framed_mse_linear under the policy: W in h's type, float32 sums;
    a bf16 target (as prepare stores it) cast to float32."""
    rng = np.random.RandomState(5)
    h = rng.randn(2, 30, 16).astype(np.float32)
    w = (rng.randn(1, 16, 21) * 0.2).astype(np.float32)
    b = (rng.randn(21) * 0.1).astype(np.float32)
    tgt = rng.randn(2, 30, 3).astype(np.float32)
    hj = jnp.asarray(h).astype(h_dtype)
    tj = jnp.asarray(tgt).astype(jnp.bfloat16)
    with jax_compute_dtype(jnp.bfloat16):
        want = jax_losses.framed_mse_linear(jnp.asarray(w), jnp.asarray(b),
                                            hj, tj, 7)
    ht = torch.from_numpy(h).to(getattr(torch, h_dtype))
    with precision.compute_dtype(BF16):
        got = port_losses.framed_mse_linear(
            torch.from_numpy(w.transpose(2, 1, 0)), torch.from_numpy(b), ht,
            torch.from_numpy(tgt).to(BF16), 7)
    _check(got[None], jnp.asarray(want)[None])


def test_gammatone_target_site():
    """The gammatone FIR as a bf16 conv, RMS and log in bf16, deltas and
    the result in float32."""
    wav = next(iter(SyntheticChunkBatcher(2, 4800, seed=4)))["chunk"]
    with jax_compute_dtype(jnp.bfloat16):
        want = jax.jit(jax_features.gammatone)(jnp.asarray(wav))
    with precision.compute_dtype(BF16):
        got = port_features.gammatone(torch.from_numpy(wav))
    _check(got, want)


def test_prepare_stores_targets_in_the_compute_dtype():
    """Every worker target of workers+ after ZNorm, stored in bf16; the
    targets computed in float32 (lps, fbank, mfcc, prosody) within 2^-8
    of max|y| of JAX's. The gammatone targets' values are held before
    ZNorm by test_gammatone_target_site: their bf16 box sums cancel
    (a window is the difference of two running sums up to 30x larger),
    so one bf16 ulp of difference in the FIR output, from float32 sums in
    another order, moves a log energy by up to 0.03, which ZNorm with
    these statistics makes 1.2 x 2^-8 of max|y| (measured)."""
    with open("cfg/workers/workers+.cfg") as f:
        wk = json.load(f)
    raw = next(iter(SyntheticChunkBatcher(2, 4800, seed=6)))
    rng = np.random.RandomState(0)
    jmeta = jax_parse_workers(wk)
    names = [e["name"] for e in jmeta["regr"]
             if e["name"] not in ("chunk", "cchunk")]
    dims = {k: v.shape[-1] for k, v in jax.jit(
        jax_pipeline.make_prepare_fn(jmeta))(
            {k: jnp.asarray(v) for k, v in raw.items()},
            jax.random.PRNGKey(0)).items() if k in names}
    stats = {k: {"mean": rng.randn(d).astype(np.float32),
                 "std": rng.uniform(1.0, 3.0, d).astype(np.float32)}
             for k, d in dims.items()}
    jprep = jax_pipeline.make_prepare_fn(jmeta, stats=stats)
    with jax_compute_dtype(jnp.bfloat16):
        want = jax.jit(jprep)({k: jnp.asarray(v) for k, v in raw.items()},
                              jax.random.PRNGKey(0))
    prep = pipeline.make_prepare_fn(parse_workers_cfg(wk), stats=stats)
    with precision.compute_dtype(BF16):
        got = prep({k: torch.from_numpy(v) for k, v in raw.items()})
    for name in names:
        assert got[name].dtype == BF16, name
        if not name.startswith("gtn"):
            _check(got[name], want[name])
    assert got["chunk"].dtype == torch.float32


def test_one_bf16_train_step_matches_jax(tmp_path):
    """One small train step (test_torch_train's model: every worker kind
    of workers+) under the bf16 policy, port vs JAX from the same weights
    and batch: per-worker losses within 2^-7 relative."""
    from test_torch_train import SMALL_FE, _cfg, _init_state, small_workers
    cfg = dict(_cfg(tmp_path / "jax"), compute_dtype="bfloat16")
    jtr = JaxTrainer(SMALL_FE, small_workers(), cfg,
                     mesh=get_mesh(devices=jax.devices()[:1]))
    state = _init_state(jtr)
    state = state._replace(params=_randomize(
        {"params": state.params})["params"])
    raw = next(iter(SyntheticChunkBatcher(2, 4800, seed=3)))
    _, jlosses = jtr._make_train_step()(
        jax.tree.map(lambda a: jnp.array(a, copy=True), state),
        {k: jnp.asarray(v) for k, v in raw.items()})
    tr = Trainer(SMALL_FE, small_workers(),
                 dict(_cfg(tmp_path / "port"), compute_dtype="bfloat16"),
                 device="cpu")
    flat = flat_variables({"params": state.params,
                           "batch_stats": state.batch_stats})
    load_model_variables(tr.model, flat)
    losses = tr.train_step(raw)
    for name in tr.ordered_names + ["total"]:
        got, want = float(losses[name]), float(jlosses[name])
        assert abs(got - want) <= STEP_REL * abs(want), (name, got, want)


# ---------------------------------------------------------------------------
# float32 means TF32 off in every CLI that takes --device
# ---------------------------------------------------------------------------


class _SetUp(Exception):
    """Raised by a stub where the CLI's work would start."""


def _stop(*args, **kwargs):
    raise _SetUp


def _tf32_is_off():
    b = torch.backends
    conv = getattr(getattr(b.cudnn, "conv", None), "fp32_precision", None)
    return (not b.cuda.matmul.allow_tf32 and not b.cudnn.allow_tf32
            and conv != "tf32")


def _cli_cases():
    from pase_tpu_torch import (bench, conv_proto, make_trainset_statistics,
                                run_probe, train, transfer_gate,
                                util_scripts)
    from pase_tpu_torch.data import pipeline as port_pipeline
    from pase_tpu_torch.probes import tasks
    probe = ["--fe_cfg", "fe.cfg", "--train_list", "tr.lst", "--test_list",
             "te.lst", "--device", "cpu"]
    return {
        "train": (train, [(train, "train")], ["--synthetic", "--device",
                                              "cpu"], True),
        "util_scripts": (util_scripts, [(util_scripts, "forward_chunk")],
                         ["forward-chunk", "--fe_cfg", "fe.cfg", "--in_wav",
                          "a.wav", "--out_file", "a.npy", "--device", "cpu"],
                         False),
        "run_probe": (run_probe, [(tasks, "run_utt_classification")],
                      ["utt"] + probe, False),
        "transfer_gate": (transfer_gate, [(transfer_gate, "run")],
                          ["--device", "cpu"], False),
        "make_trainset_statistics": (
            make_trainset_statistics, [(port_pipeline, "compute_stats")],
            ["--synthetic", "--net_cfg", PASEP_WK, "--device", "cpu"],
            False),
        "bench": (bench, [(bench, "build")], ["--device", "cpu"], False),
        # no CPU route: main refuses without a card, after its setup
        "conv_proto": (conv_proto, [], [], False),
    }


PASEP_WK = "cfg/workers/workers+.cfg"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = ["train", "util_scripts", "run_probe", "transfer_gate",
        "make_trainset_statistics", "bench", "conv_proto"]


@pytest.fixture
def tf32_on():
    """Both TF32 flags on (cuDNN's default) for the test, restored after."""
    b = torch.backends
    old = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = True
    yield
    b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = old


@pytest.mark.parametrize("cli", CLIS)
def test_cli_setup_turns_tf32_off(cli, tf32_on, monkeypatch, tmp_path):
    """Each --device CLI's main leaves matmuls and cuDNN convolutions
    without TF32 before its work starts (``precision.full_precision``),
    whatever the process had: the card's torch defaults cuDNN to TF32."""
    module, stubs, argv, save = _cli_cases()[cli]
    for owner, name in stubs:
        monkeypatch.setattr(owner, name, _stop)
    if save:
        argv = argv + ["--save_path", str(tmp_path / "run")]
    monkeypatch.chdir(REPO_ROOT)
    assert not _tf32_is_off()
    with pytest.raises((_SetUp, RuntimeError)):
        module.main(argv)
    assert _tf32_is_off()
