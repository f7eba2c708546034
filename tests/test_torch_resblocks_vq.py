"""The residual VQ encoder of the port (FeResBlock, VQEMA, the resblocks
WaveFe, its stream, its artifact and its train step) against the JAX
package, on the CPU.

Bounds:
  * FeResBlock forward, train and eval: atol 2e-5 / rtol 1e-4 (the JAX
    package's own, tests/test_resblocks_vq.py);
  * the narrow resblocks + VQ WaveFe: atol 5e-5 / rtol 1e-3, the codes
    equal outside ties (a top-2 margin within 1e-5 of |x|^2 + |e|^2);
  * one training call's EMA state within 1e-6 relative, the VQ loss and
    perplexity within 1e-6;
  * one train step: losses within 1e-5 relative ('vq' included),
    gradients within 1e-4 of each leaf's largest (tests/test_torch_train);
    where a leaf's gradient is nearly cancelled by the BatchNorms after it
    (norm2's bias: every path from it is normalized again) and the two
    float32 steps differ by more, the port's gradient must be at least as
    close as the JAX step's to the port's float64 gradient;
  * the stream per push against the JAX stream within 1e-5 of the
    utterance's largest output, against the port's offline encoder rtol
    1e-3 / atol 2e-4 (the JAX contract);
  * the exported artifact within 2e-5 of forward-chunk.
Codebooks are narrow (K = 64): the CPU keeps K <= 256.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from pase_tpu import frontend as jax_frontend
from pase_tpu import nn as jnn
from pase_tpu.data.dataset import SyntheticChunkBatcher as JaxBatcher
from pase_tpu.parallel import sp as jax_sp
from pase_tpu.parallel.mesh import get_mesh
from pase_tpu.streaming import StreamingEncoder as JaxStream
from pase_tpu.trainer import Trainer as JaxTrainer
from pase_tpu_torch import frontend, serving, streaming, util_scripts
from pase_tpu_torch import nn as pnn
from pase_tpu_torch.checkpoint import (load_model_variables,
                                       model_state_dict_to_variables,
                                       model_variables_to_state_dict,
                                       save_variables_npz,
                                       variables_to_state_dict)
from pase_tpu_torch.data.io import write_wav
from pase_tpu_torch.grad_parity import VQ_TIE_REL
from pase_tpu_torch.trainer import Trainer
from test_torch_train import ADAM_B1, _fresh, _np_tree
from torch_port_common import flat_variables
from torch_port_common import port_test_guard  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VQ_CFG_PATH = os.path.join(REPO, "cfg", "frontend",
                           "PASE+_resblocks_VQ8192.cfg")
# PASE+_resblocks_VQ8192.cfg's layer kinds, narrow: resblocks (one that
# does not decimate), QRNN, dense skips, norm_out, a 64-code quantizer;
# stride product 160
VQ_FE = {"kwidths": [251, 21, 11, 11], "strides": [1, 10, 1, 16],
         "fmaps": [8, 8, 16, 16], "rnn_pool": True, "rnn_dim": 16,
         "emb_dim": 8, "denseskips": True, "norm_out": True,
         "resblocks": True, "vq_K": 64}
HEAD = {"num_outputs": 1, "dropout": 0, "hidden_size": 32,
        "hidden_layers": 1, "skip": False}
BANK = {"cls": [dict(HEAD, name="mi", loss="BCEWithLogitsLoss")],
        "regr": [dict(HEAD, name="mfcc", num_outputs=20, loss="MSELoss",
                      transform={"der_order": 0, "order": 20})]}
BATCH, CHUNK = 2, 4800
LR = 5e-4


def randomize(flat, seed):
    """Random BatchNorm statistics and affine parameters and PReLU slopes
    in a flat JAX variable dict (their inits hide mistakes)."""
    rng = np.random.RandomState(seed)
    out = dict(flat)
    for k, v in flat.items():
        parts = k.split("/")
        mod, leaf, shape = parts[-2], parts[-1], np.shape(v)
        if leaf == "mean":
            new = rng.randn(*shape) * 0.1
        elif leaf == "var":
            new = rng.uniform(0.5, 1.5, shape)
        elif mod.startswith("norm") and leaf == "weight":
            new = rng.uniform(0.5, 1.5, shape)
        elif mod.startswith("norm") and leaf == "bias":
            new = rng.randn(*shape) * 0.1
        elif mod.startswith("act") and leaf == "weight":
            new = rng.uniform(0.0, 0.3, shape)
        else:
            continue
        out[k] = new.astype(np.float32)
    return out


def _tree(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


def _x(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _load(port, flat):
    port.load_state_dict({**port.state_dict(),
                          **variables_to_state_dict(flat)}, strict=True)
    return port


# ---------------------------------------------------------------------------
# FeResBlock
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("downsample, cin", [(1, 16), (1, 8), (2, 16),
                                             (2, 8)],
                         ids=["ds1_same", "ds1_proj", "ds2_same",
                              "ds2_proj"])
def test_feresblock_matches_jax(downsample, cin, train):
    fmaps, kwidth = 16, 5
    x = _x((2, 96, cin), seed=1)
    jm = jnn.FeResBlock(fmaps=fmaps, kwidth=kwidth, downsample=downsample,
                        norm_type="bnorm")
    flat = randomize(flat_variables(jm.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x))), seed=2)
    port = _load(pnn.FeResBlock(cin, fmaps, kwidth, downsample=downsample,
                                norm_type="bnorm"), flat).train(train)
    assert (port.resproj is None) == (cin == fmaps)
    if train:
        want, ups = jm.apply(_tree(flat), jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    else:
        want = jm.apply(_tree(flat), jnp.asarray(x), train=False)
    got = port(torch.from_numpy(x.transpose(0, 2, 1)))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 1),
                               np.asarray(want), atol=2e-5, rtol=1e-4)
    assert got.shape[2] == 96 // downsample
    if train:
        stats = flat_variables({"batch_stats": ups["batch_stats"]})
        for k, v in variables_to_state_dict(stats).items():
            np.testing.assert_allclose(port.state_dict()[k].numpy(), v,
                                       atol=1e-6, err_msg=k)


def test_feresblock_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="even"):
        pnn.FeResBlock(8, 8, 4)
    with pytest.raises(TypeError, match="glu"):
        pnn.FeResBlock(8, 8, 5, act="glu")
    # the norm types JAX takes build (tests/test_torch_norms.py holds
    # them to JAX); an unknown one raises as JAX's build_norm does
    for norm in ("snorm", "wnorm", "bsnorm", "lnorm", "inorm", "affinorm"):
        pnn.FeResBlock(8, 8, 5, norm_type=norm)
    with pytest.raises(TypeError, match="Unrecognized norm type"):
        pnn.FeResBlock(8, 8, 5, norm_type="gnorm")


# ---------------------------------------------------------------------------
# VQEMA and the resblocks WaveFe
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vq_jax():
    """(JAX WaveFe, its randomized flat variables)."""
    jm = jax_frontend.build_wavefe(dict(VQ_FE, qrnn_impl="scan"))
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4000)), train=False)
    return jm, randomize(flat_variables(v), seed=5)


@pytest.fixture
def vq_pair(vq_jax):
    """(JAX WaveFe, its flat variables, the port's WaveFe with them, in
    eval): a fresh port per test, as training moves the codebook."""
    return vq_jax + (_load(frontend.build_wavefe(VQ_FE), vq_jax[1]).eval(),)


def _jax_codes(jm, flat, x, emb):
    """The JAX encoder's pre-quantizer frames (the same weights without
    the quantizer) -> (float64 codes, tie mask) against ``emb``."""
    pre = jax_frontend.build_wavefe(dict(VQ_FE, vq_K=None,
                                         qrnn_impl="scan"))
    z = np.asarray(pre.apply(_tree({k: v for k, v in flat.items()
                                    if "quantizer" not in k}),
                             jnp.asarray(x), train=False), np.float64)
    z = z.reshape(-1, z.shape[-1])
    e = np.asarray(emb, np.float64)
    d = (z * z).sum(1)[:, None] + (e * e).sum(1) - 2 * z @ e.T
    top = np.sort(d, axis=1)[:, :2]
    idx = d.argmin(1)
    scale = (z * z).sum(1) + (e[idx] * e[idx]).sum(1)
    return idx, (top[:, 1] - top[:, 0]) / scale <= VQ_TIE_REL


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_vq_wavefe_matches_jax(vq_pair, train):
    jm, flat, port = vq_pair
    x = _x((2, 8000), seed=7, scale=0.1)
    if train:
        want, ups = jm.apply(_tree(flat), jnp.asarray(x), train=True,
                             mutable=["batch_stats", "intermediates"])
    else:
        want, ups = jm.apply(_tree(flat), jnp.asarray(x), train=False,
                             mutable=["intermediates"])
    got = port.train(train)(torch.from_numpy(x))
    codes, ties = _jax_codes(jm, flat, x,
                             flat["batch_stats/quantizer/emb"])
    if not train:
        # the pre-quantizer frames are eval-mode ones only in eval
        agree = port.quantizer.codes.numpy() == codes
        assert np.all(agree | ties), np.flatnonzero(~(agree | ties))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=5e-5, rtol=1e-3)
    inter = ups["intermediates"]
    for key, mine in (("vq_loss", port.vq_loss),
                      ("vq_perplexity", port.vq_perplexity)):
        w = float(inter[key][0])
        mine = float(mine.detach())
        assert abs(mine - w) <= 1e-6 * abs(w), (key, mine, w)
    if train:
        stats = flat_variables({"batch_stats": ups["batch_stats"]})
        for leaf in ("emb", "ema_cluster_size", "ema_w"):
            w = stats[f"batch_stats/quantizer/{leaf}"]
            g = getattr(port.quantizer, leaf).numpy()
            assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max(), leaf


def test_vq_straight_through_and_commitment_gradient():
    """d(out)/dx is the identity; the commitment loss pulls x toward q:
    its gradient is 2 beta (x - q) / numel."""
    vq = pnn.VQEMA(16, 4, beta=0.25, generator=torch.Generator()
                   .manual_seed(0)).eval()
    x = torch.randn(2, 5, 4, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    out = vq(x)
    q = vq.emb[vq.codes].reshape(2, 5, 4)
    torch.testing.assert_close(out, x + (q - x), rtol=0, atol=0)
    (g_out,) = torch.autograd.grad(out.sum(), x)
    torch.testing.assert_close(g_out, torch.ones_like(x))
    (g_loss,) = torch.autograd.grad(vq.loss, x)
    torch.testing.assert_close(g_loss, 0.5 * (x - q).detach() / x.numel())


def test_vq_eval_leaves_the_codebook_and_quantize_is_the_gather():
    vq = pnn.VQEMA(32, 6, generator=torch.Generator().manual_seed(2)).eval()
    before = {k: v.clone() for k, v in vq.state_dict().items()}
    y = torch.randn(3, 6, 40, generator=torch.Generator().manual_seed(3))
    out = vq(y.transpose(1, 2))
    for k, v in vq.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    q = vq.quantize(y)
    torch.testing.assert_close(q, vq.emb[vq.codes].reshape(3, 40, 6)
                               .transpose(1, 2), rtol=0, atol=0)
    torch.testing.assert_close(out.transpose(1, 2), q, rtol=0, atol=1e-6)


def test_time_shard_halo_matches_jax_on_the_vq_config():
    cfg = frontend.load_cfg(VQ_CFG_PATH)
    port = frontend.build_wavefe(dict(cfg, vq_K=None))
    want = jax_sp.time_shard_halo(jax_frontend.build_wavefe(cfg))
    assert serving.time_shard_halo(port) == want
    assert serving.time_shard_halo(frontend.build_wavefe(VQ_FE)) == \
        jax_sp.time_shard_halo(jax_frontend.build_wavefe(VQ_FE))


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------

class _JaxEncoder:
    def __init__(self, module, variables):
        self.module = module
        self.variables = variables


def _emissions(stream, wav, sizes):
    out, i = [], 0
    for n in sizes:
        out.append(stream.push(wav[:, i:i + n]))
        i += n
    out.append(stream.flush())
    return [None if y is None else np.asarray(y) for y in out]


def _cat(packets):
    return np.concatenate([p for p in packets if p is not None], axis=2)


@pytest.mark.parametrize("t, sizes", [
    (16000, [8000, 8000]),
    (12037, [3000, 777, 8260]),
], ids=["halves", "uneven_ragged"])
def test_vq_stream_matches_jax_and_offline(vq_pair, t, sizes):
    jm, flat, port = vq_pair
    wav = _x((2, t), seed=t, scale=0.1)
    want = _emissions(JaxStream(_JaxEncoder(jm, _tree(flat))),
                      jnp.asarray(wav), sizes)
    got = _emissions(streaming.StreamingEncoder(port),
                     torch.from_numpy(wav), sizes)
    assert [None if p is None else p.shape for p in got] == \
        [None if p is None else p.shape for p in want]
    scale = np.abs(_cat(want)).max()
    for g, w in zip(got, want):
        if w is not None:
            assert np.abs(g - w).max() <= 1e-5 * scale
    with torch.no_grad():
        ref = port(torch.from_numpy(wav)).transpose(1, 2).numpy()
    assert _cat(got).shape == ref.shape == (2, 8, t // 160)
    np.testing.assert_allclose(_cat(got), ref, rtol=1e-3, atol=2e-4)


def test_vq_stream_state_round_trip(vq_pair):
    """get_state mid-stream, set_state into a fresh stream, go on: the
    uninterrupted stream's frames bit for bit."""
    port = vq_pair[2]
    wav = torch.from_numpy(_x((1, 12000), seed=3, scale=0.1))
    whole = _emissions(streaming.StreamingEncoder(port), wav, [5000, 7000])
    first = streaming.StreamingEncoder(port)
    head = first.push(wav[:, :5000])
    second = streaming.StreamingEncoder(port)
    second.set_state(first.get_state())
    tail = _emissions(second, wav[:, 5000:], [7000])
    np.testing.assert_array_equal(_cat([np.asarray(head)] + tail),
                                  _cat(whole))


# ---------------------------------------------------------------------------
# the serving artifact and the CLIs
# ---------------------------------------------------------------------------

def test_vq_artifact_matches_forward_chunk(vq_pair, tmp_path):
    """export (offline buckets and the streaming programs) and
    serve-encode of the narrow VQ encoder on the CPU: within 2e-5 of
    forward-chunk at the largest bucket; the quantizer's codebook is a
    program input from params.npz, not transposed; serve-encode
    --streaming and forward-chunk --streaming give the in-process
    stream's frames."""
    port = vq_pair[2]
    ckpt = save_variables_npz(str(tmp_path / "fe.npz"), port.state_dict())
    wav = _x((9100,), seed=11, scale=0.1)
    write_wav(str(tmp_path / "a.wav"), wav)
    common = ["--fe_cfg", _cfg_file(tmp_path), "--fe_ckpt", ckpt,
              "--device", "cpu"]
    art = str(tmp_path / "art")
    util_scripts.main(["export", "--out_dir", art, "--chunk_sizes",
                       "1600,3200", "--streaming_chunk", "4800"] + common)
    util_scripts.main(["forward-chunk", "--in_wav", str(tmp_path / "a.wav"),
                       "--out_file", str(tmp_path / "fc.npy"),
                       "--chunk_size", "3200"] + common)
    util_scripts.main(["serve-encode", "--export_dir", art, "--in_wav",
                       str(tmp_path / "a.wav"), "--out_file",
                       str(tmp_path / "se.npy")])
    want = np.load(tmp_path / "fc.npy")
    got = np.load(tmp_path / "se.npy")
    assert got.shape == want.shape == (8, 9100 // 160)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    meta = serving.ServingEncoder(art).meta
    row = [r for r in meta["inputs"] if r[0] == "quantizer.emb"]
    assert row == [["quantizer.emb", "batch_stats/quantizer/emb", None]]
    util_scripts.main(["serve-encode", "--export_dir", art, "--streaming",
                       "--in_wav", str(tmp_path / "a.wav"), "--out_file",
                       str(tmp_path / "ss.npy")])
    st = streaming.stream_frames(port, torch.from_numpy(
        np.pad(wav, (0, 4800 * 2 - len(wav)))[None]), 4800)
    np.testing.assert_array_equal(np.load(tmp_path / "ss.npy"),
                                  st[0].numpy()[:, :9100 // 160])
    util_scripts.main(["forward-chunk", "--streaming", "--in_wav",
                       str(tmp_path / "a.wav"), "--out_file",
                       str(tmp_path / "fs.npy"), "--chunk_size", "1600"]
                      + common)
    np.testing.assert_array_equal(
        np.load(tmp_path / "fs.npy"),
        streaming.stream_frames(port, torch.from_numpy(wav[None]),
                                1600)[0].numpy()[:, :9100 // 160])


def _cfg_file(tmp_path):
    import json
    path = tmp_path / "vq_fe.cfg"
    path.write_text(json.dumps(VQ_FE))
    return str(path)


# ---------------------------------------------------------------------------
# the train step and the train state
# ---------------------------------------------------------------------------

def _cfg(save_path, **over):
    return dict(dict(backprop_mode="base", hop=160, bpe=100, epoch=10,
                     batch_size=BATCH, chunk_size=CHUNK, log_freq=2,
                     fe_lr=LR, min_lr=LR, lr_mode="poly",
                     save_path=str(save_path)), **over)


@pytest.fixture(scope="module")
def jax_vq_step(tmp_path_factory):
    """The JAX step on the narrow VQ encoder and a small bank, from
    randomized variables: (flat params, flat stats, batch, losses,
    gradients, new batch_stats, tmp)."""
    from test_torch_train import _init_state as init_small
    tmp = tmp_path_factory.mktemp("vq_step")
    jtr = JaxTrainer(VQ_FE, BANK, _cfg(tmp / "jax"),
                     mesh=get_mesh(devices=jax.devices()[:1]))
    state = init_small(jtr)
    params = randomize(_np_tree(state.params), seed=9)
    stats = randomize(_np_tree(state.batch_stats), seed=10)
    state = state._replace(params=unflatten_dict(
        {k: jnp.asarray(v) for k, v in params.items()}, sep="/"),
        batch_stats=unflatten_dict(
            {k: jnp.asarray(v) for k, v in stats.items()}, sep="/"))
    raw = next(iter(JaxBatcher(BATCH, CHUNK, seed=4)))
    new_state, losses = jtr._make_train_step()(
        _fresh(state), {k: jnp.asarray(v) for k, v in raw.items()})
    grads = {}
    for group in new_state.opt_state.inner_states.values():
        adam = group.inner_state[0]
        for k, mu in flatten_dict(unfreeze(adam.mu), sep="/").items():
            if not isinstance(mu, optax.MaskedNode):
                grads[k] = np.asarray(mu, np.float64) / (1.0 - ADAM_B1)
    return (params, stats, raw, {k: float(v) for k, v in losses.items()},
            grads, _np_tree(new_state.batch_stats), tmp)


def _port_trainer(jax_vq_step_, name, **over):
    params, stats = jax_vq_step_[0], jax_vq_step_[1]
    tr = Trainer(VQ_FE, BANK, _cfg(jax_vq_step_[-1] / name, **over),
                 device="cpu")
    flat = {f"params/{k}": v for k, v in params.items()}
    flat.update({f"batch_stats/{k}": v for k, v in stats.items()})
    load_model_variables(tr.model, flat)
    return tr


def _bn_cancelled(k):
    """A bias that feeds a BatchNorm, which removes it: zero gradient."""
    return k.endswith(("conv1/bias", "resproj/bias")) or k == "frontend/W/bias"


def _float64_grads(jax_vq_step_):
    """The port's step gradient in float64 on the CPU, from the same
    weights and batch: the reference for cancellation-prone leaves."""
    from pase_tpu_torch.model import worker_losses
    tr = _port_trainer(jax_vq_step_, "float64")
    model = tr.model.double().train()
    batch = tr.prepare({k: torch.as_tensor(v, dtype=torch.float64)
                        for k, v in jax_vq_step_[2].items()})
    _, _, preds, labels = model(batch, 1.0)
    total = sum(worker_losses(tr.meta, preds, labels).values())
    (total + model.frontend.vq_loss).backward()
    return model_state_dict_to_variables(
        {k: p.grad for k, p in model.named_parameters()})


def test_vq_train_step_matches_jax(jax_vq_step):
    _, _, raw, jlosses, grads, new_stats, _ = jax_vq_step
    tr = _port_trainer(jax_vq_step, "step")
    losses = tr.train_step(raw)
    assert set(losses) == set(jlosses)
    for name in tr.ordered_names + ["vq", "vq_perplexity", "total"]:
        got, want = float(losses[name]), jlosses[name]
        assert abs(got - want) <= 1e-5 * abs(want), (name, got, want)
    port_grads = model_state_dict_to_variables(
        {k: p.grad for k, p in tr.model.named_parameters()})
    assert {k[len("params/"):] for k in port_grads} == set(grads)
    fe_max = max(np.abs(g).max() for k, g in grads.items()
                 if k.startswith("frontend/"))
    g64 = None
    for k, g in grads.items():
        got = port_grads["params/" + k]
        if _bn_cancelled(k):
            assert np.abs(g).max() <= 1e-5 * fe_max, k
            assert np.abs(got).max() <= 1e-5 * fe_max, k
            continue
        err = np.abs(got - g).max()
        if err <= 1e-4 * np.abs(g).max():
            continue
        assert k.endswith("norm2/bias"), (k, err, np.abs(g).max())
        g64 = _float64_grads(jax_vq_step) if g64 is None else g64
        ref = g64["params/" + k]
        assert np.abs(got - ref).max() <= np.abs(g - ref).max(), k
    sd = model_state_dict_to_variables(tr.model.state_dict())
    for leaf in ("emb", "ema_cluster_size", "ema_w"):
        w = new_stats[f"frontend/quantizer/{leaf}"]
        g = sd[f"batch_stats/frontend/quantizer/{leaf}"]
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max(), leaf


def test_vq_bridge_round_trip_keeps_the_codebook(jax_vq_step):
    """The JAX variables map to the port's state dict and back exactly;
    the codebook stays [K, D] in batch_stats, never transposed."""
    params, stats = jax_vq_step[0], jax_vq_step[1]
    flat = {f"params/{k}": v for k, v in params.items()}
    flat.update({f"batch_stats/{k}": v for k, v in stats.items()})
    tr = _port_trainer(jax_vq_step, "bridge")
    sd = model_variables_to_state_dict(flat)
    assert set(sd) == {k for k in tr.model.state_dict()
                       if not k.endswith("num_batches_tracked")}
    assert tuple(sd["frontend.quantizer.emb"].shape) == (64, 8)
    back = model_state_dict_to_variables(tr.model.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert not any("quantizer" in k for k in params)


def test_vq_resume_is_bit_identical(jax_vq_step, tmp_path):
    """Two steps, save (the codebook and its EMA state in the train
    state's batch_stats, without Adam moments), a new Trainer resumes and
    takes two more: the uninterrupted four steps' losses, parameters and
    codebook, bit for bit."""
    batches = [next(iter(JaxBatcher(BATCH, CHUNK, seed=20 + i)))
               for i in range(4)]
    whole = _port_trainer(jax_vq_step, "whole")
    want = [whole.train_step(b) for b in batches]
    first = _port_trainer(jax_vq_step, "resume")
    for b in batches[:2]:
        first.train_step(b)
    first.save(0)
    flat, _ = first.saver.load_weights()
    for leaf in ("emb", "ema_cluster_size", "ema_w"):
        key = f"batch_stats/frontend/quantizer/{leaf}"
        np.testing.assert_array_equal(
            flat[key], getattr(first.model.frontend.quantizer, leaf).numpy())
    assert not any(k.startswith("opt_state/") and "quantizer" in k
                   for k in flat)           # state, not a parameter
    second = Trainer(VQ_FE, BANK, _cfg(jax_vq_step[-1] / "resume"),
                     device="cpu")
    assert second.try_resume() == 2
    got = [second.train_step(b) for b in batches[2:]]
    for g, w in zip(got, want[2:]):
        for k in w:
            assert torch.equal(g[k], w[k]), k
    for (k, a), b in zip(whole.model.state_dict().items(),
                         second.model.state_dict().values()):
        # num_batches_tracked has no place in the train state
        assert k.endswith("num_batches_tracked") or torch.equal(a, b), k


def test_vq_eval_step_adds_the_commitment_loss(jax_vq_step):
    tr = _port_trainer(jax_vq_step, "eval")
    out = tr.eval_step(jax_vq_step[2])
    assert "vq_perplexity" not in out
    workers = sum(float(out[n]) for n in tr.ordered_names)
    assert float(out["vq"]) > 0
    assert abs(float(out["total"]) - workers - float(out["vq"])) <= \
        1e-6 * abs(float(out["total"]))


def test_vq_train_cli_on_the_cpu(tmp_path, monkeypatch):
    """python -m pase_tpu_torch.train on the narrow VQ encoder at 3 steps
    an epoch: every logged loss finite, 'vq' and 'vq_perplexity' among
    them."""
    import json
    import math
    from pase_tpu_torch import train as train_cli
    monkeypatch.setattr(train_cli, "SYNTHETIC_BPE", 3)
    workers = tmp_path / "workers.cfg"
    workers.write_text(json.dumps(BANK))
    tr = train_cli.main(["--synthetic", "--device", "cpu", "--net_cfg",
                         str(workers), "--fe_cfg", _cfg_file(tmp_path),
                         "--batch_size", "2", "--chunk_size", "3200",
                         "--epoch", "1", "--log_freq", "1", "--save_path",
                         str(tmp_path / "run")])
    tr.logger.close()
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f if line.strip()]
    train = [r for r in recs if r["split"] == "train"]
    assert train and all("vq" in r and "vq_perplexity" in r for r in train)
    ev = [r for r in recs if r["split"] == "eval"]
    assert ev and "vq" in ev[-1]
    for r in train + ev:
        for k, v in r.items():
            if k not in ("t", "split", "step"):
                assert math.isfinite(v), (k, v)
    assert os.path.isfile(tmp_path / "run" / "FE_e0.npz")
