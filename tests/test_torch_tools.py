"""The port's step-level tools (pase_tpu_torch.util_scripts eval-ckpts,
precompute-feats, profile-step, export-torch) and the reference
checkpoint layouts (pase_tpu_torch.checkpoint) against the JAX package,
on the CPU.

Bounds:
  * export-torch: the same keys in the same order, equal tensors; the
    port's and JAX's encoders load the file back to the original arrays
    bit for bit;
  * reference-layout encoders (TDNN, ASPP, ResNet, spectral- and
    weight-normalized FeBlocks): both packages load one file to equal
    arrays, exactly;
  * a whole reference ``pase`` state dict: the port's model equals the
    source exactly, and every worker's eval output of the port within
    1e-5 of the largest of JAX's (float32 sums in another order);
  * the GRU conversion: equal to JAX's torch_gru_params, and the cell
    computes torch's nn.GRU within 1e-6;
  * precompute-feats: each cached array within 1e-5 of the largest of
    JAX's (mfcc, fbank, prosody: the targets the packages agree on to
    2.3e-6);
  * eval-ckpts: each checkpoint's total within 1e-5 relative of JAX's,
    from the same worker init;
  * profile-step: JAX's five keys (tests/test_cli_scripts.py:406).
"""

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict

from pase_tpu import checkpoint as jax_ckpt
from pase_tpu import frontend as jax_frontend
from pase_tpu.model import build_pase as jax_build_pase
from pase_tpu_torch import frontend, nn as pnn, util_scripts
from pase_tpu_torch.checkpoint import (load_frontend_ckpt,
                                       load_reference_pase_ckpt,
                                       save_variables_npz,
                                       state_dict_to_variables,
                                       torch_gru_params,
                                       torch_to_variables)
from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
from pase_tpu_torch.data.pipeline import make_prepare_fn
from pase_tpu_torch.data.synthetic_corpus import write_synthetic_corpus
from pase_tpu_torch.model import build_pase, materialize_pred
from pase_tpu_torch.nn import FlaxRNN, torch_cell_to_flax
from test_torch_train import SMALL_FE, small_workers
from torch_port_common import NARROW_CFG, flat_variables, rel_err
from torch_port_common import port_test_guard  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import util_scripts as jax_util  # noqa: E402

REL = 1e-5
# the encoder and worker bank of the JAX CLI tests (test_cli_scripts.py)
FE = {"kwidths": [65, 10, 5, 5], "strides": [1, 10, 4, 4],
      "fmaps": [16, 16, 32, 32], "emb_dim": 32, "norm_out": True}
WK = {"regr": [{"num_outputs": 39, "dropout": 0, "hidden_size": 32,
                "hidden_layers": 1, "name": "mfcc", "r": 1,
                "loss": "MSELoss", "skip": False}],
      "cls": [{"num_outputs": 1, "dropout": 0, "hidden_size": 32,
               "hidden_layers": 1, "name": "mi",
               "loss": "BCEWithLogitsLoss", "skip": False}]}
# tests/test_torch_encoders.py's and test_torch_norms.py's narrow cfgs
TDNN_FE = {"name": "tdnn", "emb_dim": 16, "fmaps": 8, "kwidth": 161,
           "rnn_pool": True}
ASPP_RES = {"name": "asppRes", "sinc_out": 4, "hidden_dim": 8,
            "sinc_kernel": 33, "kernel_sizes": [5, 5, 5, 5],
            "fmaps": [4, 4, 4, 4], "rnn_pool": True}
RESNET = {"name": "Resnet50", "sinc_out": 4, "hidden_dim": 8,
          "sinc_kernel": 33, "stage_fmaps": [8, 8, 16, 16],
          "stage_blocks": [1, 2, 1, 1]}
NORM_FE = {"sincnet": False, "kwidths": [31, 20, 11, 11],
           "strides": [1, 10, 2, 2], "fmaps": [8, 8, 16, 16],
           "emb_dim": 8, "rnn_pool": True, "rnn_dim": 16,
           "denseskips": True, "norm_out": True}


def _write_cfgs(tmp_path, fe=FE, wk=WK):
    paths = []
    for name, cfg in (("fe.cfg", fe), ("wk.cfg", wk)):
        paths.append(str(tmp_path / name))
        with open(paths[-1], "w") as f:
            json.dump(cfg, f)
    return paths


def _random_stats(module, seed):
    """Random BatchNorm running stats (their init, 0 and 1, hides a
    swapped or dropped entry)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, b in module.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)
    return module


@pytest.mark.parametrize("cfg", [NARROW_CFG, dict(TDNN_FE,
                                                  rnn_type="lstm")],
                         ids=["wavefe", "tdnn_lstm"])
def test_export_torch_matches_jax_and_loads_back(cfg, tmp_path):
    enc = frontend.wf_builder(cfg, device="cpu", seed=4)
    _random_stats(enc.module, 5)
    npz = save_variables_npz(str(tmp_path / "FE_e0.npz"),
                             enc.module.state_dict())
    got_path, want_path = str(tmp_path / "p.ckpt"), str(tmp_path / "j.ckpt")
    util_scripts.main(["export-torch", "--in_ckpt", npz, "--out_ckpt",
                       got_path])
    jax_util.export_torch(argparse.Namespace(in_ckpt=npz,
                                             out_ckpt=want_path))
    got = torch.load(got_path, weights_only=True)
    want = torch.load(want_path, weights_only=True)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k
    back = frontend.wf_builder(cfg, device="cpu", seed=9)
    back.load_pretrained(got_path)
    ref = enc.module.state_dict()
    for k, v in back.module.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, ref[k]), k
    x = np.random.RandomState(0).randn(2, 1, 3200).astype(np.float32)
    assert torch.equal(back(x), enc(x))
    jenc = jax_frontend.wf_builder(cfg)
    jenc.init(example_len=3200)
    jenc.load_pretrained(got_path)
    flat = state_dict_to_variables(ref)
    jflat = flat_variables(jenc.variables)
    assert set(jflat) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(jflat[k], v, err_msg=k)


def test_vq_encoder_export_loads_back(tmp_path):
    """The VQ encoder's codebook and EMA state, which export-torch writes
    under their own names, load back into the port's batch_stats."""
    vq = {"kwidths": [251, 21, 11, 11], "strides": [1, 10, 1, 16],
          "fmaps": [8, 8, 16, 16], "rnn_pool": True, "rnn_dim": 16,
          "emb_dim": 8, "denseskips": True, "norm_out": True,
          "resblocks": True, "vq_K": 64}
    enc = frontend.wf_builder(vq, device="cpu", seed=4)
    with torch.no_grad():
        enc.module.quantizer.emb.normal_(generator=torch.Generator()
                                         .manual_seed(1))
    npz = save_variables_npz(str(tmp_path / "FE_e0.npz"),
                             enc.module.state_dict())
    ckpt = str(tmp_path / "FE_e0.ckpt")
    util_scripts.main(["export-torch", "--in_ckpt", npz, "--out_ckpt",
                       ckpt])
    assert "quantizer.emb" in torch.load(ckpt, weights_only=True)
    back = frontend.wf_builder(vq, device="cpu", seed=9).load_pretrained(
        ckpt)
    for k, v in enc.module.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back.module.state_dict()[k], v), k


def _reference_layout(module):
    """The module's state dict in the reference torch names: weight_norm's
    weight_g [C, 1, 1] / weight_v, spectral_norm's weight_orig /
    weight_u."""
    sd = dict(module.state_dict())
    for name, m in module.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, pnn.WNConv1D):
            sd[pre + "weight_g"] = sd.pop(pre + "g").reshape(-1, 1, 1)
            sd[pre + "weight_v"] = sd.pop(pre + "v")
        elif isinstance(m, pnn.SNConv1D):
            sd[pre + "weight_orig"] = sd.pop(pre + "weight")
            sd[pre + "weight_u"] = sd.pop(pre + "u")
    return sd


@pytest.mark.parametrize("cfg", [
    TDNN_FE, ASPP_RES, RESNET, dict(NORM_FE, norm_type="snorm"),
    dict(NORM_FE, norm_type="wnorm")],
    ids=["tdnn", "asppRes", "Resnet50", "snorm", "wnorm"])
def test_reference_layout_encoders_load_in_both(cfg, tmp_path):
    """A reference-keyed .ckpt of each encoder family (the weight-norm and
    spectral-norm leaves under torch's names) loads into the port and,
    through the JAX package's torch_to_variables, into JAX, to the same
    arrays."""
    src = frontend.wf_builder(cfg, device="cpu", seed=6)
    _random_stats(src.module, 7)
    sd = _reference_layout(src.module)
    assert any(k.endswith(("weight_g", "weight_orig")) for k in sd) == (
        "norm_type" in cfg)
    path = str(tmp_path / "ref.ckpt")
    torch.save(sd, path)
    want = state_dict_to_variables(src.module.state_dict())
    port = frontend.wf_builder(cfg, device="cpu", seed=8).load_pretrained(
        path)
    got = state_dict_to_variables(port.module.state_dict())
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    jenc = jax_frontend.wf_builder(cfg)
    jenc.variables = jax.jit(jenc.module.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((1, 3200)), train=False)
    jenc.load_pretrained(path)
    jflat = flat_variables(jenc.variables)
    assert set(jflat) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(jflat[k], v, err_msg=k)


def test_partial_reference_files_raise_unless_not_strict(tmp_path):
    enc = frontend.wf_builder(NARROW_CFG, device="cpu", seed=4)
    sd = dict(enc.module.state_dict())
    sd.pop("W.weight")
    path = str(tmp_path / "part.ckpt")
    torch.save(sd, path)
    fresh = frontend.wf_builder(NARROW_CFG, device="cpu", seed=5)
    with pytest.raises(ValueError, match="remain at init"):
        load_frontend_ckpt(path, fresh.module)
    ref = state_dict_to_variables(fresh.module.state_dict())
    part = torch_to_variables(sd, ref, strict=False)
    assert np.array_equal(part["params/W/kernel"], ref["params/W/kernel"])
    np.testing.assert_array_equal(part["params/W/bias"], sd["W.bias"])
    sd["W.weight"] = enc.module.state_dict()["W.weight"]
    sd["extra.weight"] = torch.zeros(3)
    torch.save(sd, path)
    with pytest.raises(ValueError, match="skipped 1 keys"):
        load_frontend_ckpt(path, fresh.module)


def _reference_pase_state_dict(model, meta):
    """A port PASE's state dict in the reference ``pase`` names."""
    regr = [e["name"] for e in meta["regr"]]
    cls = [e["name"] for e in meta["cls"]]
    out = {}
    for k, v in model.state_dict().items():
        top, _, rest = k.partition(".")
        if top == "frontend":
            out[k] = v
            continue
        name, _, leaf = rest.partition(".")
        if name in regr:
            out[f"regression_workers.{regr.index(name)}.{leaf}"] = v
        else:
            out[f"classification_workers.{cls.index(name)}.minion."
                f"{leaf}"] = v
    return out


def test_reference_pase_checkpoint_matches_jax(tmp_path):
    """A whole reference ``pase`` state dict (the encoder, the workers+
    bank with its decoder's transposed convs and the fused lps heads)
    loads into the port and into JAX; one eval forward of each on the
    same prepared batch gives every worker's output."""
    wk = small_workers()
    src, meta = build_pase(SMALL_FE, wk,
                           generator=torch.Generator().manual_seed(3))
    _random_stats(src, 4)
    path = str(tmp_path / "pase.ckpt")
    torch.save(_reference_pase_state_dict(src, meta), path)
    model, _ = build_pase(SMALL_FE, wk,
                          generator=torch.Generator().manual_seed(5))
    load_reference_pase_ckpt(path, model, meta)
    want = src.state_dict()
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
    raw = next(iter(SyntheticChunkBatcher(2, 4800, seed=2)))
    with torch.no_grad():
        batch = make_prepare_fn(meta)({k: torch.from_numpy(v)
                                       for k, v in raw.items()})
        _, _, preds, _ = model.eval()(batch, 1.0)
    jmodel, jmeta = jax_build_pase(SMALL_FE, wk)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        {"params": key, "sample": key, "dropout": key}, jbatch)
    variables = jax_ckpt.load_reference_pase_ckpt(path, variables, jmeta)
    (_, _, jpreds, _), _ = jax.jit(lambda v, b: jmodel.apply(
        v, b, 1.0, train=False, rngs={"sample": key},
        mutable=["intermediates"]))(variables, jbatch)
    names = [e["name"] for e in meta["cls"] + meta["regr"]]
    assert set(jpreds) == set(names) == set(preds)
    for name in names:
        with torch.no_grad():
            got = materialize_pred(preds[name]).numpy()
        w = np.asarray(jpreds[name])
        assert got.shape == w.shape, name
        assert rel_err(got, w) <= REL, (name, rel_err(got, w))


def test_gru_params_match_jax():
    """One nn.GRU layer -> the GRU head's cell: the flax Dense form equals
    JAX's torch_gru_params, and the cell computes the GRU layer."""
    gru = torch.nn.GRU(5, 7, num_layers=2, batch_first=True)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in gru.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    sd = {f"rnn.{k}": v for k, v in gru.state_dict().items()}
    npsd = {k: v.numpy() for k, v in sd.items()}
    for layer in (0, 1):
        got = torch_gru_params(sd, "rnn", layer)
        want = jax_ckpt.torch_gru_params(npsd, "rnn", layer)
        flat = torch_cell_to_flax({k: v.numpy() for k, v in got.items()})
        want_flat = {f"{d}/{leaf}": np.asarray(a) for d, leaves in
                     want.items() for leaf, a in leaves.items()}
        assert set(flat) == set(want_flat)
        for k, v in want_flat.items():
            np.testing.assert_array_equal(flat[k], v, err_msg=k)
    cell = FlaxRNN(5, 7, "gru")
    cell.load_state_dict(torch_gru_params(sd, "rnn", 0))
    one = torch.nn.GRU(5, 7, batch_first=True)
    one.load_state_dict({k: v for k, v in gru.state_dict().items()
                         if k.endswith("_l0")})
    x = torch.randn(3, 6, 5, generator=g)
    with torch.no_grad():
        assert (cell(x) - one(x)[0]).abs().max() <= 1e-6


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_synthetic_corpus(str(tmp_path_factory.mktemp("corpus")),
                                  3.0, 1.0, seed=1, min_seconds=0.3,
                                  max_seconds=0.9)


def test_precompute_feats_matches_jax(corpus, tmp_path):
    wav_root, data_cfg = corpus
    wk = {"regr": [dict(WK["regr"][0], name=n) for n in
                   ("mfcc", "fbank", "prosody")], "cls": []}
    _, wk_path = _write_cfgs(tmp_path, wk=wk)
    out, jout = str(tmp_path / "feats"), str(tmp_path / "jfeats")
    util_scripts.main(["precompute-feats", "--device", "cpu", "--net_cfg",
                       wk_path, "--data_root", wav_root, "--data_cfg",
                       data_cfg, "--out_dir", out])
    jax_util.precompute_feats(argparse.Namespace(
        net_cfg=wk_path, data_root=wav_root, wav_list=None,
        data_cfg=data_cfg, out_dir=jout, hop=160, overwrite=False))
    files = sorted(os.listdir(jout))
    assert sorted(os.listdir(out)) == files and len(files) > 5
    for f in files:
        with np.load(os.path.join(out, f)) as a, \
                np.load(os.path.join(jout, f)) as b:
            assert set(a.files) == set(b.files)
            for k in b.files:
                assert a[k].shape == b[k].shape, (f, k)
                assert rel_err(a[k], b[k]) <= REL, (f, k, rel_err(a[k],
                                                                  b[k]))


def test_eval_ckpts_matches_jax(tmp_path, monkeypatch):
    """The port's eval-ckpts CLI and the JAX one over the same FE_e*.npz,
    the port's workers given JAX's init: the same JSON within 1e-5."""
    from pase_tpu.trainer import Trainer as JaxTrainer
    from pase_tpu_torch.checkpoint import load_model_variables
    from pase_tpu_torch.trainer import Trainer
    fe_path, wk_path = _write_cfgs(tmp_path)
    ckpts = tmp_path / "run"
    for e, seed in enumerate((1, 2)):
        enc = frontend.wf_builder(FE, device="cpu", seed=seed)
        _random_stats(enc.module, seed)
        save_variables_npz(str(ckpts / f"FE_e{e}.npz"),
                           enc.module.state_dict())
    states = []
    orig_init = JaxTrainer.init_state

    def recording(self, seed=0):
        states.append(orig_init(self, seed))
        return states[-1]

    monkeypatch.setattr(JaxTrainer, "init_state", recording)
    common = dict(fe_cfg=fe_path, net_cfg=wk_path, ckpt_dir=str(ckpts),
                  data_root=None, data_cfg=None, batch_size=8,
                  chunk_size=4800, n_batches=2, synthetic=True)
    jax_util.eval_ckpts(argparse.Namespace(
        out_file=str(tmp_path / "jax.json"),
        save_path=str(tmp_path / "jlog"), **common))
    flat = {f"{col}/{k}": np.asarray(v) for col in ("params", "batch_stats")
            for k, v in flatten_dict(unfreeze(getattr(
                states[0], col)), sep="/").items()}
    orig_port = Trainer.__init__

    def jax_init(self, *a, **k):
        orig_port(self, *a, **k)
        load_model_variables(self.model, flat)

    monkeypatch.setattr(Trainer, "__init__", jax_init)
    util_scripts.main(["eval-ckpts", "--device", "cpu", "--fe_cfg", fe_path,
                       "--net_cfg", wk_path, "--ckpt_dir", str(ckpts),
                       "--batch_size", "8", "--chunk_size", "4800",
                       "--n_batches", "2", "--synthetic", "--save_path",
                       str(tmp_path / "plog"), "--out_file",
                       str(tmp_path / "port.json")])
    with open(tmp_path / "port.json") as f, open(tmp_path / "jax.json") as g:
        got, want = json.load(f), json.load(g)
    assert list(got) == list(want) == ["FE_e0.npz", "FE_e1.npz"]
    assert got["FE_e0.npz"] != got["FE_e1.npz"]
    for k, v in want.items():
        assert abs(got[k] - v) <= REL * abs(v), (k, got[k], v)


@pytest.mark.parametrize("bare", [True, False], ids=["bare", "stack"])
def test_profile_step_prints_jax_keys(tmp_path, capsys, bare):
    fe_path, wk_path = _write_cfgs(tmp_path)
    out = util_scripts.main(["profile-step", "--device", "cpu", "--fe_cfg",
                             fe_path, "--net_cfg", wk_path, "--batch_size",
                             "4", "--chunk_size", "4800", "--n_meas", "2"]
                            + (["--bare"] if bare else []))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert set(line) == {"prepare_ms", "step_ms", "model_opt_ms",
                         "steps_per_sec", "audio_sec_per_sec"}
    assert line["step_ms"] > line["prepare_ms"] > 0
    assert abs(line["steps_per_sec"] * line["step_ms"] / 1e3 - 1) < 1e-2
