"""The port's downstream probes (pase_tpu_torch/probes, utils.py,
run_probe.py) against the JAX package's on the CPU.

Tolerances: the extractors within 1e-5 of max|y| (the same npz weights,
float32 convolutions summed in other orders); the MLP and recurrent heads
from bridged flax weights within 1e-5 of max|y| (train-mode outputs over
three SGD steps, then eval); ``fit`` against ``train_mlp_probe`` from the
same init over three epochs: every parameter and running statistic within
1e-4 of its leaf's largest (a bias that feeds a BatchNorm, whose
gradient is rounding noise, within 1e-6), the same dev errors and lr
halvings;
``context_window``, ``speaker_mean_norm``, ``kfold_data``, the class
datasets, ``sentence_accuracy`` and ``knn_classify`` equal; the four task
runners' classifier inputs within 1e-5 of their largest (features after
the global normalization times its std, and the statistics themselves
within 1e-5 of the largest std), labels equal. The data of the discrete outcomes is built
so that no decision sits at a tie, and the tests check it."""

import json
import os
import pickle
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pase_tpu import frontend as jax_frontend
from pase_tpu import utils as jax_utils
from pase_tpu.checkpoint import save_variables
from pase_tpu.data import dataset as jax_dataset
from pase_tpu.data.io import write_wav
from pase_tpu.probes import classifier as jc
from pase_tpu.probes import extract as jx
from pase_tpu.probes import tasks as jt
from pase_tpu_torch import utils as port_utils
from pase_tpu_torch.data import dataset as port_dataset
from pase_tpu_torch.probes import classifier as pc
from pase_tpu_torch.probes import extract as px
from pase_tpu_torch.probes import tasks as pt
from test_probes import SMALL_FE, synth_corpus  # noqa: F401
from torch_port_common import NARROW_CFG, PASEP_CFG, jax_variables, rel_err
from torch_port_common import port_test_guard  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the narrow encoder at PASE+'s 160x frame rate, with its QRNN
FC_CFG = dict(NARROW_CFG, strides=[1, 10, 4, 4])
# padded to the 8000-sample bucket; ceil(7300 / 160) = 46 frames
EXTRACT_LEN = 7300
EXTRACT_REL = 1e-5
HEAD_REL = 1e-5
FIT_REL = 1e-4
TASK_REL = 1e-5
# a Dense bias that feeds a BatchNorm (in the MLP of test_fit_...)
BN_CANCELLED = {"dense.0.bias"}


def _perturb(variables, seed, scale=0.1):
    """Every leaf of a flax variable tree plus seeded noise (biases and
    running statistics away from their 0 / 1 inits); variances kept
    positive."""
    rng = np.random.RandomState(seed)

    def one(path, v):
        v = np.asarray(v)
        if path[-1].key == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, v.shape)
                               .astype(np.float32))
        return jnp.asarray((v + rng.randn(*v.shape) * scale)
                           .astype(np.float32))
    return jax.tree_util.tree_map_with_path(one, variables)


def _torch_leaves(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


# ---------------------------------------------------------------------------
# feature extraction
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def extractors(tmp_path_factory):
    """{name: (JAX extractor, port extractor)} on the same npz weights:
    the narrow cfg with a QRNN, and PASE+ at full width."""
    root = tmp_path_factory.mktemp("fe")
    out = {}
    for i, (name, cfg) in enumerate((("narrow", FC_CFG),
                                     ("pase+", PASEP_CFG))):
        ckpt = str(root / f"FE_e{i}.npz")
        save_variables(ckpt, jax_variables(jax_frontend.build_wavefe(cfg),
                                           8000, seed=3 + i))
        out[name] = (jx.FeatureExtractor(cfg, ckpt),
                     px.FeatureExtractor(cfg, ckpt, device="cpu"))
    return out


def _wav(seed=0, n=EXTRACT_LEN):
    return (np.random.RandomState(seed).randn(n) * 0.1).astype(np.float32)


@pytest.mark.parametrize("mode", [None, "avg_concat", "avg_norm"])
@pytest.mark.parametrize("name", ["narrow", "pase+"])
def test_extractor_matches_jax(extractors, name, mode):
    jex, pex = extractors[name]
    jex.mode = pex.mode = mode
    want, got = jex.extract(_wav()), pex.extract(_wav())
    width = pex.encoder.emb_dim * (2 if mode == "avg_concat" else 1)
    assert got.shape == want.shape == (46, width)
    assert rel_err(got, want) <= EXTRACT_REL, rel_err(got, want)


def test_extractor_trims_before_the_mode(extractors):
    """The avg_concat statistics see the utterance's frames only: the
    global half is the mean of the trimmed frames."""
    _, pex = extractors["narrow"]
    pex.mode = None
    frames = pex.extract(_wav())
    pex.mode = "avg_concat"
    y = pex.extract(_wav())
    np.testing.assert_allclose(y[:, frames.shape[1]:],
                               np.broadcast_to(frames.mean(axis=0),
                                               frames.shape), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("mode", [None, "avg_concat"])
@pytest.mark.parametrize("feature_type", ["mfcc", "fbank"])
def test_baseline_features_match_jax(feature_type, mode):
    want = jx.FeatureExtractor(None, mode=mode,
                               feature_type=feature_type).extract(_wav(1))
    got = px.FeatureExtractor(None, mode=mode, feature_type=feature_type,
                              device="cpu").extract(_wav(1))
    assert got.shape == want.shape and got.shape[0] == EXTRACT_LEN // 160
    assert rel_err(got, want) <= EXTRACT_REL, rel_err(got, want)


def test_extractor_without_a_card_refuses():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        px.FeatureExtractor(FC_CFG)


def test_context_window_and_speaker_mean_norm_match_jax():
    rng = np.random.RandomState(2)
    f = rng.randn(9, 4).astype(np.float32)
    for left, right in ((0, 0), (1, 1), (2, 3), (8, 8)):
        np.testing.assert_array_equal(pc.context_window(f, left, right),
                                      jc.context_window(f, left, right))
    feats = {f"u{i}": rng.randn(5 + i, 3) for i in range(5)}
    utt2spk = {f"u{i}": f"s{i % 2}" for i in range(5)}
    want = jx.speaker_mean_norm(feats, utt2spk)
    got = px.speaker_mean_norm(feats, utt2spk)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("folds,valid_p,seed", [(10, 0.1, 0), (3, 0.0, 4),
                                                (5, 0.25, 7)])
def test_kfold_data_matches_jax(folds, valid_p, seed):
    items = [f"u{i:02d}" for i in range(37)]
    utt2class = {u: f"c{i % 4}" for i, u in enumerate(items)}
    assert port_utils.kfold_data(items, utt2class, folds, valid_p, seed) \
        == jax_utils.kfold_data(items, utt2class, folds, valid_p, seed)


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------


def _jax_sgd_steps(model, variables, batches, lr):
    """flax train-mode SGD steps as train_mlp_probe takes them; returns
    (variables, [train-mode outputs])."""
    params, stats = variables["params"], variables["batch_stats"]
    outs = []
    for x, y in batches:
        def loss_fn(p):
            out, ups = model.apply({"params": p, "batch_stats": stats},
                                   jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
            nll = -jnp.mean(jnp.take_along_axis(
                out, jnp.asarray(y)[:, None], axis=1))
            return nll, (ups["batch_stats"], out)
        (_, (stats, out)), g = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        params = jax.tree.map(lambda p, gg: p - lr * gg, params, g)
        outs.append(np.asarray(out))
    return {"params": params, "batch_stats": stats}, outs


def _port_sgd_steps(model, batches, lr):
    outs = []
    params = list(model.parameters())
    model.train()
    for x, y in batches:
        out = model(torch.from_numpy(x))
        nll = -out.gather(1, torch.from_numpy(y).long()[:, None]).mean()
        grads = torch.autograd.grad(nll, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(lr * g)
        outs.append(out.detach().numpy())
    return outs


def test_mlp_classifier_matches_jax_in_train_and_eval():
    """Bridged flax weights (biases and running stats perturbed), three
    SGD steps in train mode (batch statistics, flax's running update),
    then eval on fresh data: the running variance is flax's biased one."""
    d, classes, hidden = 8, 4, (16, 12)
    rng = np.random.RandomState(0)
    jm = jc.MLPClassifier(num_classes=classes, hidden=hidden)
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.zeros((2, d))), 1)
    pm = pc.mlp_from_jax(v, pc.MLPClassifier(d, classes, hidden))
    batches = [(rng.randn(32, d).astype(np.float32),
                rng.randint(0, classes, 32).astype(np.int32))
               for _ in range(3)]
    v_after, want = _jax_sgd_steps(jm, v, batches, 0.1)
    got = _port_sgd_steps(pm, batches, 0.1)
    for g, w in zip(got, want):
        assert rel_err(g, w) <= HEAD_REL, rel_err(g, w)
    x = rng.randn(20, d).astype(np.float32)
    want = np.asarray(jm.apply(v_after, jnp.asarray(x), train=False))
    got = pc.predict(pm, x).numpy()
    assert rel_err(got, want) <= HEAD_REL, rel_err(got, want)
    for i in range(len(hidden)):
        for jk, pk in (("mean", "running_mean"), ("var", "running_var")):
            w = np.asarray(v_after["batch_stats"][f"bn_{i}"][jk])
            g = getattr(pm.bn[i], pk).numpy()
            assert rel_err(g, w) <= HEAD_REL, (i, jk, rel_err(g, w))


@pytest.mark.parametrize("cell", ["gru", "lstm", "ligru"])
def test_rnn_classifier_matches_jax(cell):
    d, classes = 8, 3
    x = np.random.RandomState(0).randn(2, 20, d).astype(np.float32)
    jm = jc.RNNClassifier(num_classes=classes, hidden=16, layers=2,
                          cell_type=cell)
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    pm = pc.rnn_classifier_from_jax(
        v, pc.RNNClassifier(d, classes, hidden=16, layers=2,
                            cell_type=cell))
    got = pc.predict(pm, x).numpy()
    assert got.shape == want.shape == (2, 20, classes)
    assert rel_err(got, want) <= HEAD_REL, rel_err(got, want)
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, atol=1e-5)


def _fit_data():
    """Three well-separated clusters; a tenth of the dev labels flipped,
    so the dev error settles above 0 and the lr halves. Returns
    (train_x, train_y, dev_x, dev_y)."""
    rng = np.random.RandomState(3)
    centers = rng.randn(3, 6) * 4.0
    y = rng.randint(0, 3, 600)
    x = centers[y] + rng.randn(600, 6) * 0.3
    yd = rng.randint(0, 3, 150)
    xd = centers[yd] + rng.randn(150, 6) * 0.3
    flip = rng.rand(150) < 0.1
    yd = np.where(flip, (yd + 1) % 3, yd)
    return (x.astype(np.float32), y.astype(np.int32),
            xd.astype(np.float32), yd.astype(np.int32))


def _log_columns(lines):
    """[(dev_err, lr)] strings of the per-epoch log lines."""
    return [re.search(r"dev_err (\S+) lr (\S+)", l).groups() for l in lines]


def test_fit_matches_jax_train_mlp_probe():
    x, y, xd, yd = _fit_data()
    seed, hidden, kw = 5, (16,), dict(epochs=3, lr=0.1, batch_size=64)
    jlog, plog = [], []
    jvars, jmetrics = jc.train_mlp_probe(x, y, xd, yd, num_classes=3,
                                         hidden=hidden, seed=seed,
                                         log=jlog.append, **kw)
    # the init train_mlp_probe draws, bridged
    key = jax.random.PRNGKey(seed)
    init = jc.MLPClassifier(num_classes=3, hidden=hidden).init(
        {"params": key, "dropout": key}, jnp.zeros((2, 6)), train=False)
    pm = pc.mlp_from_jax(init, pc.build_mlp_probe(6, 3, hidden, seed=seed,
                                                  device="cpu"))
    pmetrics = pc.fit(pm, x, y, xd, yd, seed=seed, log=plog.append, **kw)
    assert pmetrics == jmetrics
    cols = _log_columns(plog)
    assert cols == _log_columns(jlog)
    assert float(cols[-1][1]) < float(cols[0][1])       # the lr halved
    assert 0 < jmetrics["dev_frame_error"] < 0.5
    # no dev decision at a tie: the top-2 log-posterior margin
    out = np.sort(np.asarray(jvars["model"].apply(
        {"params": jvars["params"], "batch_stats": jvars["batch_stats"]},
        jnp.asarray(xd), train=False)), axis=1)
    assert (out[:, -1] - out[:, -2]).min() > 1e-2
    want = pc.mlp_from_jax(
        {k: jvars[k] for k in ("params", "batch_stats")},
        pc.build_mlp_probe(6, 3, hidden, device="cpu"))
    got = _torch_leaves(pm)
    for k, w in _torch_leaves(want).items():
        if k in BN_CANCELLED:
            # the norm removes this bias: its gradient is rounding noise
            # about 0 (about 1e-10 here) in both packages
            assert np.abs(got[k] - w).max() <= 1e-6, k
            continue
        assert np.abs(got[k] - w).max() <= FIT_REL * np.abs(w).max(), k


def test_fit_with_dropout_eval_ignores_it():
    """With dropout the masks are the port's own: train-mode outputs vary
    from call to call, eval outputs do not, and the results are finite."""
    x, y, xd, yd = _fit_data()
    model, metrics = pc.train_mlp_probe(x, y, xd, yd, num_classes=3,
                                        hidden=(16,), epochs=2,
                                        batch_size=64, dropout=0.5,
                                        device="cpu")
    assert all(np.isfinite(v) for v in metrics.values())
    a, b = pc.predict(model, xd), pc.predict(model, xd)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    model.train()
    with torch.no_grad():
        t = torch.from_numpy(xd)
        assert not torch.equal(model(t), model(t))


def test_sentence_accuracy_matches_jax():
    d, classes = 6, 3
    rng = np.random.RandomState(4)
    jm = jc.MLPClassifier(num_classes=classes, hidden=(16,))
    v = _perturb(jm.init(jax.random.PRNGKey(1), jnp.zeros((2, d))), 5, 0.5)
    pm = pc.mlp_from_jax(v, pc.MLPClassifier(d, classes, (16,)))
    feats = [rng.randn(rng.randint(5, 30), d).astype(np.float32) * 2
             for _ in range(40)]
    labels = list(rng.randint(0, classes, 40))
    means = np.stack([np.asarray(jm.apply(v, jnp.asarray(f))).mean(0)
                      for f in feats])
    top = np.sort(means, axis=1)
    assert (top[:, -1] - top[:, -2]).min() > 1e-4           # no ties
    want = jc.sentence_accuracy({"model": jm, **v}, feats, labels)
    assert pc.sentence_accuracy(pm, feats, labels) == want
    assert 0 < want < 1


def test_knn_matches_jax():
    rng = np.random.RandomState(1)
    centers = rng.randn(3, 8) * 3
    ytr = rng.randint(0, 3, 300)
    xtr = (centers[ytr] + rng.randn(300, 8) * 1.5).astype(np.float32)
    xte = (centers[rng.randint(0, 3, 100)]
           + rng.randn(100, 8) * 1.5).astype(np.float32)
    d = np.sort(((xte[:, None] - xtr[None]) ** 2).sum(-1), axis=1)
    assert (d[:, 5] - d[:, 4]).min() > 1e-3      # the 5th and 6th differ
    for k in (1, 5):
        want = jc.knn_classify(xtr, ytr, xte, k=k)
        got = pc.knn_classify(xtr, ytr, xte, k=k, device="cpu")
        np.testing.assert_array_equal(got, want)


def test_knn_takes_the_lower_index_among_equal_distances():
    """Duplicated train points with other labels: both packages take the
    lower train index first (lax.top_k's order), and the lower class
    among equal votes."""
    xtr = np.array([[0, 0], [0, 0], [5, 5], [5, 5], [0, 0]], np.float32)
    ytr = np.array([2, 0, 1, 2, 1])
    xte = np.array([[0.1, 0], [5, 4.9], [2.5, 2.5]], np.float32)
    for k in (1, 2, 3):
        want = jc.knn_classify(xtr, ytr, xte, k=k, num_classes=3)
        got = pc.knn_classify(xtr, ytr, xte, k=k, num_classes=3,
                              device="cpu")
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("small") / "FE_e0.npz")
    save_variables(path, jax_variables(jax_frontend.build_wavefe(SMALL_FE),
                                       16000, seed=9))
    return path


def _capture(monkeypatch, module, name):
    """Record every call of module.name (it still runs)."""
    calls = []
    real = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(a)
        return real(*a, **k)
    monkeypatch.setattr(module, name, wrapped)
    return calls


def _capture_norms(monkeypatch, module):
    """Record the (mean, std) every _global_norm call returns."""
    out = []
    real = module._global_norm

    def wrapped(feats):
        out.append(real(feats))
        return out[-1]
    monkeypatch.setattr(module, "_global_norm", wrapped)
    return out


def _same_inputs(got, want, pnorms=None, jnorms=None):
    """The classifier calls' arrays: labels equal, features within
    TASK_REL of their largest. Features normalized by a call's global
    statistics are compared times the JAX std (in the encoder's units, so
    a dimension of small spread does not magnify the encoder's rounding);
    the statistics themselves within TASK_REL of the largest std."""
    assert len(got) == len(want)
    for i, (g_call, w_call) in enumerate(zip(got, want)):
        scale = 1.0
        if jnorms is not None:
            (pm, ps), (jm, js) = pnorms[i], jnorms[i]
            tol = TASK_REL * np.abs(js).max()
            assert np.abs(pm - jm).max() <= tol
            assert np.abs(ps - js).max() <= tol
            scale = js
        for g, w in zip(g_call, w_call):
            g, w = np.asarray(g), np.asarray(w)
            assert g.shape == w.shape
            if np.issubdtype(w.dtype, np.integer):
                np.testing.assert_array_equal(g, w)
            else:
                assert rel_err(g * scale, w * scale) <= TASK_REL, \
                    rel_err(g * scale, w * scale)


def _finite(metrics):
    return all(np.isfinite(v) for v in metrics.values())


def test_utt_classification_matches_jax(synth_corpus, small_ckpt,
                                        monkeypatch):
    args = (SMALL_FE, small_ckpt, str(synth_corpus / "train.lst"),
            str(synth_corpus / "test.lst"))
    kw = dict(data_root=str(synth_corpus), hidden=(32,), epochs=6, lr=0.05,
              batch_size=128, log=None)
    jcalls = _capture(monkeypatch, jt, "train_mlp_probe")
    pcalls = _capture(monkeypatch, pt, "train_mlp_probe")
    jnorms = _capture_norms(monkeypatch, jt)
    pnorms = _capture_norms(monkeypatch, pt)
    want = jt.run_utt_classification(*args, **kw)
    got = pt.run_utt_classification(*args, device="cpu", **kw)
    _same_inputs(pcalls, jcalls, pnorms, jnorms)
    assert set(got) == set(want)
    for m in (got, want):
        assert _finite(m) and m["test_sentence_acc"] > 0.5, m


def test_utt_classification_refuses_unseen_labels(synth_corpus,
                                                  tmp_path):
    """A test label the train list lacks raises before any extraction
    (the encoder's weights file does not exist)."""
    one = tmp_path / "one_class.lst"
    one.write_text("".join(l for l in open(synth_corpus / "train.lst")
                           if l.split()[1] == "spk0"))
    with pytest.raises(ValueError, match=r"absent from the train list: "
                                         r"\['spk1'\]"):
        pt.run_utt_classification(
            SMALL_FE, None, str(one), str(synth_corpus / "test.lst"),
            data_root=str(synth_corpus), log=None, device="cpu")


def test_knn_probe_matches_jax(synth_corpus, small_ckpt, monkeypatch):
    args = (SMALL_FE, small_ckpt, str(synth_corpus / "train.lst"),
            str(synth_corpus / "test.lst"))
    jcalls = _capture(monkeypatch, jt, "knn_classify")
    pcalls = _capture(monkeypatch, pt, "knn_classify")
    want = jt.run_knn_probe(*args, data_root=str(synth_corpus), k=3,
                            log=None)
    got = pt.run_knn_probe(*args, data_root=str(synth_corpus), k=3,
                           log=None, device="cpu")
    _same_inputs(pcalls, jcalls)
    assert got == want and got["knn_test_acc"] > 0.5


def _frame_lists(root):
    """Per-frame alignments (class = speaker) and *_frames.lst lists."""
    for split in ("train", "test"):
        lines = []
        for line in open(root / f"{split}.lst"):
            path, lab = line.split()
            alifile = path.replace(".wav", ".ali")
            np.savetxt(root / alifile,
                       np.full(16000 // 160, int(lab[-1]), np.int32),
                       fmt="%d")
            lines.append(f"{path} {alifile}\n")
        (root / f"{split}_frames.lst").write_text("".join(lines))


def test_frame_classification_matches_jax(synth_corpus, small_ckpt,
                                          monkeypatch):
    _frame_lists(synth_corpus)
    args = (SMALL_FE, small_ckpt, str(synth_corpus / "train_frames.lst"),
            str(synth_corpus / "test_frames.lst"))
    # one full batch a step: 30 epochs train each package's own init past
    # chance on these (unnormalized) features
    kw = dict(data_root=str(synth_corpus), num_classes=2, left=2, right=2,
              hidden=(32,), epochs=30, lr=0.05, log=None)
    # speakers of both classes (class = the synthetic speaker's f0), so
    # the speaker mean leaves the class in the frames
    utt2spk = {f"{s}_{u}.wav": f"{s}{u // 2}" for s, n in
               (("train", 8), ("test", 4)) for u in range(n)}
    jcalls = _capture(monkeypatch, jt, "train_mlp_probe")
    pcalls = _capture(monkeypatch, pt, "train_mlp_probe")
    for spk in (None, utt2spk):
        want = jt.run_frame_classification(*args, utt2spk=spk, **kw)
        got = pt.run_frame_classification(*args, utt2spk=spk, device="cpu",
                                          **kw)
        assert set(got) == set(want)
        for m in (got, want):
            assert _finite(m) and m["test_fer"] < 0.5, m
    _same_inputs(pcalls, jcalls)


@pytest.mark.parametrize("valid_p", [0.1, 0.0])
def test_kfold_classification_matches_jax(synth_corpus, small_ckpt,
                                          monkeypatch, valid_p):
    """valid_p 0.1 trains with a valid split per fold (lr halving on it);
    0.0 leaves none, and the test fold drives the halving."""
    combined = synth_corpus / "all.lst"
    combined.write_text("".join(open(synth_corpus / f"{s}.lst").read()
                                for s in ("train", "test")))
    kw = dict(data_root=str(synth_corpus), folds=3, valid_p=valid_p,
              hidden=(), epochs=8, lr=0.05, batch_size=256, log=None)
    jcalls = _capture(monkeypatch, jt, "train_mlp_probe")
    pcalls = _capture(monkeypatch, pt, "train_mlp_probe")
    jnorms = _capture_norms(monkeypatch, jt)
    pnorms = _capture_norms(monkeypatch, pt)
    want = jt.run_kfold_classification(SMALL_FE, small_ckpt, str(combined),
                                       **kw)
    got = pt.run_kfold_classification(SMALL_FE, small_ckpt, str(combined),
                                      device="cpu", **kw)
    _same_inputs(pcalls, jcalls, pnorms, jnorms)
    assert len(pcalls) == 3 and set(got) == set(want)
    for m in (got, want):
        assert _finite(m) and m["folds"] == 3, m
        assert m["sentence_acc_mean"] > 0.5, m


def test_posteriors_text_ark(tmp_path):
    d, classes = 5, 3
    jm = jc.MLPClassifier(num_classes=classes, hidden=(8,))
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 5 * d))), 3)
    pm = pc.mlp_from_jax(v, pc.MLPClassifier(5 * d, classes, (8,)))
    rng = np.random.RandomState(0)
    feats = {"spk1_a": rng.randn(7, d).astype(np.float32),
             "spk2_b": rng.randn(4, d).astype(np.float32)}
    priors = np.log(np.array([0.2, 0.3, 0.5], np.float32))
    jt.write_posteriors_ark({"model": jm, **v}, feats, priors,
                            str(tmp_path / "j.ark"), left=2, right=2)
    pt.write_posteriors_ark(pm, feats, priors, str(tmp_path / "p.ark"),
                            left=2, right=2)
    want = (tmp_path / "j.ark").read_text().split()
    got = (tmp_path / "p.ark").read_text().split()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g in ("[", "]") or g.startswith("spk"):
            assert g == w
        else:
            assert abs(float(g) - float(w)) <= 2e-6, (g, w)


# ---------------------------------------------------------------------------
# class datasets
# ---------------------------------------------------------------------------


@pytest.fixture
def class_tree(tmp_path):
    rng = np.random.RandomState(6)
    names = ["a.wav", "b.wav", "c.wav"]
    for i, (name, n) in enumerate(zip(names, (900, 4000, 2500))):
        write_wav(str(tmp_path / name), (rng.randn(n) * 0.1).astype(
            np.float32))
        np.save(tmp_path / name.replace(".wav", ".fb.npy"),
                rng.randn(10 + i, 4).astype(np.float32))
    u2c = {n: i % 2 for i, n in enumerate(names)}
    (tmp_path / "u2c.json").write_text(json.dumps(u2c))
    np.save(tmp_path / "u2c.npy", u2c)
    with open(tmp_path / "stats.pkl", "wb") as f:
        pickle.dump({"mean": rng.randn(4), "std": rng.uniform(1, 2, 4)}, f)
    (tmp_path / "split.lst").write_text("\n".join(names) + "\n\n")
    return tmp_path


@pytest.mark.parametrize("u2c", ["u2c.json", "u2c.npy"])
@pytest.mark.parametrize("stats", [None, "stats.pkl"])
def test_feats_class_dataset_matches_jax(class_tree, u2c, stats):
    args = (str(class_tree), str(class_tree / u2c),
            str(class_tree / "split.lst"))
    st = str(class_tree / stats) if stats else None
    want = jax_dataset.FeatsClassDataset(*args, stats=st)
    got = port_dataset.FeatsClassDataset(*args, stats=st)
    assert len(got) == len(want) == 3
    for i in range(3):
        (gx, gy), (wx, wy) = got[i], want[i]
        assert gy == wy and gx.dtype == wx.dtype
        np.testing.assert_array_equal(gx, wx)


@pytest.mark.parametrize("chunk_size", [None, 1600, 3000])
def test_wav_class_dataset_matches_jax(class_tree, chunk_size):
    args = (str(class_tree), str(class_tree / "u2c.json"),
            ["a.wav", "b.wav", "c.wav"])
    want = jax_dataset.WavClassDataset(*args, chunk_size=chunk_size, seed=3)
    got = port_dataset.WavClassDataset(*args, chunk_size=chunk_size, seed=3)
    for _ in range(2):
        for i in range(3):
            (gx, gy), (wx, wy) = got[i], want[i]
            assert gy == wy and gx.dtype == wx.dtype
            np.testing.assert_array_equal(gx, wx)


# ---------------------------------------------------------------------------
# the superviser and the CLI
# ---------------------------------------------------------------------------


def test_auxiliar_superviser_substitutes_and_reaps(tmp_path):
    cmds = tmp_path / "sup.cmds"
    cmds.write_text("# a comment\n\n"
                    "echo $iteration $model $cfg $save_path > "
                    "$save_path/out_$iteration.txt\n"
                    "exit 3\n")
    sup = port_utils.AuxiliarSuperviser(str(cmds), str(tmp_path))
    assert len(sup.cmds) == 2
    sup(4, "/ck/FE_e4.npz", "fe.cfg")
    assert len(sup.procs) == 2
    for p in sup.procs:
        p.wait()
    sup(5, "/ck/FE_e5.npz", "fe.cfg")      # reaps the first two
    assert len(sup.procs) == 2 and len(sup.finished) == 2
    done = sup.wait()
    assert [rc for _, rc in done] == [0, 3, 0, 3]
    assert sup.procs == []
    for e in (4, 5):
        assert (tmp_path / f"out_{e}.txt").read_text().split() == [
            str(e), f"/ck/FE_e{e}.npz", "fe.cfg", str(tmp_path)]


@pytest.mark.parametrize("sup_freq", [1, 2])
def test_trainer_fires_the_superviser_on_the_jax_schedule(tmp_path,
                                                          sup_freq):
    """(e + 1) % sup_freq == 0 or e + 1 >= epochs, after the epoch's
    FE_e{e}.npz is written (the command checks it exists)."""
    from pase_tpu_torch.data.dataset import DeviceSyntheticBatcher
    from pase_tpu_torch.trainer import Trainer
    from test_torch_train import BATCH, CHUNK, _cfg, small_workers
    from test_torch_train import SMALL_FE as TRAIN_FE
    cmds = tmp_path / "sup.cmds"
    cmds.write_text("test -f $model && echo $cfg > "
                    "$save_path/fired_$iteration\n")
    save = tmp_path / "run"
    cfg = dict(_cfg(save), bpe=1, epoch=3, log_freq=1, fe_cfg="fe.cfg",
               sup_exec=str(cmds), sup_freq=sup_freq)
    tr = Trainer(TRAIN_FE, small_workers(), cfg, device="cpu")
    tr.train_(DeviceSyntheticBatcher(BATCH, CHUNK, seed=1, device="cpu"),
              resume=False)
    tr.logger.close()
    assert all(rc == 0 for _, rc in tr.aux_sup.wait())
    want = [e for e in range(3) if (e + 1) % sup_freq == 0 or e + 1 >= 3]
    fired = sorted(int(f.name.split("_")[1])
                   for f in (save / "sup_aux").glob("fired_*"))
    assert fired == want
    assert (save / "sup_aux" / f"fired_{want[0]}").read_text() == "fe.cfg\n"


@pytest.fixture(scope="module")
def cli_corpus(synth_corpus, tmp_path_factory):
    """synth_corpus with frame lists, a combined list and the timit-full
    cfgs (no decoding scripts: the Kaldi stage is skipped)."""
    root = synth_corpus
    _frame_lists(root)
    (root / "all.lst").write_text("".join(open(root / f"{s}.lst").read()
                                          for s in ("train", "test")))
    (root / "fe.cfg").write_text(json.dumps(SMALL_FE))
    (root / "mlp.json").write_text(json.dumps(
        {"N_epochs": "2", "batch_size": "64", "lr": "0.05", "left": "1",
         "right": "1", "avg_spk": "False", "dnn_lay": "16,2",
         "dnn_drop": "0.0,0.0"}))
    (root / "dec.json").write_text(json.dumps(
        {"decoding_script_folder": str(root / "nowhere"),
         "decoding_script": "decode_dnn.sh"}))
    return root


CLI_TASKS = {
    "utt": (["--train_list", "train.lst", "--test_list", "test.lst",
             "--hidden", "16"], "test_sentence_acc"),
    "knn": (["--train_list", "train.lst", "--test_list", "test.lst",
             "--k", "3"], "knn_test_acc"),
    "frames": (["--train_list", "train_frames.lst", "--test_list",
                "test_frames.lst", "--num_classes", "2", "--left", "1",
                "--right", "1", "--hidden", "16"], "test_fer"),
    "kfold": (["--train_list", "all.lst", "--folds", "3"],
              "sentence_acc_mean"),
    "timit-full": (["--train_list", "train_frames.lst", "--test_list",
                    "test_frames.lst", "--mlp_cfg", "mlp.json",
                    "--dec_cfg", "dec.json", "--out_folder", "timit_out"],
                   "dev_frame_error")}


@pytest.mark.parametrize("task", list(CLI_TASKS))
def test_run_probe_cli_on_the_cpu(cli_corpus, task):
    flags, key = CLI_TASKS[task]
    out = cli_corpus / f"{task}.json"
    argv = ["--fe_cfg", "fe.cfg", "--data_root", str(cli_corpus),
            "--epochs", "2", "--device", "cpu", "--out", str(out)]
    proc = subprocess.run(
        [sys.executable, "-m", "pase_tpu_torch.run_probe", task] + argv
        + flags, cwd=cli_corpus, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    m = json.loads(out.read_text())
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == m
    assert 0.0 <= m[key] <= 1.0


def test_run_probe_platform_flag(cli_corpus, capsys):
    from pase_tpu_torch import run_probe
    base = ["knn", "--fe_cfg", str(cli_corpus / "fe.cfg"), "--train_list",
            str(cli_corpus / "train.lst"), "--test_list",
            str(cli_corpus / "test.lst"), "--data_root", str(cli_corpus)]
    m = run_probe.main(base + ["--platform", "cpu"])
    assert m == run_probe.main(base + ["--device", "cpu"])
    with pytest.raises(SystemExit):
        run_probe.main(base + ["--platform", "tpu"])
    assert "--platform tpu" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        run_probe.main(["utt", "--fe_cfg", "x", "--train_list", "y",
                        "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_probe.main(base)
