"""The port's util_scripts tools (clusterize with its kmeans,
project-features, prosodic-eval, make-fbanks, vadproc, make-contaminated,
select-ckpt, encode-codec2) against the root ``util_scripts.py`` of the
JAX package on the same files and weights, on the CPU.

Bounds: kmeans from JAX's initial indices gives JAX's assignments exactly
and its centres within 1e-5 of their largest (|x|^2 + |c|^2 - 2 x c^T and
the one-hot means summed in another order); the PCA projection within
1e-4 of max|proj| up to each component's sign (an eigenvector's sign is
arbitrary), the two eigenvalues apart by more than 1e-3 of the larger so
that the components are defined; prosodic-eval's JSON within 1e-4
relative; the fbank files within 1e-4 of each file's max|y| (the bound of
tests/test_torch_features.py); the contaminated wavs within one int16
step (with JAX's draws injected); the .vad files and select-ckpt's answer
equal."""

import argparse
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pase_tpu import frontend as jax_frontend
from pase_tpu.checkpoint import save_variables
from pase_tpu.parallel.mesh import get_mesh
from pase_tpu.trainer import Trainer as JaxTrainer
from pase_tpu_torch import util_scripts
from pase_tpu_torch.data import distortions as D
from pase_tpu_torch.data.io import read_wav, write_wav
from pase_tpu_torch.data.synthetic_corpus import write_synthetic_long_wavs
from pase_tpu_torch.trainer import Trainer
from test_torch_distortions import _write_cfg, jax_draws
from test_torch_train import _init_state
from torch_port_common import NARROW_CFG, jax_variables, rel_err
from torch_port_common import port_test_guard  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the narrow encoder at PASE+'s 160x frame rate, with its QRNN
FC_CFG = dict(NARROW_CFG, strides=[1, 10, 4, 4])
# the prosody head of the JAX CLI test (r = 7: the d-major layout)
PROSODY_WK = {"regr": [{"num_outputs": 12, "dropout": 0, "hidden_size": 32,
                        "hidden_layers": 1, "name": "prosody", "r": 7,
                        "loss": "MSELoss", "skip": False}], "cls": []}
# the first two cut to the same whole frames (one JAX compile for both)
LENGTHS = (7300, 7310, 11200, 4800)


def _jax_tools():
    sys.path.insert(0, REPO)
    import util_scripts as jax_tools
    return jax_tools


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Speech-like wavs of several lengths, their list, and the narrow
    encoder's cfg and seeded weights (an FE .npz both packages load)."""
    root = tmp_path_factory.mktemp("tools")
    wavs = root / "wavs"
    wavs.mkdir()
    rng = np.random.RandomState(0)
    names = []
    for i, n in enumerate(LENGTHS):
        t = np.arange(n) / 16000
        f0 = 110 + 40 * i
        y = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in range(1, 6))
        y = y * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)) * 0.2
        names.append(f"spk{i % 2}/u{i}.wav")
        os.makedirs(wavs / f"spk{i % 2}", exist_ok=True)
        write_wav(str(wavs / names[-1]),
                  (y + 0.01 * rng.randn(n)).astype(np.float32))
    lst = root / "wavs.lst"
    lst.write_text("".join(f"{n} extra-column\n" for n in names) + "\n")
    cfg = str(root / "fe.cfg")
    with open(cfg, "w") as f:
        json.dump(FC_CFG, f)
    ckpt = str(root / "FE_e0.npz")
    save_variables(ckpt, jax_variables(jax_frontend.build_wavefe(FC_CFG),
                                       8000, seed=3))
    return argparse.Namespace(root=root, wavs=str(wavs), lst=str(lst),
                              names=names, cfg=cfg, ckpt=ckpt)


def _opts(argv):
    return util_scripts.build_parser().parse_args(argv)


def _three_clusters(seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(3, 8) * 5
    return np.concatenate([centers[i] + rng.randn(50, 8) * 0.2
                           for i in range(3)]).astype(np.float32)


def _jax_init(n, k, seed=0):
    """The initial centres' rows of the JAX kmeans(x, k, seed=seed)."""
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (k,),
                                        replace=False))


@pytest.mark.parametrize("case", ["three_clusters", "overlapping"])
def test_kmeans_matches_jax_from_its_indices(case):
    if case == "three_clusters":
        x, k, iters = _three_clusters(), 3, 20
    else:
        x = np.random.RandomState(1).randn(400, 16).astype(np.float32)
        k, iters = 12, 30
    want_c, want_a = _jax_tools().kmeans(jnp.asarray(x), k=k, iters=iters)
    got_c, got_a = util_scripts.kmeans(torch.from_numpy(x), k, iters=iters,
                                       init_idx=_jax_init(len(x), k))
    np.testing.assert_array_equal(got_a, np.asarray(want_a))
    assert rel_err(got_c, np.asarray(want_c)) <= 1e-5


def test_kmeans_recovers_clusters_from_its_own_draw():
    """tests/test_cli_scripts.py's test_kmeans with the port's seeded
    initial draw; an empty cluster keeps its centre."""
    x = _three_clusters()
    c, a = util_scripts.kmeans(torch.from_numpy(x), k=3, iters=20)
    for i in range(3):
        seg = a[i * 50:(i + 1) * 50]
        assert (seg == np.bincount(seg).argmax()).mean() > 0.95
    # two identical initial centres: the second gets no rows and stays
    init = np.array([0, 0, 60])
    c, a = util_scripts.kmeans(torch.from_numpy(x), 3, iters=1,
                               init_idx=init)
    assert (a != 1).all()
    np.testing.assert_array_equal(c[1], x[0])


def test_kmeans_lockstep_differs_only_at_rounding_ties(capsys):
    """chip_smoke.py's card-vs-CPU rule for clusterize, with the other
    side's rows the same rows with their columns in another order (so its
    sums run in another order, as on the card): the whole runs may part,
    but replayed side by side every difference is a rounding tie and the
    other side's replay is its own kmeans."""
    import chip_smoke
    rng = np.random.RandomState(0)
    x = (rng.randn(8000, 64) * 0.3 + rng.randn(8000, 1)
         + rng.randn(1, 64)).astype(np.float32)
    k = 32
    init = util_scripts.kmeans_init(len(x), k)
    xc = torch.from_numpy(x)
    xp = xc[:, torch.randperm(64, generator=torch.Generator().manual_seed(3))]
    xp = xp.contiguous()
    _, a = util_scripts.kmeans(xc, k, iters=chip_smoke.KMEANS_ITERS,
                               init_idx=init)
    _, ap = util_scripts.kmeans(xp, k, iters=chip_smoke.KMEANS_ITERS,
                                init_idx=init)
    replay, ties, outside = chip_smoke._kmeans_lockstep(xc, xp, init)
    print(f"whole runs apart on {int((a != ap).sum())} rows; replayed: "
          f"{ties} row-steps at ties, {outside} outside")
    assert outside == 0
    np.testing.assert_array_equal(replay, ap)


def test_clusterize_matches_jax(corpus, tmp_path, capsys):
    argv = ["--fe_cfg", corpus.cfg, "--fe_ckpt", corpus.ckpt, "--wav_list",
            corpus.lst, "--data_root", corpus.wavs, "--k", "6"]
    port_out, jax_out = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    _jax_tools().clusterize(argparse.Namespace(
        fe_cfg=corpus.cfg, fe_ckpt=corpus.ckpt, wav_list=corpus.lst,
        data_root=corpus.wavs, k=6, max_utts=None, out_file=jax_out))
    want_line = capsys.readouterr().out
    want = np.load(jax_out)
    n = len(want["assignments"])
    assert n == sum(-(-t // 160) for t in LENGTHS)
    util_scripts.clusterize(_opts(["clusterize", "--device", "cpu"] + argv
                                  + ["--out_file", port_out]),
                            init_idx=_jax_init(n, 6))
    assert capsys.readouterr().out == want_line
    got = np.load(port_out)
    assert sorted(got.files) == sorted(want.files)
    np.testing.assert_array_equal(got["assignments"], want["assignments"])
    assert rel_err(got["centers"], want["centers"]) <= 1e-5
    # the CLI with its own seeded draw, two utterances
    util_scripts.main(["clusterize", "--device", "cpu", "--max_utts", "2",
                       "--out_file", port_out] + argv)
    got = np.load(port_out)
    assert got["centers"].shape == (6, FC_CFG["emb_dim"])
    assert got["assignments"].shape == (sum(-(-t // 160)
                                            for t in LENGTHS[:2]),)
    assert capsys.readouterr().out.startswith("KMeans k=6: inertia counts")


def test_project_features_matches_jax(corpus, tmp_path, capsys):
    opts = dict(fe_cfg=corpus.cfg, fe_ckpt=corpus.ckpt, wav_list=corpus.lst,
                data_root=corpus.wavs, n_components=2, max_utts=3)
    _jax_tools().project_features(argparse.Namespace(
        out_file=str(tmp_path / "j.npy"), **opts))
    want_line = capsys.readouterr().out
    proj, w = util_scripts.main([
        "project-features", "--device", "cpu", "--fe_cfg", corpus.cfg,
        "--fe_ckpt", corpus.ckpt, "--wav_list", corpus.lst, "--data_root",
        corpus.wavs, "--max_utts", "3", "--out_file",
        str(tmp_path / "p.npy")])
    assert capsys.readouterr().out == want_line
    want = np.load(tmp_path / "j.npy")
    got = np.load(tmp_path / "p.npy")
    np.testing.assert_array_equal(got, proj)
    assert got.shape == want.shape == (sum(-(-t // 160)
                                           for t in LENGTHS[:3]), 2)
    top = w[::-1]
    assert top[0] - top[1] > 1e-3 * top[0] and top[1] - top[2] > 1e-3 * top[1]
    for c in range(2):
        sign = np.sign(np.dot(got[:, c], want[:, c]))
        err = np.abs(sign * got[:, c] - want[:, c]).max()
        assert err <= 1e-4 * np.abs(want).max(), (c, err)


@pytest.fixture(scope="module")
def prosody_ckpts(tmp_path_factory):
    """{source: (weights_PASE-*.npz, cfg dir)}: the port trainer's after
    one step, and JAX's at its (jitted) init."""
    root = tmp_path_factory.mktemp("prosody")
    fe = {"kwidths": [65, 10, 5, 5], "strides": [1, 10, 4, 4],
          "fmaps": [16, 16, 32, 32], "emb_dim": 32, "norm_out": True}
    cfg = dict(backprop_mode="base", hop=160, bpe=1, epoch=1, batch_size=4,
               chunk_size=3200, log_freq=1, fe_lr=5e-4, min_lr=5e-4,
               lr_mode="poly")
    for name, c in (("fe.cfg", fe), ("wk.cfg", PROSODY_WK)):
        with open(root / name, "w") as f:
            json.dump(c, f)
    rng = np.random.RandomState(2)
    with open(root / "stats.pkl", "wb") as f:
        pickle.dump({"prosody": {
            "mean": rng.randn(12).astype(np.float32),
            "std": rng.uniform(0.5, 2.0, 12).astype(np.float32)}}, f)
    tr = Trainer(fe, PROSODY_WK, dict(cfg, save_path=str(root / "port")),
                 device="cpu")
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    tr.train_step(next(iter(SyntheticChunkBatcher(4, 3200, seed=1))))
    tr.save(0)
    tr.logger.close()
    jtr = JaxTrainer(fe, PROSODY_WK, dict(cfg, save_path=str(root / "jax")),
                     mesh=get_mesh(devices=jax.devices()[:1]))
    jtr.save(_init_state_for(jtr), 0)
    return {"port": str(root / "port" / "weights_PASE-Pase_base-1.npz"),
            "jax": str(root / "jax" / "weights_PASE-Pase_base-0.npz"),
            "root": root}


def _init_state_for(jtr):
    """test_torch_train's jitted init at this trainer's chunk."""
    import test_torch_train
    old = test_torch_train.CHUNK
    test_torch_train.CHUNK = 3200
    try:
        return _init_state(jtr)
    finally:
        test_torch_train.CHUNK = old


@pytest.mark.parametrize("source", ["port", "jax"])
def test_prosodic_eval_matches_jax(corpus, prosody_ckpts, source, tmp_path,
                                   capsys):
    ckpt, root = prosody_ckpts[source], prosody_ckpts["root"]
    assert os.path.exists(ckpt)
    opts = dict(fe_cfg=str(root / "fe.cfg"), net_cfg=str(root / "wk.cfg"),
                ckpt=ckpt, wav_list=corpus.lst, data_root=corpus.wavs,
                stats=str(root / "stats.pkl"), max_utts=2)
    want = _jax_tools().prosodic_eval(argparse.Namespace(
        out_file=str(tmp_path / "j.json"), **opts))
    capsys.readouterr()
    got = util_scripts.main([
        "prosodic-eval", "--device", "cpu", "--fe_cfg", opts["fe_cfg"],
        "--net_cfg", opts["net_cfg"], "--ckpt", ckpt, "--wav_list",
        corpus.lst, "--data_root", corpus.wavs, "--stats", opts["stats"],
        "--max_utts", "2", "--out_file", str(tmp_path / "p.json")])
    assert json.loads(capsys.readouterr().out) == got
    with open(tmp_path / "p.json") as f:
        assert json.load(f) == got
    assert list(got) == list(want) == ["lf0_rmse", "egy_rmse", "zcr_rmse",
                                       "uv_acc", "n_utts"]
    assert got["n_utts"] == want["n_utts"] == 2
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-4 * abs(v), (k, got[k], v)


def test_make_fbanks_matches_jax(corpus, tmp_path, capsys):
    _jax_tools().make_fbanks(argparse.Namespace(
        wav_list=corpus.lst, data_root=corpus.wavs,
        out_dir=str(tmp_path / "j"), n_filters=24))
    want_line = capsys.readouterr().out.replace(str(tmp_path / "j"), "<out>")
    util_scripts.main(["make-fbanks", "--device", "cpu", "--wav_list",
                       corpus.lst, "--data_root", corpus.wavs, "--out_dir",
                       str(tmp_path / "p"), "--n_filters", "24"])
    assert capsys.readouterr().out.replace(str(tmp_path / "p"),
                                           "<out>") == want_line
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "p")) == [
        f"u{i}.npy" for i in range(len(LENGTHS))]
    for f, n in zip(files, LENGTHS):
        want, got = np.load(tmp_path / "j" / f), np.load(tmp_path / "p" / f)
        assert got.shape == want.shape == (n // 160, 72)
        assert rel_err(got, want) <= 1e-4, f


def test_vadproc_matches_jax(tmp_path, capsys):
    names = write_synthetic_long_wavs(str(tmp_path / "wavs"), n_files=3,
                                      seconds=8.0, seed=4)
    lst = tmp_path / "w.lst"
    lst.write_text("\n".join(names))
    for side, thresh in (("j", -40.0), ("p", -40.0), ("j25", -25.0),
                         ("p25", -25.0)):
        opts = dict(wav_list=str(lst), data_root=str(tmp_path / "wavs"),
                    out_dir=str(tmp_path / side), thresh_db=thresh)
        if side.startswith("j"):
            _jax_tools().vadproc(argparse.Namespace(**opts))
        else:
            util_scripts.main(["vadproc", "--wav_list", str(lst),
                               "--data_root", opts["data_root"], "--out_dir",
                               opts["out_dir"], "--thresh_db", str(thresh)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].replace(str(tmp_path / "j"), "<out>") == \
        lines[1].replace(str(tmp_path / "p"), "<out>")
    n_regions = 0
    for j, p in (("j", "p"), ("j25", "p25")):
        files = sorted(os.listdir(tmp_path / j))
        assert files == sorted(os.listdir(tmp_path / p)) and len(files) == 3
        for f in files:
            want = (tmp_path / j / f).read_text()
            assert (tmp_path / p / f).read_text() == want
            n_regions += len(want.splitlines())
    assert n_regions > 6


def test_select_ckpt_matches_jax(tmp_path, capsys):
    for i, v in enumerate([0.5, 0.75, None, 0.75, 0.25]):
        m = {"test_sentence_acc": v} if v is not None else {"other": 1.0}
        m["test_loss"] = 1.0 - i / 10
        (tmp_path / f"m{i}.json").write_text(json.dumps(m))
    for metric in ("test_sentence_acc", "test_loss", "absent"):
        argv = ["--metrics_glob", str(tmp_path / "m*.json"), "--metric",
                metric]
        _jax_tools().select_ckpt(argparse.Namespace(
            metrics_glob=argv[1], metric=metric, maximize=True))
        want = capsys.readouterr().out
        got = util_scripts.main(["select-ckpt"] + argv)
        assert capsys.readouterr().out == want
        assert json.loads(want) == got
    assert _opts(["select-ckpt", "--metrics_glob", "x"]).maximize is True


def _jax_make_contaminated(wav_list, data_root, out_dir, dtrans_cfg,
                           chunk_size, seed):
    """The loop of the JAX ``util_scripts.make_contaminated``, which cannot
    run as it stands: it unpacks the three values of the root
    ``train.build_distortions`` (cfg, assets, host stage) into two. Each
    wav cut to whole frames, distorted with split(key)'s subkey in list
    order, written with the JAX package's write_wav."""
    import train as jax_train
    from pase_tpu.data.distortions import apply_distortions
    from pase_tpu.data.io import read_wav as jax_read_wav
    from pase_tpu.data.io import write_wav as jax_write_wav
    cfg, assets, _ = jax_train.build_distortions(
        argparse.Namespace(dtrans_cfg=[dtrans_cfg]), chunk_size)
    os.makedirs(out_dir, exist_ok=True)
    with open(wav_list) as f:
        paths = [ln.split()[0] for ln in f if ln.strip()]
    key = jax.random.PRNGKey(seed)
    for p in paths:
        wav, sr = jax_read_wav(os.path.join(data_root, p))
        t = (len(wav) // 160) * 160
        key, sub = jax.random.split(key)
        y, _ = apply_distortions(jnp.asarray(wav[None, :t]), sub, cfg,
                                 assets)
        jax_write_wav(os.path.join(out_dir, os.path.basename(p)),
                      np.asarray(y)[0], sr)
    print(f"Contaminated {len(paths)} files -> {out_dir}")


def test_make_contaminated_matches_jax(tmp_path, capsys, monkeypatch):
    """Each file's draws injected from JAX's subkeys (split(key) per file,
    in list order): the wavs within one int16 step; one utterance longer
    and one shorter than --chunk_size; a file longer than the 2 x chunk
    noise bank is refused."""
    (tmp_path / "assets").mkdir()
    cfg_path, _ = _write_cfg(tmp_path / "assets")
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    rng = np.random.RandomState(5)
    for name, n in (("long.wav", 4900), ("short.wav", 2450)):
        write_wav(str(wavs / name), rng.randn(n) * 0.1)
    lst = tmp_path / "w.lst"
    lst.write_text("long.wav\nshort.wav\n")
    chunk, seed = 3000, 7
    _jax_make_contaminated(str(lst), str(wavs), str(tmp_path / "j"),
                           cfg_path, chunk, seed)
    want_line = capsys.readouterr().out.replace(str(tmp_path / "j"), "<out>")
    key = [jax.random.PRNGKey(seed)]

    def injected(generator, b, t, cfg, assets):
        key[0], sub = jax.random.split(key[0])
        return jax_draws(sub, b, t, cfg, assets)

    monkeypatch.setattr(D, "draw_distortions", injected)
    argv = ["make-contaminated", "--device", "cpu", "--wav_list", str(lst),
            "--data_root", str(wavs), "--dtrans_cfg", cfg_path,
            "--chunk_size", str(chunk), "--seed", str(seed)]
    util_scripts.main(argv + ["--out_dir", str(tmp_path / "p")])
    assert capsys.readouterr().out.replace(str(tmp_path / "p"),
                                           "<out>") == want_line
    for name, n in (("long.wav", 4800), ("short.wav", 2400)):
        want = read_wav(str(tmp_path / "j" / name))[0]
        got = read_wav(str(tmp_path / "p" / name))[0]
        assert got.shape == want.shape == (n,)
        assert np.abs(got - want).max() <= 1.0 / 32768 + 1e-7, name
        assert not np.array_equal(got, read_wav(str(wavs / name))[0][:n])
    monkeypatch.undo()
    write_wav(str(wavs / "long.wav"), rng.randn(6400) * 0.1)
    with pytest.raises(ValueError, match="longer than the 6000-sample"):
        util_scripts.main(argv + ["--out_dir", str(tmp_path / "q")])


def test_encode_codec2_runs_and_keeps_the_jax_defaults(tmp_path):
    """encode-codec2 writes each wav of the directory, under its name,
    through the codec2 round trip at --kbps (tests/
    test_torch_host_distortions.py holds it to the JAX tool byte for
    byte); its parser keeps the JAX tool's defaults."""
    from pase_tpu_torch.data.host_distortions import Codec2RoundTrip
    rng = np.random.RandomState(4)
    (tmp_path / "in").mkdir()
    for i in range(2):
        write_wav(str(tmp_path / "in" / f"u{i}.wav"), rng.randn(8000) * 0.1)
    n = util_scripts.main(["encode-codec2", str(tmp_path / "in"),
                           str(tmp_path / "o"), "--kbps", "1300",
                           "--num_workers", "2"])
    assert n == 2 and sorted(os.listdir(tmp_path / "o")) == ["u0.wav",
                                                             "u1.wav"]
    c2 = Codec2RoundTrip(kbps=1300)
    for i in range(2):
        x, _ = read_wav(str(tmp_path / "in" / f"u{i}.wav"))
        want = (np.clip(c2(x).astype(np.float64), -1, 1)
                * 32767.0).astype("<i2")
        got, _ = read_wav(str(tmp_path / "o" / f"u{i}.wav"))
        np.testing.assert_array_equal(got * 32768, want)
        assert not np.array_equal(got, x)
    opts = _opts(["encode-codec2", "in", "out"])
    assert (opts.kbps, opts.num_workers) == (1600, 8)
