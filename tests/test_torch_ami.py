"""The port's AMI slice (pase_tpu_torch.data.prep, its data_prep CLI,
``AmiSegTupleWavDataset`` and the training CLI on AMI) against the JAX
package on a seeded AMI meeting tree, on the CPU.

Bounds: everything here is exact. The VAD segments, the segment wavs
(names and samples), utt2spk and the data cfgs equal JAX's; the AMI
tuples and batches of both modes equal JAX's bit for bit
(``np.array_equal``), as tests/test_torch_data.py holds the other
datasets. The training CLI runs two steps a corpus at a tiny size.
"""

import argparse
import glob
import json
import os
import sys

import numpy as np
import pytest

from pase_tpu.data import dataset as JD
from pase_tpu.data import prep as jax_prep
from pase_tpu_torch import data_prep as port_data_prep
from pase_tpu_torch.data import dataset as D
from pase_tpu_torch.data import prep
from pase_tpu_torch.data.io import read_wav
from pase_tpu_torch.data.synthetic_corpus import (write_synthetic_ami,
                                                  write_synthetic_chime5,
                                                  write_synthetic_corpus)
from torch_port_common import port_test_guard  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEETINGS, MEETING_S = 2, 20.0
CHANS = "1,3,5,7"
CHUNK = 4800
# the encoder and worker bank of the JAX CLI tests (test_cli_scripts.py)
FE = {"kwidths": [65, 10, 5, 5], "strides": [1, 10, 4, 4],
      "fmaps": [16, 16, 32, 32], "emb_dim": 32, "norm_out": True}
WK = {"regr": [{"num_outputs": 39, "dropout": 0, "hidden_size": 32,
                "hidden_layers": 1, "name": "mfcc", "r": 1,
                "loss": "MSELoss", "skip": False}],
      "cls": [{"num_outputs": 1, "dropout": 0, "hidden_size": 32,
               "hidden_layers": 1, "name": "mi",
               "loss": "BCEWithLogitsLoss", "skip": False}]}


def _segment_scps(seg_root, root, meetings):
    """Train (all meetings but the last) and test scps of the segments."""
    paths = {}
    for split, meets in (("train", meetings[:-1]), ("test", meetings[-1:])):
        files = sorted(f for m in meets for f in glob.glob(
            os.path.join(seg_root, m, "audio", "*.wav")))
        paths[split] = os.path.join(root, f"{split}.scp")
        with open(paths[split], "w") as f:
            f.write("\n".join(files))
    return paths


@pytest.fixture(scope="module")
def ami(tmp_path_factory):
    """The seeded meeting tree, segmented by the port's CLI and by JAX's
    ami_segment, the scps, both cfgs (channel-key), and a tree-mode sdm
    tree (channel 1's segment under each headset segment's name)."""
    root = str(tmp_path_factory.mktemp("ami"))
    tree = os.path.join(root, "amicorpus")
    meetings = write_synthetic_ami(tree, MEETINGS, MEETING_S, seed=3)
    ids = os.path.join(root, "meetings.txt")
    with open(ids, "w") as f:
        f.write("\n".join(meetings))
    seg, jseg = os.path.join(root, "seg"), os.path.join(root, "jseg")
    port_data_prep.main(["ami-segment", "--data_root", tree, "--out_root",
                         seg, "--ami_meeting_ids", ids, "--map_ihm2sdm",
                         CHANS])
    jax_prep.ami_segment(tree, jseg, meetings, map_ihm2sdm=CHANS)
    scps = _segment_scps(seg, root, meetings)
    cfg = os.path.join(root, "ami.cfg")
    port_data_prep.main(["ami-cfg", "--data_root", seg, "--train_scp",
                         scps["train"], "--test_scp", scps["test"],
                         "--cfg_file", cfg, "--map_ihm2sdm", CHANS,
                         "--val_ratio", "0.25"])
    sdm = os.path.join(root, "sdm")
    for m in meetings:
        os.makedirs(os.path.join(sdm, m, "audio"))
        for f in glob.glob(os.path.join(seg, m, "audio",
                                        "*.Headset-?-*.wav")):
            if ".Arr1-" not in f:
                os.link(f.replace(".wav", ".Arr1-01.wav"),
                        os.path.join(sdm, m, "audio", os.path.basename(f)))
    return argparse.Namespace(root=root, tree=tree, meetings=meetings,
                              seg=seg, jseg=jseg, scps=scps, cfg=cfg,
                              sdm=sdm)


def _files(root):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs)


def test_energy_vad_matches_jax(ami):
    rng = np.random.RandomState(0)
    signals = [rng.randn(n).astype(np.float32) * g
               for n, g in ((3000, 1.0), (3300, 1.0), (40000, 0.1))]
    for m in ami.meetings:
        for h in range(4):
            signals.append(read_wav(os.path.join(
                ami.tree, m, "audio", f"{m}.Headset-{h}.wav"))[0])
    n_segs = 0
    for sig in signals:
        for kw in ({}, {"min_len": 8000, "smooth_window": 20}):
            got = prep.energy_vad_segments(sig, **kw)
            assert got == jax_prep.energy_vad_segments(sig, **kw)
            n_segs += len(got)
    assert n_segs > 20


def test_ami_segment_matches_jax(ami):
    """The port's CLI wrote JAX's files: the VAD lists, every segment wav
    sample for sample, and utt2spk."""
    files = _files(ami.seg)
    assert files == _files(ami.jseg)
    wavs = [f for f in files if f.endswith(".wav")]
    assert len(wavs) > 60
    for f in files:
        if f.endswith(".wav"):
            np.testing.assert_array_equal(
                read_wav(os.path.join(ami.seg, f))[0],
                read_wav(os.path.join(ami.jseg, f))[0])
        elif f.endswith(".vad"):
            with open(os.path.join(ami.seg, f)) as a, \
                    open(os.path.join(ami.jseg, f)) as b:
                assert a.read() == b.read()
    u2s = np.load(os.path.join(ami.seg, "utt2spk.npy"),
                  allow_pickle=True).item()
    assert u2s == np.load(os.path.join(ami.jseg, "utt2spk.npy"),
                          allow_pickle=True).item()
    assert len(u2s) == len(wavs)


def test_ami_cfg_matches_jax(ami, tmp_path):
    """The cfg the port's ami-cfg wrote equals the JAX CLI's on the same
    scps, and a channel missing from the scps drops its headset
    segments from both."""
    sys.path.insert(0, REPO)
    import data_prep as jax_data_prep
    jcfg = str(tmp_path / "jax.cfg")
    jax_data_prep.ami_cfg_cmd(argparse.Namespace(
        data_root=ami.seg, train_scp=ami.scps["train"],
        test_scp=ami.scps["test"], cfg_file=jcfg, map_ihm2sdm=CHANS,
        val_ratio=0.25, seed=3))
    with open(ami.cfg) as f, open(jcfg) as g:
        got, want = json.load(f), json.load(g)
    assert got == want
    assert all(set(e) == {"filename", "spk", "1", "3", "5", "7"}
               for s in ("train", "valid", "test") for e in got[s]["data"])
    assert got["train"]["total_wav_dur"] > 0 and got["valid"]["data"]
    # drop channel 7 of one segment from the train scp
    with open(ami.scps["train"]) as f:
        lines = f.read().split("\n")
    lost = next(ln for ln in lines if ln.endswith(".Arr1-07.wav"))
    scp = str(tmp_path / "cut.scp")
    with open(scp, "w") as f:
        f.write("\n".join(ln for ln in lines if ln != lost))
    args = (ami.seg, scp, ami.scps["test"])
    cut = prep.ami_data_cfg(*args, map_ihm2sdm=CHANS, val_ratio=0.25)
    assert cut == jax_prep.ami_data_cfg(*args, map_ihm2sdm=CHANS,
                                        val_ratio=0.25)
    n = sum(len(cut[s]["data"]) for s in ("train", "valid"))
    assert n == sum(len(got[s]["data"]) for s in ("train", "valid")) - 1


def test_vad_segment_and_build_cfg_match_jax(ami, tmp_path):
    sys.path.insert(0, REPO)
    import data_prep as jax_data_prep
    files = [os.path.join(m, "audio", f"{m}.Headset-{h}.wav")
             for m in ami.meetings for h in (0, 1)]
    lst = str(tmp_path / "files.txt")
    with open(lst, "w") as f:
        f.write("\n".join(files))
    out, jout = str(tmp_path / "vad"), str(tmp_path / "jvad")
    port_data_prep.main(["vad-segment", "--data_root", ami.tree,
                         "--out_root", out, "--file_list", lst,
                         "--vad_list", str(tmp_path / "vad.txt")])
    n = jax_prep.vad_segment_corpus(ami.tree, files, jout,
                                    vad_list_path=str(tmp_path / "jv.txt"))
    assert _files(out) == _files(jout) and len(_files(out)) == n > 5
    for f in _files(out):
        np.testing.assert_array_equal(read_wav(os.path.join(out, f))[0],
                                      read_wav(os.path.join(jout, f))[0])
    assert (tmp_path / "vad.txt").read_text() == \
        (tmp_path / "jv.txt").read_text()
    wavs = [os.path.relpath(p, ami.seg) for p in sorted(glob.glob(
        os.path.join(ami.seg, "*", "audio", "*Headset-?-?.wav")))]
    scp = str(tmp_path / "tr.scp")
    with open(scp, "w") as f:
        f.write("\n".join(wavs))
    cfgs = [str(tmp_path / "b.cfg"), str(tmp_path / "jb.cfg")]
    port_data_prep.main(["build-cfg", "--data_root", ami.seg, "--train_scp",
                         scp, "--cfg_file", cfgs[0], "--val_ratio", "0.3"])
    jax_data_prep.build_cfg(argparse.Namespace(
        data_root=ami.seg, train_scp=scp, test_scp=None, libri_dict=None,
        cfg_file=cfgs[1], val_ratio=0.3, seed=3))
    with open(cfgs[0]) as f, open(cfgs[1]) as g:
        assert json.load(f) == json.load(g)


@pytest.mark.parametrize("cmd", ["segment", "chime5-cfg"])
def test_data_prep_unported_subcommands_name_their_item(cmd, ami, tmp_path):
    """The two subcommands that raised naming ROADMAP item 11b part 4
    until it was ported now write the JAX CLI's files, byte for byte:
    segment on the seeded meetings' headsets, chime5-cfg on a seeded
    CHiME-5 session's worn / array Kaldi dirs."""
    sys.path.insert(0, REPO)
    import data_prep as jax_data_prep
    out = {side: str(tmp_path / side) for side in ("port", "jax")}
    if cmd == "segment":
        heads = str(tmp_path / "heads")
        os.makedirs(heads)
        for f in glob.glob(os.path.join(ami.tree, "*", "audio",
                                        "*.Headset-*.wav")):
            os.link(f, os.path.join(heads, os.path.basename(f)))
        port_data_prep.main(["segment", "--data_root", heads, "--out_root",
                             out["port"], "--seg_len", "4.0"])
        jax_data_prep.segment(argparse.Namespace(
            data_root=heads, out_root=out["jax"], seg_len=4.0))
    else:
        worn, array = write_synthetic_chime5(str(tmp_path / "chime5"),
                                             seconds=10.0, seed=2)
        port_data_prep.main(["chime5-cfg", "--ihm_dir", worn, "--sdm_dir",
                             array, "--out_dir", out["port"], "--cfg_file",
                             os.path.join(out["port"], "c5.cfg")])
        jax_data_prep.chime5_cmd(argparse.Namespace(
            ihm_dir=worn, sdm_dir=array, out_dir=out["jax"],
            cfg_file=os.path.join(out["jax"], "c5.cfg"), valid_spk="P42",
            test_spk="P41", no_cut=False))
    files = _files(out["port"])
    assert files == _files(out["jax"]) and len(files) > 10
    for f in files:
        with open(os.path.join(out["port"], f), "rb") as a, \
                open(os.path.join(out["jax"], f), "rb") as b:
            assert a.read() == b.read(), f


def _ami_datasets(ami, mode, split="train", seed=4):
    if mode == "tree":
        args = (ami.sdm, ami.seg, ami.cfg, split)
        kw = {}
    else:
        args = (ami.seg, ami.seg, ami.cfg, split)
        kw = {"ihm2sdm": CHANS}
    return (D.AmiSegTupleWavDataset(*args, seed=seed, **kw),
            JD.AmiSegTupleWavDataset(*args, seed=seed, **kw))


@pytest.mark.parametrize("mode", ["tree", "channel_key"])
def test_ami_tuples_and_batches_equal_jax(ami, mode):
    """sample_tuple with the dataset's own RandomState, then three batches
    of a ChunkBatcher (the parallel crops: chunk and cchunk at one
    window), equal JAX's bit for bit."""
    got, want = _ami_datasets(ami, mode)
    assert len(got) == len(want) > 10
    for i in range(len(got)):
        g, w = got.sample_tuple(i), want.sample_tuple(i)
        assert len(g) == len(w) == (4 if mode == "channel_key" else 3)
        for a, b in zip(g, w):
            assert np.array_equal(a, b)
    gb, wb = (cls(ds, 3, CHUNK, seed=5) for cls, ds in (
        (D.ChunkBatcher, got), (JD.ChunkBatcher, want)))
    for _ in range(3):
        g, w = gb._make_batch(), wb._make_batch()
        assert set(g) == set(w) == {"chunk", "chunk_ctxt", "chunk_rand",
                                    "cchunk"}
        for k in w:
            assert np.array_equal(g[k], w[k]), k
        # chunk and cchunk share the window: the sdm channel is a mix of
        # the headsets, so they differ, but not by a shift
        assert not np.array_equal(g["chunk"], g["cchunk"])


def test_ami_channel_filter_keeps_jax_count(ami, tmp_path, capsys):
    with open(ami.cfg) as f:
        cfg = json.load(f)
    for e in cfg["train"]["data"][::3]:
        del e["5"]
    path = str(tmp_path / "cut.cfg")
    with open(path, "w") as f:
        json.dump(cfg, f)
    n = len(cfg["train"]["data"])
    lost = len(cfg["train"]["data"][::3])
    got = D.AmiSegTupleWavDataset(ami.seg, ami.seg, path, "train",
                                  ihm2sdm=CHANS)
    assert capsys.readouterr().out.strip() == (
        f"AmiSegTupleWavDataset: dropped {lost} segments missing sdm "
        f"channels ['1', '3', '5', '7']")
    want = JD.AmiSegTupleWavDataset(ami.seg, ami.seg, path, "train",
                                    ihm2sdm=CHANS)
    assert len(got) == len(want) == n - lost
    assert [e["filename"] for e in got.wavs] == \
        [e["filename"] for e in want.wavs]
    # a channel that no entry has leaves nothing
    assert len(D.AmiSegTupleWavDataset(ami.seg, ami.seg, path, "train",
                                       ihm2sdm="2")) == 0


@pytest.fixture(scope="module")
def libri(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("libri"))
    return write_synthetic_corpus(root, 3.0, 1.0, seed=0, min_seconds=0.4,
                                  max_seconds=0.8)


def _cfg_files(tmp_path):
    paths = []
    for name, cfg in (("fe.cfg", FE), ("wk.cfg", WK)):
        paths.append(str(tmp_path / name))
        with open(paths[-1], "w") as f:
            json.dump(cfg, f)
    return paths


def _short_run(monkeypatch, argv, record):
    """The port's training CLI with 2 steps and 1 eval batch an epoch;
    every raw batch the steps read goes to ``record``."""
    from pase_tpu_torch import train as port_train
    from pase_tpu_torch.trainer import Trainer
    orig_train, orig_step = Trainer.train_, Trainer.train_step

    def short_train(self, *a, **k):
        self.bpe = 2
        self.cfg["va_bpe"] = 1
        return orig_train(self, *a, **k)

    def step(self, raw, *a, **k):
        record.append({k: v.clone() for k, v in self.ready(raw).items()})
        return orig_step(self, raw, *a, **k)

    monkeypatch.setattr(Trainer, "train_", short_train)
    monkeypatch.setattr(Trainer, "train_step", step)
    return port_train.main(argv)


@pytest.mark.parametrize("mode", ["tree", "channel_key", "device_corpus"])
def test_train_cli_ami(ami, libri, tmp_path, monkeypatch, mode):
    """The JAX CLI test test_train_cli_multi_corpus_ami with the port's
    CLI: LibriSpeech with a distortion stack beside AMI with --dtrans_cfg
    None (tree mode, and channel-key mode); the checkpoint and metrics
    are written, and the distortion mask is off on exactly the AMI rows
    (the rows whose cchunk, the headset crop, is not the chunk). With
    --device_corpus, AMI alone in tree mode, its rows gathered on the
    device."""
    fe, wk = _cfg_files(tmp_path)
    wav_root, libri_cfg = libri
    dcfg = str(tmp_path / "dist.cfg")
    with open(dcfg, "w") as f:
        json.dump({"clip_p": 0.5, "clip_factors": [0.3]}, f)
    ami_flags = (["--data_root", ami.sdm, "--data_cfg", ami.cfg,
                  "--dtrans_cfg", "None", "--dataset",
                  "AmiSegTupleWavDataset", "--clean_root", ami.seg]
                 if mode != "channel_key" else
                 ["--data_root", ami.seg, "--data_cfg", ami.cfg,
                  "--dtrans_cfg", "None", "--dataset",
                  "AmiSegTupleWavDataset", "--clean_root", ami.seg,
                  "--ihm2sdm", CHANS])
    libri_flags = ["--data_root", wav_root, "--data_cfg", libri_cfg,
                   "--dtrans_cfg", dcfg, "--dataset",
                   "LibriSpeechSegTupleWavDataset"]
    corpora = (ami_flags + ["--device_corpus"] if mode == "device_corpus"
               else libri_flags + ami_flags)
    save = str(tmp_path / "ckpt")
    batches = []
    tr = _short_run(monkeypatch, ["--device", "cpu", "--net_cfg", wk,
                                  "--fe_cfg", fe, "--num_workers", "1",
                                  "--batch_size", "8", "--chunk_size",
                                  str(CHUNK), "--epoch", "1", "--log_freq",
                                  "1", "--save_path", save] + corpora,
                    batches)
    assert tr.step == 2 and len(batches) == 2
    assert os.path.exists(os.path.join(save, "FE_e0.npz"))
    with open(os.path.join(save, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    assert [r["split"] for r in recs] == (
        ["feed"] * (mode == "device_corpus")
        + ["train", "train", "perf", "eval"])
    assert all(np.isfinite(v) for r in recs for v in r.values()
               if isinstance(v, float))
    if mode == "device_corpus":
        assert all("dist_mask" not in b and b["cchunk"].shape == (8, CHUNK)
                   for b in batches)
        return
    n_ami = 0
    for b in batches:
        parallel = ~(b["cchunk"] == b["chunk"]).all(dim=1)
        assert (b["dist_mask"] == (~parallel).float()).all()
        n_ami += int(parallel.sum())
    assert 0 < n_ami < 16


def test_device_corpus_refuses_channel_key_mode(ami, tmp_path):
    from pase_tpu_torch import train as port_train
    fe, wk = _cfg_files(tmp_path)
    with pytest.raises(ValueError, match="channel-key --ihm2sdm stays on "
                                         "the host path"):
        port_train.main(["--device", "cpu", "--net_cfg", wk, "--fe_cfg", fe,
                         "--data_root", ami.seg, "--data_cfg", ami.cfg,
                         "--dataset", "AmiSegTupleWavDataset",
                         "--clean_root", ami.seg, "--ihm2sdm", CHANS,
                         "--device_corpus", "--batch_size", "2",
                         "--chunk_size", str(CHUNK),
                         "--save_path", str(tmp_path / "run")])


def test_write_synthetic_ami_layout(tmp_path):
    meetings = write_synthetic_ami(str(tmp_path), 1, 2.0, seed=1)
    folder = tmp_path / meetings[0] / "audio"
    names = sorted(os.listdir(folder))
    assert names == sorted([f"{meetings[0]}.Headset-{h}.wav"
                            for h in range(4)]
                           + [f"{meetings[0]}.Array1-0{c}.wav"
                              for c in range(1, 9)])
    for n in names:
        wav, sr = read_wav(str(folder / n))
        assert sr == 16000 and len(wav) == 32000
