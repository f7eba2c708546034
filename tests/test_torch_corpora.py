"""The port's corpus builders (pase_tpu_torch.data.prep, .data.kaldi_dir
and the data_prep CLI's segment, probe-lists, vctk-cfg, rirs-cfg,
voxceleb-lists, voxforge-lists, chime5-cfg, iemocap-segment and
arff-to-npy) against the JAX package's, on seeded trees in each corpus's
layout (pase_tpu_torch.data.synthetic_corpus), on the CPU.

Bounds: everything here is exact. Each subcommand runs through both CLIs
(``python -m pase_tpu_torch.data_prep`` and the root ``data_prep.py``)
with the same flags into two folders, which must hold the same files,
byte for byte (wavs, lists, JSON cfgs, .npy files, pickles), and the
printed lines must be equal but for the folder names."""

import json
import os
import sys

import numpy as np
import pytest

from pase_tpu.data import kaldi_dir as jax_kaldi_dir
from pase_tpu.data import prep as jax_prep
from pase_tpu_torch import data_prep as port_data_prep
from pase_tpu_torch.data import kaldi_dir, prep
from pase_tpu_torch.data import synthetic_corpus as S
from torch_port_common import port_test_guard  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(root):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs)


def _same_tree(a, b, min_files=1):
    files = _files(a)
    assert files == _files(b)
    assert len(files) >= min_files, files
    for f in files:
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            assert x.read() == y.read(), f
    return files


def _both(tmp_path, capsys, monkeypatch, argv, out_flags):
    """Run ``argv`` through the port's CLI and the JAX one, each
    ``out_flags`` entry given ``<tmp>/port/<name>`` or ``<tmp>/jax/<name>``;
    returns ({flag: (port path, jax path)}, printed lines of each with
    the paths replaced)."""
    sys.path.insert(0, REPO)
    import data_prep as jax_data_prep
    paths, printed = {}, []
    for side in ("port", "jax"):
        os.makedirs(tmp_path / side, exist_ok=True)
        args = list(argv)
        for flag, name in out_flags.items():
            p = str(tmp_path / side / name)
            paths.setdefault(flag, []).append(p)
            args += [flag, p]
        capsys.readouterr()
        if side == "port":
            port_data_prep.main(args)
        else:
            monkeypatch.setattr(sys, "argv", ["data_prep.py"] + args)
            jax_data_prep.main()
        printed.append(capsys.readouterr().out.replace(str(tmp_path / side),
                                                       "<out>"))
    assert printed[0] == printed[1] and printed[0].strip()
    return {k: tuple(v) for k, v in paths.items()}, printed[0]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpora")
    chime = S.write_synthetic_chime5(str(root / "chime5"), seconds=12.0,
                                     seed=1)
    vf = S.write_synthetic_voxforge(str(root / "voxforge"), seed=2)
    S.write_synthetic_rirs(str(root / "rirs"), seed=3)
    S.write_synthetic_vctk(str(root / "vctk"), seed=4)
    S.write_synthetic_voxceleb(str(root / "vox1"), seed=5)
    S.write_synthetic_long_wavs(str(root / "long"), seconds=20.0, seed=6)
    iemo = S.write_synthetic_iemocap(str(root / "iemocap"), seed=7)
    return {"root": root, "chime5": chime, "voxforge": vf, "iemocap": iemo}


def test_segment_matches_jax(trees, tmp_path, capsys, monkeypatch):
    paths, out = _both(tmp_path, capsys, monkeypatch,
                       ["segment", "--data_root", str(trees["root"] / "long"),
                        "--seg_len", "3.5"], {"--out_root": "seg"})
    files = _same_tree(*paths["--out_root"], min_files=10)
    assert f"Wrote {len(files)} segments" in out


def test_vctk_cfg_matches_jax(trees, tmp_path, capsys, monkeypatch):
    paths, out = _both(tmp_path, capsys, monkeypatch,
                       ["vctk-cfg", "--data_root", str(trees["root"] / "vctk"),
                        "--train_split", "0.5", "--valid_split", "0.2",
                        "--max_train_utts_spk", "2"],
                       {"--cfg_file": "vctk.cfg"})
    port, jax = paths["--cfg_file"]
    with open(port, "rb") as a, open(jax, "rb") as b:
        assert a.read() == b.read()
    with open(port) as f:
        cfg = json.load(f)
    # 6 speakers: 3 / 1 / 2, 2 of each speaker's 3 utterances: the last
    # is short (and past train's cap of 2)
    assert [len(cfg[s]["speakers"]) for s in ("train", "valid", "test")] \
        == [3, 1, 2]
    assert cfg["speakers"]["228"]["REGION"] == "Southern_England"
    assert cfg["speakers"]["226"]["REGION"] == "UNK"
    assert out.startswith("Wrote <out>/vctk.cfg: train=6, valid=2, test=4")


@pytest.mark.parametrize("flags", [
    ["--small_room_ratio", "0.6", "--large_room_ratio", "0.5", "--seed",
     "3"],
    [],
    ["--existing_cfg", "EXISTING"],
], ids=["ratios_seeded", "whole_rooms", "existing"])
def test_rirs_cfg_matches_jax(trees, tmp_path, capsys, monkeypatch, flags):
    """A ratio below 1 shuffles its room with random.Random(--seed) (an
    unseeded shuffle differs run to run, so only the seeded case cuts)."""
    existing = tmp_path / "base.cfg"
    existing.write_text(json.dumps({"noises_p": 0.4, "reverb_fmt": "npy",
                                    "reverb_irfiles": ["old.npy"]}))
    flags = [str(existing) if f == "EXISTING" else f for f in flags]
    paths, out = _both(tmp_path, capsys, monkeypatch,
                       ["rirs-cfg", "--data_root", str(trees["root"] / "rirs")]
                       + flags, {"--out_file": "revs.cfg"})
    port, jax = paths["--out_file"]
    with open(port, "rb") as a, open(jax, "rb") as b:
        assert a.read() == b.read()
    with open(port) as f:
        irs = json.load(f)["reverb_irfiles"]
    assert irs == sorted(irs) and len(irs) == (3 + 4 + 1 if "--seed" in flags
                                               else 12)
    assert f"with {len(irs)} IRs" in out


def test_voxceleb_lists_match_jax(trees, tmp_path, capsys, monkeypatch):
    paths, out = _both(tmp_path, capsys, monkeypatch,
                       ["voxceleb-lists", "--path_to_data",
                        str(trees["root"] / "vox1"), "--nspk", "3",
                        "--out_length", "2", "--seed", "11"],
                       {"--out_path": "mini"})
    files = _same_tree(*paths["--out_path"], min_files=9)
    assert sum(f.startswith("train" + os.sep) for f in files) == 3
    assert out.strip().startswith("Wrote 3 train / 3 test utts")


@pytest.mark.parametrize("vad", [False, True])
def test_voxforge_lists_match_jax(trees, tmp_path, capsys, monkeypatch, vad):
    meta, data = trees["voxforge"]
    paths, out = _both(tmp_path, capsys, monkeypatch,
                       ["voxforge-lists", "--path_to_data", data,
                        "--path_to_metadata", meta, "--nrecs", "4",
                        "--out_length", "2", "--seed", "5"]
                       + ["--vad"] * vad, {"--out_path": "lid"})
    files = _same_tree(*paths["--out_path"], min_files=8)
    # each language's 1.5 s recording is skipped
    assert sum(f.startswith("train" + os.sep) for f in files) + sum(
        f.startswith("test" + os.sep) for f in files) == 9
    assert "utt2lang.npy" in " ".join(files) and out.strip()


@pytest.mark.parametrize("no_cut", [False, True])
def test_chime5_cfg_matches_jax(trees, tmp_path, capsys, monkeypatch,
                                no_cut):
    worn, array = trees["chime5"]
    paths, out = _both(tmp_path, capsys, monkeypatch,
                       ["chime5-cfg", "--ihm_dir", worn, "--sdm_dir", array]
                       + ["--no_cut"] * no_cut,
                       {"--out_dir": "seg", "--cfg_file": "chime5.cfg"})
    port, jax = paths["--cfg_file"]
    with open(port, "rb") as a, open(jax, "rb") as b:
        assert a.read() == b.read()
    with open(port) as f:
        cfg = json.load(f)
    n = [len(cfg[s]["data"]) for s in ("train", "valid", "test")]
    assert n == [6, 3, 3]        # the one-word transcripts dropped
    if no_cut:
        assert not os.path.exists(paths["--out_dir"][0])
    else:
        assert len(_same_tree(*paths["--out_dir"])) == 2 * sum(n)
    assert out.startswith("Wrote <out>/chime5.cfg: train=6, valid=3, test=3")


def test_iemocap_segment_matches_jax(trees, tmp_path, capsys, monkeypatch):
    paths, out = _both(tmp_path, capsys, monkeypatch,
                       ["iemocap-segment", "--iemocap_root",
                        trees["iemocap"]], {"--out_dir": "emo"})
    files = _same_tree(*paths["--out_dir"], min_files=8)
    assert {f.split(os.sep)[1] for f in files} <= {"neu", "hap", "sad",
                                                  "ang"}
    assert out.startswith("session1: ")


@pytest.mark.parametrize("style", ["utt2class_lists", "dirname_holdout",
                                   "dirname_random", "utt2class_scan"])
def test_probe_lists_match_jax(trees, tmp_path, capsys, monkeypatch, style):
    """The reference's two asset styles: a VoxCeleb-style utt2spk map with
    its lists (the port's voxceleb-lists output), and IEMOCAP's
    directory-per-class tree (the port's iemocap-segment output), split by
    session or at random per class."""
    if style.startswith("utt2class"):
        vox = tmp_path / "vox"
        prep.voxceleb_lists(str(trees["root"] / "vox1"), str(vox), nspk=4,
                            out_length=1, seed=2)
        argv = ["--data_root", str(vox / "train"), "--utt2class",
                str(vox / "lists" / "utt2spk.npy")]
        if style == "utt2class_lists":
            argv = ["--data_root", str(vox), "--utt2class",
                    str(vox / "lists" / "utt2spk.npy"), "--train_list",
                    str(vox / "lists" / "train_list"), "--test_list",
                    str(vox / "lists" / "test_list")]
    else:
        emo = tmp_path / "emo"
        prep.iemocap_segment(trees["iemocap"], str(emo))
        argv = ["--data_root", str(emo), "--class_from", "dirname"]
        argv += (["--holdout", "session2"] if style == "dirname_holdout"
                 else ["--test_ratio", "0.3", "--seed", "4"])
    paths, out = _both(tmp_path, capsys, monkeypatch,
                       ["probe-lists"] + argv, {"--out_dir": "lists"})
    files = _same_tree(*paths["--out_dir"], min_files=4)
    assert files == ["class_map.json", "te.lst", "tr.lst", "utt2class.json"]
    assert " test utts, " in out


def test_arff_to_npy_matches_jax(tmp_path, capsys, monkeypatch):
    for side in ("port", "jax"):
        S.write_synthetic_arff(str(tmp_path / side / "arff"), seed=8)
        S.write_synthetic_arff(str(tmp_path / side / "arff" / "sub"),
                               n_files=1, seed=9)
    sys.path.insert(0, REPO)
    import data_prep as jax_data_prep
    printed = []
    for side in ("port", "jax"):
        args = ["arff-to-npy", "--arff_root", str(tmp_path / side / "arff"),
                "--out_stats", str(tmp_path / side / "stats.pkl")]
        capsys.readouterr()
        if side == "port":
            port_data_prep.main(args)
        else:
            monkeypatch.setattr(sys, "argv", ["data_prep.py"] + args)
            jax_data_prep.main()
        printed.append(capsys.readouterr().out.replace(str(tmp_path / side),
                                                       "<out>"))
    assert printed[0] == printed[1] == \
        "Wrote 4 npy files + stats <out>/stats.pkl\n"
    files = _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"),
                       min_files=9)
    assert sum(f.endswith(".npy") for f in files) == 4
    npy = np.load(str(tmp_path / "port" / "arff" / "utt0.npy"))
    assert npy.shape == (3, 50) and np.isfinite(npy).all()


def test_kaldi_dir_matches_jax(trees, tmp_path):
    """Both readers give the same maps of the seeded CHiME-5 dirs, write
    the same files, and parse the same wav.scp entries."""
    for d in trees["chime5"]:
        got, want = kaldi_dir.KaldiDataDir(d), jax_kaldi_dir.KaldiDataDir(d)
        for attr in ("utt2spk", "utt2wav", "utt2text", "utt2segments",
                     "spk2utt", "utt2dur"):
            assert getattr(got, attr) == getattr(want, attr), attr
        assert (got.num_spk, got.num_utt) == (want.num_spk, want.num_utt)
        got.utt2dur = want.utt2dur = {"u1": 1.5, "u2": 2.25}
        got.write(str(tmp_path / "port" / os.path.basename(d)))
        want.write(str(tmp_path / "jax" / os.path.basename(d)))
        assert got.total_duration == want.total_duration == 3.75
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"), min_files=10)
    for entry in ("/x/S03_P09.wav", "sox /x/S03_U01.wav -t wav - remix 2 |",
                  "sox /x/a.flac -t wav - |", "  /x/y.wav  "):
        assert kaldi_dir.parse_wav_entry(entry) == \
            jax_kaldi_dir.parse_wav_entry(entry)
    with pytest.raises(FileNotFoundError):
        kaldi_dir.KaldiDataDir(str(tmp_path / "nope"))


def test_chime5_pair_matches_jax(trees):
    worn, array = trees["chime5"]
    for words in (1, 2, 3):
        got = prep.chime5_pair(worn, array, words)
        assert got == jax_prep.chime5_pair(worn, array, words)


def test_host_helpers_match_jax():
    """simple_frame_vad, _fixed_length (crop and tile, with the same
    RandomState draws) and _interp_sentinel."""
    rng = np.random.RandomState(6)
    sig = np.concatenate([np.zeros(8000), rng.randn(16000) * 0.3,
                          np.zeros(4000), rng.randn(300)]).astype(np.float32)
    for kw in ({}, {"percent_thr": 0.3, "context": 2}):
        np.testing.assert_array_equal(prep.simple_frame_vad(sig, 16000, **kw),
                                      jax_prep.simple_frame_vad(sig, 16000,
                                                                **kw))
    for n in (100, 24000, sig.size - 1, sig.size, 2 * sig.size + 7):
        a, b = np.random.RandomState(n), np.random.RandomState(n)
        np.testing.assert_array_equal(prep._fixed_length(sig, n, a),
                                      jax_prep._fixed_length(sig, n, b))
    x = np.log(np.abs(rng.randn(40)) + 1).astype(np.float32)
    for mask in (x > 0.5, np.zeros(40, bool), np.ones(40, bool)):
        y = np.where(mask, x, -1e10).astype(np.float32)
        np.testing.assert_array_equal(prep._interp_sentinel(y),
                                      jax_prep._interp_sentinel(y))
