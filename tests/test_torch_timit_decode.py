"""The port's TIMIT decoding pipeline (pase_tpu_torch/probes/
timit_decode.py) against the JAX package's on the CPU: the Kaldi binary
ark byte for byte and read across packages, the prior counts, dec_cfg.ini,
the decode command, the best-WER scan, length reconciliation, and the
full pipeline on the TIMIT-shaped corpus of tests/test_timit_decode.py
with a fake decode_dnn.sh and without one. The pipeline's classifier
inputs (context-windowed, speaker-normalized features) are held within
1e-5 of their largest, the labels and priors equal; the metrics (each
package's MLP from its own init) finite."""

import json
import os
import stat

import numpy as np
import pytest

from pase_tpu import frontend as jax_frontend
from pase_tpu.checkpoint import save_variables
from pase_tpu.probes import timit_decode as jtd
from pase_tpu_torch.probes import timit_decode as ptd
from test_timit_decode import SMALL_FE, timit_like_corpus  # noqa: F401
from torch_port_common import jax_variables, rel_err
from torch_port_common import port_test_guard  # noqa: F401

FEAT_REL = 1e-5


def _mats(seed=0):
    rng = np.random.RandomState(seed)
    return {"spk1_utt0": rng.randn(7, 5).astype(np.float32),
            "spk2_utt1": rng.randn(3, 5).astype(np.float32),
            "spk3_utt2": rng.randn(1, 5).astype(np.float32)}


def _write(pkg, path, mats):
    with open(path, "wb") as fd:
        for k, m in mats.items():
            pkg.write_kaldi_mat(fd, m, k)


def test_kaldi_ark_is_byte_equal_and_read_across(tmp_path):
    mats = _mats()
    _write(jtd, tmp_path / "j.ark", mats)
    _write(ptd, tmp_path / "p.ark", mats)
    assert (tmp_path / "p.ark").read_bytes() == \
        (tmp_path / "j.ark").read_bytes()
    for reader, path in ((ptd.read_kaldi_ark, "j.ark"),
                         (jtd.read_kaldi_ark, "p.ark"),
                         (ptd.read_kaldi_ark, "p.ark")):
        back = reader(str(tmp_path / path))
        assert list(back) == list(mats)
        for k in mats:
            np.testing.assert_array_equal(back[k], mats[k])


def test_prior_counts_match_jax(tmp_path):
    labs = [np.array([3, 3, 4, 5]), np.array([5, 5, 6, 9])]
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    want = jtd.compute_prior_counts(labs, str(tmp_path / "j"))
    got = ptd.compute_prior_counts(labs, str(tmp_path / "p"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for f in ("count.npy", "ids.npy"):
        assert (tmp_path / "p" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()


def test_reconcile_lengths_matches_jax():
    f = np.arange(103 * 2, dtype=np.float32).reshape(103, 2)
    for n in (100, 101, 102, 103):
        np.testing.assert_array_equal(
            ptd.reconcile_lengths(f, np.zeros(n)),
            jtd.reconcile_lengths(f, np.zeros(n)))
    for n in (90, 99, 104):
        with pytest.raises(ValueError, match="length error"):
            ptd.reconcile_lengths(f, np.zeros(n))


def test_dec_cfg_ini_command_and_best_wer_match_jax(tmp_path):
    dec_cfg = {"decoding_script_folder": "kaldi_decoding_scripts/",
               "decoding_script": "decode_dnn.sh", "beam": "13.0",
               "acwt": "0.2"}
    jtd.write_dec_cfg_ini(dec_cfg, str(tmp_path / "j.ini"))
    ptd.write_dec_cfg_ini(dec_cfg, str(tmp_path / "p.ini"))
    assert (tmp_path / "p.ini").read_text() == \
        (tmp_path / "j.ini").read_text()
    assert ptd.build_decode_command(dec_cfg, str(tmp_path), "post.ark") \
        == jtd.build_decode_command(dec_cfg, str(tmp_path), "post.ark")
    d = tmp_path / "dec" / "scoring_kaldi"
    d.mkdir(parents=True)
    (d / "wer_5").write_text("%WER 21.3 [ 1543 / 7215 ]\n%SER 9.0\n")
    (d / "wer_7").write_text("%WER 18.6 [ 1342 / 7215 ]\n")
    (d / "best_wer").write_text("%WER bad\n")
    assert ptd.parse_best_wer(str(tmp_path / "dec")) == \
        jtd.parse_best_wer(str(tmp_path / "dec")) == 18.6
    assert ptd.parse_best_wer(str(tmp_path / "none")) is None


def test_speaker_mean_norm_utts_matches_jax():
    rng = np.random.RandomState(1)
    feats = {f"spk{i % 2}_u{i}": rng.randn(4 + i, 3) for i in range(5)}
    want = jtd.speaker_mean_norm_utts(feats)
    got = ptd.speaker_mean_norm_utts(feats)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def small_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("timit_fe") / "FE_e0.npz")
    save_variables(path, jax_variables(jax_frontend.build_wavefe(SMALL_FE),
                                       16000, seed=2))
    return path


def _fake_decoder(root):
    """A decode_dnn.sh that checks its inputs and writes a scoring file."""
    scripts = root / "kaldi_scripts"
    scripts.mkdir()
    fake = scripts / "decode_dnn.sh"
    fake.write_text(
        "#!/bin/bash\n"
        "cfg=$1; out=$2; ark=$3\n"
        "[ -f \"$cfg\" ] || exit 2\n"
        "[ -f \"$ark\" ] || exit 3\n"
        "grep -q '^\\[decoding\\]' \"$cfg\" || exit 4\n"
        "mkdir -p \"$out/scoring_kaldi\"\n"
        "echo '%WER 17.9 [ fake ]' > \"$out/scoring_kaldi/wer_4\"\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    return scripts


CASES = {
    "kaldi": {"N_epochs": "4", "seed": "1", "batch_size": "64",
              "halving_factor": "0.5", "lr": "0.05", "left": "2",
              "right": "2", "avg_spk": "True", "dnn_lay": "32,3",
              "dnn_drop": "0.0,0.0"},
    "no_kaldi": {"N_epochs": "2", "batch_size": "64", "lr": "0.05",
                 "left": "1", "right": "1", "avg_spk": "False",
                 "dnn_lay": "16,3", "dnn_drop": "0.0,0.0"}}


@pytest.mark.parametrize("case", list(CASES))
def test_timit_full_pipeline_matches_jax(timit_like_corpus, small_ckpt,
                                         tmp_path, monkeypatch, case):
    """With the fake decoder (speaker-mean normalization, rc 0, best WER
    read) and without a decoding script (the encoder's avg_norm output,
    rc None): the same classifier inputs, counts, ark keys and shapes,
    dec_cfg.ini and decode result in both packages."""
    calls = {"jax": [], "port": []}
    for name, mod in (("jax", jtd), ("port", ptd)):
        real = mod.train_mlp_probe

        def wrapped(*a, _real=real, _out=calls[name], **k):
            _out.append((a, k))
            return _real(*a, **k)
        monkeypatch.setattr(mod, "train_mlp_probe", wrapped)
    if case == "kaldi":
        folder = str(_fake_decoder(tmp_path))
    else:
        folder = str(tmp_path / "nowhere")
    dec_cfg = {"decoding_script_folder": folder,
               "decoding_script": "decode_dnn.sh", "beam": "13.0"}
    root = timit_like_corpus
    res = {}
    for name, mod, extra in (("jax", jtd, {}), ("port", ptd,
                                               {"device": "cpu"})):
        res[name] = mod.run_timit_full_decoding(
            SMALL_FE, small_ckpt, str(root), str(root / "train.lst"),
            str(root / "test.lst"), str(tmp_path / name), CASES[case],
            dec_cfg, log=None, **extra)
    (ja, jk), (pa, pk) = calls["jax"][0], calls["port"][0]
    for g, w in zip(pa[:4], ja[:4]):
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            assert rel_err(g, w) <= FEAT_REL, rel_err(g, w)
    assert {k: v for k, v in pk.items() if k != "device"} == jk
    for f in ("count.npy", "ids.npy", "dec_cfg.ini"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()
    jark = jtd.read_kaldi_ark(res["jax"]["ark_file"])
    park = ptd.read_kaldi_ark(res["port"]["ark_file"])
    assert list(park) == list(jark) and len(park) == 3
    for k in jark:
        assert park[k].shape == jark[k].shape and park[k].shape[1] == 3
        assert np.all(np.isfinite(park[k]))
    assert res["port"]["decode_rc"] == res["jax"]["decode_rc"] == (
        0 if case == "kaldi" else None)
    if case == "kaldi":
        assert res["port"]["best_wer"] == res["jax"]["best_wer"] == 17.9
    assert set(res["port"]) == set(res["jax"])
    assert all(np.isfinite(res["port"][k]) for k in
               ("dev_frame_error", "best_dev_frame_error"))


def test_timit_full_with_dropout_runs(timit_like_corpus, small_ckpt,
                                      tmp_path):
    """dnn_drop 0.15 (the recipe's): the port's own masks; the ark is
    written in eval mode, finite."""
    cfg = dict(CASES["kaldi"], dnn_drop="0.15,0.15", N_epochs="2")
    res = ptd.run_timit_full_decoding(
        SMALL_FE, small_ckpt, str(timit_like_corpus),
        str(timit_like_corpus / "train.lst"),
        str(timit_like_corpus / "test.lst"), str(tmp_path / "exp"), cfg,
        {"decoding_script_folder": str(tmp_path / "nowhere"),
         "decoding_script": "decode_dnn.sh"}, log=None, device="cpu")
    assert res["decode_rc"] is None
    ark = ptd.read_kaldi_ark(res["ark_file"])
    assert all(np.all(np.isfinite(m)) for m in ark.values())
    assert json.loads(json.dumps({k: v for k, v in res.items()}))
    assert os.path.exists(tmp_path / "exp" / "dec_cfg.ini")
