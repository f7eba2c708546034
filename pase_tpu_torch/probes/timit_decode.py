"""The TIMIT full ASR decoding pipeline on frozen encoder features.

The port of ``pase_tpu/probes/timit_decode.py``:

1. feature extraction per utterance (the wav peak-normalized first):
   either raw features with per-speaker mean subtraction after
   (``avg_spk``) or the encoder's 'avg_norm' output;
2. a context window (left / right from the MLP cfg), its first ``left``
   and last ``right`` rows dropped;
3. frame alignments, the features trimmed to their length (a surplus of
   1 to 3 frames tolerated);
4. state-prior counts of the concatenated, min-normalized train labels
   (``count.npy`` / ``ids.npy``);
5. MLP training with dev-error lr halving (``probes.classifier``);
6. a Kaldi binary ark of log-posteriors minus log-priors;
7. ``dec_cfg.ini`` and the ``decode_dnn.sh`` command line, run when the
   Kaldi scripts exist, skipped with the command printed when they do
   not;
8. the best %WER of the scoring output.

Extraction and the MLP run on ``device`` (the card unless 'cpu'); only
the HMM lattice decoding is external.
"""

import json
import os
import re
import struct
import subprocess

import numpy as np

from pase_tpu_torch.data.io import read_wav
from pase_tpu_torch.probes.classifier import (context_window, predict,
                                              train_mlp_probe)
from pase_tpu_torch.probes.extract import FeatureExtractor

# ---------------------------------------------------------------------------
# Kaldi binary ark IO
# ---------------------------------------------------------------------------


def write_kaldi_mat(fd, mat, key):
    """Append one float matrix to a binary Kaldi ark stream."""
    mat = np.ascontiguousarray(mat, dtype=np.float32)
    fd.write((key + " ").encode("latin1"))
    fd.write(b"\0B")
    fd.write(b"FM ")
    fd.write(b"\x04" + struct.pack("<i", mat.shape[0]))
    fd.write(b"\x04" + struct.pack("<i", mat.shape[1]))
    fd.write(mat.tobytes())


def read_kaldi_ark(path):
    """Read a binary float-matrix ark written by ``write_kaldi_mat``."""
    out = {}
    with open(path, "rb") as fd:
        while True:
            key = b""
            c = fd.read(1)
            if not c:
                break
            while c not in (b" ", b""):
                key += c
                c = fd.read(1)
            assert fd.read(2) == b"\0B", "not a binary kaldi ark"
            fmt = fd.read(3)
            assert fmt == b"FM ", fmt
            assert fd.read(1) == b"\x04"
            rows = struct.unpack("<i", fd.read(4))[0]
            assert fd.read(1) == b"\x04"
            cols = struct.unpack("<i", fd.read(4))[0]
            data = np.frombuffer(fd.read(rows * cols * 4), dtype=np.float32)
            out[key.decode("latin1")] = data.reshape(rows, cols).copy()
    return out


# ---------------------------------------------------------------------------
# pipeline pieces
# ---------------------------------------------------------------------------


def reconcile_lengths(feat, lab, utt="?"):
    """Trim the features to the alignment length, tolerating a surplus of
    1 to 3 trailing frames; any other difference raises ValueError."""
    diff = feat.shape[0] - lab.shape[0]
    if diff in (1, 2, 3):
        return feat[:-diff]
    if diff == 0:
        return feat
    raise ValueError(f"length error: {utt} feats {feat.shape[0]} vs "
                     f"alignment {lab.shape[0]}")


def compute_prior_counts(train_labels, out_folder=None):
    """State-prior counts of the concatenated, min-normalized train labels
    -> (ids, counts); saved as count.npy / ids.npy under out_folder."""
    lab_conc = np.concatenate(train_labels)
    lab_conc = lab_conc - lab_conc.min()
    unique, counts = np.unique(lab_conc, return_counts=True)
    if out_folder:
        np.save(os.path.join(out_folder, "count.npy"), counts)
        np.save(os.path.join(out_folder, "ids.npy"), unique)
    return unique, counts


def write_dec_cfg_ini(dec_cfg, path):
    """The decoder cfg (JSON dict) as dec_cfg.ini's [decoding] section."""
    with open(path, "w") as f:
        f.write("[decoding]\n")
        for key in dec_cfg.keys():
            f.write("%s=%s\n" % (key, dec_cfg[key]))


def build_decode_command(dec_cfg, out_folder, ark_file):
    """The decode_dnn.sh command line."""
    return (dec_cfg["decoding_script_folder"] + "/"
            + dec_cfg["decoding_script"] + " "
            + os.path.abspath(os.path.join(out_folder, "dec_cfg.ini")) + " "
            + os.path.join(out_folder, "dec") + ' "' + ark_file + '"')


def run_decoding(dec_cfg, out_folder, ark_file, log=print):
    """Run the Kaldi decoding script; returns its exit code, or None when
    the script is absent (no Kaldi here)."""
    cmd = build_decode_command(dec_cfg, out_folder, ark_file)
    script = os.path.join(dec_cfg["decoding_script_folder"],
                          dec_cfg["decoding_script"])
    if log:
        log(cmd)
    if not os.path.exists(script):
        if log:
            log(f"[timit-full] decoding script {script} not found — "
                "skipping the external Kaldi stage (ark + cfg are ready)")
        return None
    proc = subprocess.run(cmd, shell=True, capture_output=True)
    if log and proc.stdout:
        log(proc.stdout.decode(errors="replace")[-2000:])
    return proc.returncode


def parse_best_wer(dec_dir):
    """The best %WER in Kaldi's scoring outputs under dec_dir (files
    wer_* or best_wer; WER lines only, not %SER)."""
    best = None
    for root, _, files in os.walk(dec_dir):
        for fn in files:
            if not (fn.startswith("wer_") or fn == "best_wer"):
                continue
            try:
                with open(os.path.join(root, fn), errors="replace") as f:
                    for line in f:
                        m = re.search(r"\bWER (\S+)", line)
                        if m:
                            try:
                                v = float(m.group(1).rstrip("%,"))
                            except ValueError:
                                continue
                            if best is None or v < best:
                                best = v
            except OSError:
                continue
    return best


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------


def _utt_id(wav_path):
    """spk_utt id from the TIMIT path layout (speaker directory, file)."""
    parts = wav_path.split("/")
    base = os.path.splitext(parts[-1])[0]
    return (parts[-2] + "_" + base) if len(parts) >= 2 else base


def _load_split(ex, entries, data_root, avg_spk):
    """({utt: feats [F, D]}, {utt: alignment}) of a list; avg_spk: raw
    features (the speaker mean is subtracted after), else the encoder's
    'avg_norm' output of the whole utterance."""
    feats, alis = {}, {}
    for path, alifile in entries:
        wav, _ = read_wav(os.path.join(data_root, path))
        wav = wav / (np.abs(wav).max() + 1e-9)
        utt = _utt_id(path)
        if avg_spk:
            f = ex.extract(wav)
        else:
            f = ex.encoder(wav[None], mode="avg_norm")[0].T.cpu().numpy()
        feats[utt] = f
        alis[utt] = np.loadtxt(os.path.join(data_root, alifile),
                               dtype=np.int64).reshape(-1)
    return feats, alis


def speaker_mean_norm_utts(feats):
    """Per-speaker mean subtraction; the speaker is the utt id's prefix
    before '_', its mean the mean of its utterances' mean frames."""
    spk_means = {}
    for utt, f in feats.items():
        spk_means.setdefault(utt.split("_")[0], []).append(f.mean(axis=0))
    mean = {s: np.mean(np.stack(v), axis=0) for s, v in spk_means.items()}
    return {u: f - mean[u.split("_")[0]] for u, f in feats.items()}


def run_timit_full_decoding(fe_cfg, fe_ckpt, data_root, train_list,
                            test_list, out_folder, mlp_cfg, dec_cfg,
                            max_utts=None, epochs=None, log=print,
                            device="cuda"):
    """Train the MLP on alignments, write the decode-ready ark and
    dec_cfg.ini, run decode_dnn.sh where it exists. List files hold
    ``wavpath alifile`` lines. Returns the metrics with ark_file,
    decode_rc and, after a decode, best_wer."""
    from pase_tpu_torch.probes.tasks import _read_list
    os.makedirs(out_folder, exist_ok=True)
    if isinstance(mlp_cfg, str):
        with open(mlp_cfg) as f:
            mlp_cfg = json.load(f)
    if isinstance(dec_cfg, str):
        with open(dec_cfg) as f:
            dec_cfg = json.load(f)
    left, right = int(mlp_cfg.get("left", 8)), int(mlp_cfg.get("right", 8))
    avg_spk = str(mlp_cfg.get("avg_spk", "True")) == "True"
    hidden = [int(h) for h in
              str(mlp_cfg.get("dnn_lay", "1024,1973")).split(",")][:-1]
    n_epochs = epochs if epochs is not None else int(
        mlp_cfg.get("N_epochs", 24))

    ex = FeatureExtractor(fe_cfg, fe_ckpt, mode=None, device=device)
    tr_f, tr_a = _load_split(ex, _read_list(train_list)[:max_utts],
                             data_root, avg_spk)
    te_f, te_a = _load_split(ex, _read_list(test_list)[:max_utts],
                             data_root, avg_spk)
    if avg_spk:
        tr_f = speaker_mean_norm_utts(tr_f)
        te_f = speaker_mean_norm_utts(te_f)

    # the reference's context window drops the first `left` and last
    # `right` frames; ours replicates the edges, so trim both sides (the
    # interior windows are the same)
    def trim(x):
        return x[left:-right] if right > 0 else x[left:]

    def assemble(feats, alis):
        fl, ll = [], []
        for utt in feats:
            f = reconcile_lengths(feats[utt], alis[utt], utt)
            fl.append(trim(context_window(f, left, right)))
            ll.append(trim(alis[utt]))
        return np.concatenate(fl), np.concatenate(ll)

    x_tr, y_tr = assemble(tr_f, tr_a)
    x_te, y_te = assemble(te_f, te_a)
    y_tr = y_tr - y_tr.min()
    y_te = y_te - y_te.min()
    _, counts = compute_prior_counts(list(tr_a.values()), out_folder)
    num_classes = int(max(y_tr.max(), y_te.max())) + 1

    model, metrics = train_mlp_probe(
        x_tr, y_tr.astype(np.int32), x_te, y_te.astype(np.int32),
        num_classes=num_classes, hidden=hidden, epochs=n_epochs,
        lr=float(mlp_cfg.get("lr", 0.036)),
        halving_factor=float(mlp_cfg.get("halving_factor", 0.5)),
        improvement_threshold=0.0025,
        batch_size=int(mlp_cfg.get("batch_size", 128)),
        seed=int(mlp_cfg.get("seed", 1234)),
        dropout=float(str(mlp_cfg.get("dnn_drop", "0.15")).split(",")[0]),
        log=log, device=device)

    # decode-ready posteriors: log-softmax minus log-priors, over the full
    # (not length-reconciled) features
    log_counts = np.log(counts / counts.sum()).astype(np.float32)
    ark_file = os.path.join(out_folder, "post.ark")
    with open(ark_file, "wb") as fd:
        for utt in te_f:
            x = trim(context_window(te_f[utt], left, right))
            pout = predict(model, x).cpu().numpy()
            if pout.shape[1] == len(log_counts):
                pout = pout - log_counts[None, :]
            write_kaldi_mat(fd, pout, utt)

    write_dec_cfg_ini(dec_cfg, os.path.join(out_folder, "dec_cfg.ini"))
    rc = run_decoding(dec_cfg, out_folder, ark_file, log=log)
    result = dict(metrics)
    result["ark_file"] = ark_file
    result["decode_rc"] = rc
    if rc == 0:
        wer = parse_best_wer(os.path.join(out_folder, "dec"))
        result["best_wer"] = wer
        if log and wer is not None:
            log(f"BEST WER/PER: {wer:.2f}%")
    return result
