"""Downstream probe tasks on frozen encoder features.

The port of ``pase_tpu/probes/tasks.py``:

* ``run_utt_classification`` — utterance classification (speaker ID on
  MiniVoxCeleb, language ID, emotion on IEMOCAP): 'avg_concat' features,
  global mean / std normalization, an MLP on frames, frame and sentence
  accuracy;
* ``run_knn_probe`` — KNN on utterance-mean embeddings;
* ``run_frame_classification`` — frame classification on alignments
  (TIMIT's frame error rate), per-speaker mean normalization and a
  context window; ``write_posteriors_ark`` dumps a text ark of
  log-posteriors minus log-priors for external decoding;
* ``run_kfold_classification`` — class-stratified k-fold utterance
  classification (a linear classifier unless ``hidden`` is given).

Every task extracts and trains on ``device`` (the card unless 'cpu').
List files hold ``wavpath label`` lines (utterance tasks) or ``wavpath
alifile`` lines (frame tasks; one int per 10 ms frame).
"""

import os

import numpy as np

from pase_tpu_torch.probes.classifier import (context_window,
                                              frame_error_rate,
                                              knn_classify, predict,
                                              sentence_accuracy,
                                              train_mlp_probe)
from pase_tpu_torch.probes.extract import FeatureExtractor, speaker_mean_norm
from pase_tpu_torch.utils import kfold_data


def _read_list(path):
    out = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) >= 2:
                out.append((parts[0], parts[1]))
    return out


def _global_norm(train_feats):
    allf = np.concatenate(train_feats, axis=0)
    mean = allf.mean(axis=0)
    std = allf.std(axis=0) + 1e-8
    return mean, std


def run_utt_classification(fe_cfg, fe_ckpt, train_list, test_list,
                           data_root="", mode="avg_concat", hidden=(256,),
                           epochs=20, lr=0.1, batch_size=2048, seed=0,
                           max_utts=None, log=print, feature_type="pase",
                           device="cuda"):
    """Frame and sentence accuracy of an MLP probe on the test list; a
    test label absent from the train list raises ValueError before any
    extraction. feature_type 'mfcc' / 'fbank' runs the classical-feature
    baseline."""
    ex = FeatureExtractor(fe_cfg, fe_ckpt, mode=mode,
                          feature_type=feature_type, device=device)
    tr = _read_list(train_list)[:max_utts]
    te = _read_list(test_list)[:max_utts]
    labels = sorted({l for _, l in tr})
    lab2i = {l: i for i, l in enumerate(labels)}

    unseen = sorted({l for _, l in te} - set(labels))
    if unseen:
        # a max_utts-truncated train list can miss classes of the test
        # list: fail before extraction, not with a KeyError after it
        raise ValueError(f"test labels absent from the train list: "
                         f"{unseen} (raise --max_utts?)")

    def load(split):
        feats, ys = [], []
        for path, lab in split:
            feats.append(ex.extract_file(os.path.join(data_root, path)))
            ys.append(lab2i[lab])
        return feats, ys

    tr_f, tr_y = load(tr)
    te_f, te_y = load(te)
    mean, std = _global_norm(tr_f)
    tr_f = [(f - mean) / std for f in tr_f]
    te_f = [(f - mean) / std for f in te_f]
    x_tr = np.concatenate(tr_f, axis=0)
    y_tr = np.concatenate([np.full(len(f), y) for f, y in zip(tr_f, tr_y)])
    x_te = np.concatenate(te_f, axis=0)
    y_te = np.concatenate([np.full(len(f), y) for f, y in zip(te_f, te_y)])
    model, metrics = train_mlp_probe(
        x_tr, y_tr.astype(np.int32), x_te, y_te.astype(np.int32),
        num_classes=len(labels), hidden=hidden, epochs=epochs, lr=lr,
        batch_size=batch_size, seed=seed, log=log, device=device)
    metrics["test_frame_acc"] = 1.0 - metrics["dev_frame_error"]
    metrics["test_sentence_acc"] = sentence_accuracy(model, te_f, te_y)
    if log:
        log(f"FINAL test sentence acc: {metrics['test_sentence_acc']:.4f}")
    return metrics


def run_knn_probe(fe_cfg, fe_ckpt, train_list, test_list, data_root="",
                  mode="avg_concat", k=5, max_utts=None, log=print,
                  device="cuda"):
    """KNN accuracy on utterance-mean embeddings."""
    ex = FeatureExtractor(fe_cfg, fe_ckpt, mode=mode, device=device)
    tr = _read_list(train_list)[:max_utts]
    te = _read_list(test_list)[:max_utts]
    labels = sorted({l for _, l in tr})
    lab2i = {l: i for i, l in enumerate(labels)}

    def embed(split):
        xs, ys = [], []
        for path, lab in split:
            f = ex.extract_file(os.path.join(data_root, path))
            xs.append(f.mean(axis=0))
            ys.append(lab2i[lab])
        return np.stack(xs), np.asarray(ys)

    xtr, ytr = embed(tr)
    xte, yte = embed(te)
    pred = knn_classify(xtr, ytr, xte, k=k, num_classes=len(labels),
                        device=device)
    acc = float((pred == yte).mean())
    if log:
        log(f"KNN (k={k}) test acc: {acc:.4f}")
    return {"knn_test_acc": acc}


def run_frame_classification(fe_cfg, fe_ckpt, train_list, test_list,
                             data_root="", num_classes=48, left=8, right=8,
                             hidden=(1024,), epochs=10, lr=0.1,
                             utt2spk=None, max_utts=None, log=print,
                             device="cuda"):
    """Frame error rate of an MLP on context-windowed frames against
    their alignments (TIMIT's fast probe)."""
    ex = FeatureExtractor(fe_cfg, fe_ckpt, mode=None, device=device)
    tr = _read_list(train_list)[:max_utts]
    te = _read_list(test_list)[:max_utts]

    def load(split):
        feats, alis = {}, {}
        for path, alifile in split:
            f = ex.extract_file(os.path.join(data_root, path))
            a = np.loadtxt(os.path.join(data_root, alifile),
                           dtype=np.int32).reshape(-1)
            n = min(len(f), len(a))
            feats[path] = f[:n]
            alis[path] = a[:n]
        return feats, alis

    tr_f, tr_a = load(tr)
    te_f, te_a = load(te)
    if utt2spk:
        tr_f = speaker_mean_norm(tr_f, utt2spk)
        te_f = speaker_mean_norm(te_f, utt2spk)
    x_tr = np.concatenate([context_window(f, left, right)
                           for f in tr_f.values()])
    y_tr = np.concatenate(list(tr_a.values()))
    x_te = np.concatenate([context_window(f, left, right)
                           for f in te_f.values()])
    y_te = np.concatenate(list(te_a.values()))
    _, metrics = train_mlp_probe(x_tr, y_tr, x_te, y_te,
                                 num_classes=num_classes, hidden=hidden,
                                 epochs=epochs, lr=lr, log=log,
                                 device=device)
    metrics["test_fer"] = metrics["dev_frame_error"]
    if log:
        log(f"FINAL test FER: {metrics['test_fer']:.4f}")
    return metrics


def write_posteriors_ark(model, utt_feats, log_priors, out_path, left=8,
                         right=8):
    """A Kaldi text ark of log-posteriors minus log-priors per utterance,
    for external HMM decoding."""
    with open(out_path, "w") as f:
        for utt, feats in utt_feats.items():
            out = predict(model, context_window(feats, left, right))
            mat = out.cpu().numpy() - log_priors[None, :]
            f.write(f"{utt}  [\n")
            for row in mat:
                f.write("  " + " ".join(f"{v:.6f}" for v in row) + "\n")
            f.write("]\n")


def run_kfold_classification(fe_cfg, fe_ckpt, data_list, data_root="",
                             folds=10, valid_p=0.1, mode="avg_concat",
                             hidden=(), epochs=15, lr=0.05,
                             batch_size=2048, seed=0, max_utts=None,
                             log=print, feature_type="pase",
                             device="cuda"):
    """K-fold utterance classification over ``kfold_data`` splits: per
    fold a linear (or, with ``hidden``, MLP) frame classifier, its lr
    halving driven by the fold's valid split (by the test fold only when
    ``valid_p`` leaves no valid item); the mean and std of the folds'
    frame and sentence accuracies."""
    entries = _read_list(data_list)[:max_utts]
    utt2class = {p: l for p, l in entries}
    labels = sorted(set(utt2class.values()))
    lab2i = {l: i for i, l in enumerate(labels)}
    ex = FeatureExtractor(fe_cfg, fe_ckpt, mode=mode,
                          feature_type=feature_type, device=device)
    feats = {p: ex.extract_file(os.path.join(data_root, p))
             for p, _ in entries}
    splits = kfold_data([p for p, _ in entries], utt2class, folds=folds,
                        valid_p=valid_p, seed=seed)
    frame_accs, sent_accs = [], []
    for fi, (tr, va, te) in enumerate(splits):
        mean, std = _global_norm([feats[p] for p in tr])

        def flat(paths):
            fs = [(feats[p] - mean) / std for p in paths]
            ys = [lab2i[utt2class[p]] for p in paths]
            x = np.concatenate(fs, axis=0)
            y = np.concatenate([np.full(len(f), yy)
                                for f, yy in zip(fs, ys)])
            return fs, ys, x, y.astype(np.int32)

        _, _, x_tr, y_tr = flat(tr)
        te_f, te_y, x_te, y_te = flat(te)
        if va:
            _, _, x_dev, y_dev = flat(va)
        else:
            x_dev, y_dev = x_te, y_te
        model, _ = train_mlp_probe(
            x_tr, y_tr, x_dev, y_dev, num_classes=len(labels),
            hidden=tuple(hidden), epochs=epochs, lr=lr,
            batch_size=batch_size, seed=seed + fi, log=None, device=device)
        fa = 1.0 - frame_error_rate(model, x_te, y_te)
        sa = sentence_accuracy(model, te_f, te_y)
        frame_accs.append(fa)
        sent_accs.append(sa)
        if log:
            log(f"fold {fi}: frame acc {fa:.4f}, sentence acc {sa:.4f}")
    out = {
        "folds": folds,
        "frame_acc_mean": float(np.mean(frame_accs)),
        "frame_acc_std": float(np.std(frame_accs)),
        "sentence_acc_mean": float(np.mean(sent_accs)),
        "sentence_acc_std": float(np.std(sent_accs)),
    }
    if log:
        log(f"KFOLD: sentence acc {out['sentence_acc_mean']:.4f} "
            f"+- {out['sentence_acc_std']:.4f}")
    return out
