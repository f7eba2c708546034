"""Transfer gate: self-supervised pretraining must improve a downstream
probe over a random-init encoder (the port of
``experiments/transfer_gate.py``).

  python -m pase_tpu_torch.transfer_gate --epochs 8 --bpe 250 \\
      --json gate.json [--device cpu]

1. A speaker-ID probe corpus that a random encoder does not saturate:
   speakers drawn from a continuum (base f0 spacing far below the
   per-utterance f0 jitter, so pitch alone cannot identify a speaker),
   identity carried by an 8-harmonic timbre vector and a spectral tilt,
   every utterance RMS-normalized so energy carries none.
2. PASE pretraining (this package's ``Trainer``, base policy, mfcc /
   fbank / prosody regression and the LIM worker) on fresh speakers of
   the same family, an ``FE_e{e}.npz`` per epoch.
3. The frozen-encoder speaker-ID MLP probe (``probes.tasks.
   run_utt_classification``, 'avg_concat') on every snapshot, on the
   random-init encoder and on MFCCs.

Gate (``ok``): the final pretrained probe beats the random-init one by at
least ``--min_margin`` sentence accuracy, and the margin is positive over
the last half of the snapshots. The corpus and the batches are the JAX
experiment's bit for bit: each utterance's random draws are taken in the
same order from the same stream, and the rendering (the harmonics'
sines, the same arithmetic) runs in worker processes, so the host keeps
up with the card. Pretraining and probes run on ``--device`` (default
the card).
"""

import argparse
import concurrent.futures
import itertools
import json
import multiprocessing
import os
import shutil
import sys
import tempfile

import numpy as np

SR = 16000

FE_CFG = {
    "kwidths": [65, 20, 11, 11], "strides": [1, 10, 4, 4],
    "fmaps": [64, 64, 128, 128], "emb_dim": 128, "norm_out": True,
}

WORKERS_CFG = {
    "regr": [
        {"num_outputs": 39, "dropout": 0, "hidden_size": 128,
         "hidden_layers": 1, "name": "mfcc", "r": 1,
         "loss": "MSELoss", "skip": False},
        {"num_outputs": 120, "dropout": 0, "hidden_size": 128,
         "hidden_layers": 1, "name": "fbank", "r": 1,
         "loss": "MSELoss", "skip": False},
        {"num_outputs": 12, "dropout": 0, "hidden_size": 128,
         "hidden_layers": 1, "name": "prosody", "r": 1,
         "loss": "MSELoss", "skip": False},
    ],
    "cls": [
        {"num_outputs": 1, "dropout": 0, "hidden_size": 128,
         "hidden_layers": 1, "name": "mi",
         "loss": "BCEWithLogitsLoss", "skip": False},
    ],
}
# the processes that render utterances (a core is left to the caller's
# own threads), utterances per task, batches rendered ahead
RENDER_PROCS = max(1, min(7, (os.cpu_count() or 2) - 1))
RENDER_CHUNK = 8
PREFETCH = 4


# ---------------------------------------------------------------------------
# the synthetic speaker family
# ---------------------------------------------------------------------------


def sample_speaker(rng):
    """A point on the speaker continuum: base pitch, an 8-harmonic
    timbre direction, spectral tilt, vibrato rate."""
    return {
        "f0": float(rng.uniform(105.0, 245.0)),
        "timbre": rng.dirichlet(np.ones(8) * 2.0),
        "tilt": float(rng.uniform(0.8, 1.4)),
        "vib": float(rng.uniform(3.0, 7.0)),
    }


def draw_utterance(rng, spk, t):
    """The random draws of one utterance of ``t`` samples, in the order
    the JAX experiment's ``utterance`` takes them from ``rng`` (which
    ``render_utterance`` then renders)."""
    d = {"f0u": spk["f0"] * rng.uniform(0.93, 1.07),
         "vib_phase": rng.uniform(0, 2 * np.pi),
         "drift_rate": rng.uniform(0.3, 1.0),
         "drift_phase": rng.uniform(0, 2 * np.pi),
         "jitter": rng.uniform(0.8, 1.25, size=8),
         "phases": rng.uniform(0, 2 * np.pi, size=8),
         "env_rate": rng.uniform(1.5, 4.0),
         "env_phase": rng.uniform(0, 2 * np.pi),
         "noise": rng.randn(t)}
    return spk, d, t


def render_utterance(spk, d, t, sr=SR):
    """One utterance of ``draw_utterance``'s draws: an f0 contour around
    the speaker's base (utterance shift +-7 %, vibrato and a slow drift,
    far wider than the speaker spacing), jittered harmonic weights, a
    random amplitude envelope, a noise floor, RMS-normalized."""
    n = np.arange(t) / sr
    contour = d["f0u"] * (1.0
                          + 0.02 * np.sin(2 * np.pi * spk["vib"] * n
                                          + d["vib_phase"])
                          + 0.04 * np.sin(2 * np.pi * d["drift_rate"] * n
                                          + d["drift_phase"]))
    phase = 2 * np.pi * np.cumsum(contour) / sr
    w = spk["timbre"] * d["jitter"]
    ks = np.arange(1, 9)
    sig = np.zeros(t)
    for k, wk, ph in zip(ks, w, d["phases"]):
        sig += wk * np.sin(k * phase + ph) / (k ** spk["tilt"])
    env = 0.55 + 0.45 * np.sin(2 * np.pi * d["env_rate"] * n
                               + d["env_phase"])
    x = sig * env + d["noise"] * 0.01
    x = x / max(float(np.sqrt(np.mean(x ** 2))), 1e-8) * 0.1
    return x.astype(np.float32)


def _render_chunk(draws):
    return [render_utterance(*d) for d in draws]


def _render_pool():
    """The worker processes that render utterances, spawned (the parent
    may hold threads and a CUDA context): a script that builds the corpus
    or draws batches keeps its own work under ``if __name__ ==
    "__main__"``, since each worker imports it."""
    return concurrent.futures.ProcessPoolExecutor(
        RENDER_PROCS, mp_context=multiprocessing.get_context("spawn"))


def _rendered(pool, draw_lists):
    """Each list of ``draw_utterance`` draws rendered in ``pool``, in
    order; the next list is drawn while the pool renders the current
    one."""
    pending = None
    for draws in draw_lists:
        futs = [pool.submit(_render_chunk, draws[i:i + RENDER_CHUNK])
                for i in range(0, len(draws), RENDER_CHUNK)]
        if pending is not None:
            yield [w for f in pending for w in f.result()]
        pending = futs
    if pending is not None:
        yield [w for f in pending for w in f.result()]


def build_probe_corpus(root, n_spk=30, n_train=20, n_test=8, utt_sec=2.0,
                       seed=100):
    """Disk corpus (``{split}_spk{si}_{u}.wav``) and train.lst /
    test.lst (``wav speaker`` lines) under root."""
    from pase_tpu_torch.data.io import write_wav
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    spks = [sample_speaker(rng) for _ in range(n_spk)]
    t = int(utt_sec * SR)
    # (file, split, speaker) in the order the utterances are drawn
    utts = [(f"{split}_spk{si:02d}_{u:02d}.wav", split, f"spk{si:02d}")
            for si in range(n_spk)
            for split, n_utt in (("train", n_train), ("test", n_test))
            for u in range(n_utt)]
    draws = ([draw_utterance(rng, spk, t) for _ in range(n_train + n_test)]
             for spk in spks)
    with _render_pool() as pool:
        wavs = itertools.chain.from_iterable(_rendered(pool, draws))
        for (fname, _, _), w in zip(utts, wavs):
            write_wav(os.path.join(root, fname), w)
    for split in ("train", "test"):
        with open(os.path.join(root, f"{split}.lst"), "w") as f:
            for fname, s, lab in utts:
                if s == split:
                    f.write(f"{fname} {lab}\n")
    return root


class SpeakerFamilyBatcher:
    """Pretraining batches from the same family, fresh speakers every
    batch (a stream apart from the probe corpus's): chunk and chunk_ctxt
    share a speaker, chunk_rand has another. A thread takes the draws in
    order and ``RENDER_PROCS`` processes render the utterances, a few
    batches ahead of the consumer."""

    def __init__(self, batch_size, chunk_size, seed=0, bpe=100):
        self.batch_size = batch_size
        self.chunk_size = chunk_size
        self.rng = np.random.RandomState(seed)
        self.bpe = bpe

    def _draws(self):
        b, t = self.batch_size, self.chunk_size
        while True:
            draws = []
            for _ in range(b):
                spk = sample_speaker(self.rng)
                other = sample_speaker(self.rng)
                draws += [draw_utterance(self.rng, spk, t),
                          draw_utterance(self.rng, spk, t),
                          draw_utterance(self.rng, other, t)]
            yield draws

    def _batches(self):
        b, t = self.batch_size, self.chunk_size
        with _render_pool() as pool:
            for wavs in _rendered(pool, self._draws()):
                x = np.stack(wavs).reshape(b, 3, t)
                yield {"chunk": x[:, 0].copy(), "chunk_ctxt": x[:, 1].copy(),
                       "chunk_rand": x[:, 2].copy()}

    def __iter__(self):
        from pase_tpu_torch.data.dataset import ThreadedPrefetcher
        return iter(ThreadedPrefetcher(lambda _: self._batches(),
                                       n_threads=1, prefetch=PREFETCH))


# ---------------------------------------------------------------------------
# protocol
# ---------------------------------------------------------------------------


def probe_acc(fe_ckpt, corpus, epochs=12, feature_type="pase", seed=0,
              device="cuda"):
    """Test sentence accuracy of the speaker-ID probe on the corpus."""
    from pase_tpu_torch.probes.tasks import run_utt_classification
    m = run_utt_classification(
        dict(FE_CFG), fe_ckpt, os.path.join(corpus, "train.lst"),
        os.path.join(corpus, "test.lst"), data_root=corpus,
        mode="avg_concat", hidden=(256,), epochs=epochs, lr=0.05,
        batch_size=512, seed=seed, log=None, feature_type=feature_type,
        device=device)
    return float(m["test_sentence_acc"])


def run(opts, workdir):
    """Build the corpus, pretrain, probe every snapshot; returns the
    gate's record."""
    from pase_tpu_torch.checkpoint import save_variables_npz
    from pase_tpu_torch.data.pipeline import compute_stats
    from pase_tpu_torch.model import parse_workers_cfg
    from pase_tpu_torch.trainer import Trainer

    device = opts.device
    corpus = os.path.join(workdir, "probe_corpus")
    print("[transfer] building probe corpus ...")
    build_probe_corpus(corpus, n_spk=opts.n_spk, n_train=opts.n_train,
                       n_test=opts.n_test, seed=100)

    save_path = os.path.join(workdir, "pretrain")
    meta = parse_workers_cfg(json.loads(json.dumps(WORKERS_CFG)))
    stats = compute_stats(SpeakerFamilyBatcher(16, opts.chunk_size, seed=7),
                          meta, max_batches=4, device=device)
    cfg = dict(backprop_mode="base", hop=160, bpe=opts.bpe,
               epoch=opts.epochs, batch_size=opts.batch_size,
               chunk_size=opts.chunk_size, log_freq=max(opts.bpe // 2, 1),
               fe_lr=5e-4, min_lr=5e-4, lr_mode="poly",
               save_path=save_path, seed=1)
    tr = Trainer(dict(FE_CFG), json.loads(json.dumps(WORKERS_CFG)), cfg,
                 stats=stats, device=device)

    # epoch -1: the random-init encoder, the same architecture
    rand_ckpt = os.path.join(workdir, "FE_random.npz")
    save_variables_npz(rand_ckpt, tr.model.frontend.state_dict(), 0)

    print(f"[transfer] pretraining {opts.epochs} epochs x {opts.bpe} "
          f"steps ...")
    try:
        tr.train_(SpeakerFamilyBatcher(opts.batch_size, opts.chunk_size,
                                       seed=9), epochs=opts.epochs,
                  resume=False)
    finally:
        tr.logger.close()

    print("[transfer] probing snapshots ...")
    accs = {"random": probe_acc(rand_ckpt, corpus, epochs=opts.probe_epochs,
                                device=device)}
    curve = []
    for e in range(opts.epochs):
        ck = os.path.join(save_path, f"FE_e{e}.npz")
        acc = probe_acc(ck, corpus, epochs=opts.probe_epochs, device=device)
        curve.append({"epoch": e, "acc": acc,
                      "margin": acc - accs["random"]})
        print(f"[transfer]   epoch {e}: acc {acc:.3f} "
              f"(margin {acc - accs['random']:+.3f})")
    accs["pretrained_final"] = curve[-1]["acc"]
    accs["mfcc_baseline"] = probe_acc(None, corpus,
                                      epochs=opts.probe_epochs,
                                      feature_type="mfcc", device=device)
    out = {
        "n_speakers": opts.n_spk,
        "chance": 1.0 / opts.n_spk,
        "random_encoder_acc": accs["random"],
        "mfcc_baseline_acc": accs["mfcc_baseline"],
        "pretrained_final_acc": accs["pretrained_final"],
        "margin_final": accs["pretrained_final"] - accs["random"],
        "curve": curve,
        "epochs": opts.epochs, "bpe": opts.bpe,
        "batch_size": opts.batch_size, "chunk_size": opts.chunk_size,
    }
    tail = curve[len(curve) // 2:]
    out["tail_margins_positive"] = all(c["margin"] > 0 for c in tail)
    out["ok"] = (out["margin_final"] >= opts.min_margin
                 and out["tail_margins_positive"])
    return out


def build_argparser():
    ap = argparse.ArgumentParser(prog="python -m pase_tpu_torch.transfer_gate")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--bpe", type=int, default=250)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--chunk_size", type=int, default=16000)
    ap.add_argument("--n_spk", type=int, default=30)
    ap.add_argument("--n_train", type=int, default=20)
    ap.add_argument("--n_test", type=int, default=8)
    ap.add_argument("--probe_epochs", type=int, default=12)
    ap.add_argument("--min_margin", type=float, default=0.05)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where pretraining and probes run (default: the "
                         "card)")
    return ap


def main(argv=None):
    """Run the gate; prints its record and PASS / FAIL. Returns 0 when
    the gate holds, else 1."""
    opts = build_argparser().parse_args(argv)
    import torch
    from pase_tpu_torch.precision import full_precision
    full_precision()        # float32 as the JAX gate's: no TF32
    if opts.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device "
                           "(torch.cuda.is_available() is False)")
    workdir = opts.workdir or tempfile.mkdtemp(prefix="transfer_gate_")
    try:
        out = run(opts, workdir)
    finally:
        if opts.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({k: v for k, v in out.items() if k != "curve"},
                     indent=1))
    if opts.json:
        with open(opts.json, "w") as f:
            json.dump(out, f, indent=1)
    print("[transfer]", "PASS" if out["ok"] else "FAIL",
          f"(pretrained {out['pretrained_final_acc']:.3f} vs random "
          f"{out['random_encoder_acc']:.3f} vs mfcc "
          f"{out['mfcc_baseline_acc']:.3f}, chance {out['chance']:.3f})")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
