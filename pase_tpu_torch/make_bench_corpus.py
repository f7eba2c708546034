"""Build an on-disk synthetic corpus and its distortion assets in the
layout the 50 h LibriSpeech recipe reads, so the disk-fed data path (wav
decode, tuple sampling, batching, the card-resident corpus, the
distortions and targets in the step) runs end to end with the training
CLI.

The flags and the files of ``experiments/make_bench_corpus.py``, written
by the same numpy code from the same ``--seed``, so the two scripts'
files are equal byte for byte (``dist.cfg``'s ``_source`` note aside):

  wavs/<spk>-<book>-<utt>.wav      Libri-style names (the filename-prefix
                                   neighbour scheme needs the trailing
                                   digit-run utterance index)
  tr.scp                           the utterance list
  data.cfg                         train / valid split (``data_prep``'s
                                   ``build_cfg``)
  noises/*.wav                     the noise bank of noises_dir
  irs/*.npy                        impulse responses for reverb
  filters/filter_16_to_8.npy       the downsample FIR
  overlap.scp                      the overlap list
  dist.cfg                         pase+.cfg's probabilities wired to the
                                   local assets

Usage:
  python -m pase_tpu_torch.make_bench_corpus --out_root /tmp/bench_corpus \\
      --hours 2
  python -m pase_tpu_torch.train --net_cfg cfg/workers/workers+.cfg \\
      --fe_cfg cfg/frontend/PASE+.cfg --data_root /tmp/bench_corpus/wavs \\
      --data_cfg /tmp/bench_corpus/data.cfg \\
      --dtrans_cfg /tmp/bench_corpus/dist.cfg \\
      --batch_size 32 --chunk_size 32000 --epoch 2 \\
      --save_path /tmp/bench_run --log_freq 25
"""

import argparse
import json
import os

import numpy as np

SR = 16000
# utterances per (speaker, book): the prefix scheme finds neighbours
PER_BOOK = 10


def build_argparser():
    p = argparse.ArgumentParser(
        prog="python -m pase_tpu_torch.make_bench_corpus")
    p.add_argument("--out_root", required=True)
    p.add_argument("--hours", type=float, default=2.0)
    p.add_argument("--seg_s", type=float, default=8.0)
    p.add_argument("--n_speakers", type=int, default=40)
    p.add_argument("--seed", type=int, default=0)
    return p


def write_utterances(opts, wav_dir, rng):
    """The corpus's wavs; returns their names. Each filename speaker has a
    fixed base (f0, tilt) that its utterances jitter around, so the label
    identifies the voice and a speaker-ID probe measures the
    representation, not label noise."""
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    from pase_tpu_torch.data.io import write_wav
    seg = int(opts.seg_s * SR)
    n_utts = int(opts.hours * 3600 / opts.seg_s)
    gen = SyntheticChunkBatcher(1, seg, seed=opts.seed)
    print(f"writing {n_utts} x {opts.seg_s:.0f}s utterances "
          f"({opts.hours:.1f} h) ...")
    spk_f0 = rng.uniform(95, 250, opts.n_speakers)
    spk_tilt = rng.uniform(0.75, 1.45, opts.n_speakers)
    names = []
    for i in range(n_utts):
        si = (i // (PER_BOOK * 4)) % opts.n_speakers
        spk = 100 + si
        book = 10000 + (i // PER_BOOK) % 4000
        utt = i % PER_BOOK
        f0 = np.array([[spk_f0[si] * rng.uniform(0.94, 1.06)]])
        tilt = np.array([[spk_tilt[si] + rng.uniform(-0.08, 0.08)]])
        wav = gen._speechlike(f0, tilt, seg)[0]
        name = f"{spk}-{book}-{utt:04d}.wav"
        write_wav(os.path.join(wav_dir, name), np.clip(wav, -1, 1), SR)
        names.append(name)
    return names


def write_assets(out_root, names, wav_dir, rng):
    """The distortion assets and ``dist.cfg``, after the wavs from the
    same ``rng``."""
    from pase_tpu_torch.data.io import write_wav
    noise_dir = os.path.join(out_root, "noises")
    os.makedirs(noise_dir, exist_ok=True)
    for i in range(12):
        n = rng.randn(4 * SR).astype(np.float32)
        # each file's noise coloured by its own moving average
        k = rng.randint(1, 5)
        n = np.convolve(n, np.ones(k) / k, mode="same")
        write_wav(os.path.join(noise_dir, f"noise_{i}.wav"),
                  np.clip(0.3 * n / np.abs(n).max(), -1, 1), SR)

    ir_dir = os.path.join(out_root, "irs")
    os.makedirs(ir_dir, exist_ok=True)
    ir_files = []
    for i in range(16):
        ln = rng.randint(2000, 16000)
        ir = rng.randn(ln).astype(np.float32) * \
            np.exp(-np.arange(ln, dtype=np.float32) / rng.uniform(300, 3000))
        ir[0] = 1.0
        fn = f"IR_{i:03d}.npy"
        np.save(os.path.join(ir_dir, fn), ir)
        ir_files.append(fn)

    filt_dir = os.path.join(out_root, "filters")
    os.makedirs(filt_dir, exist_ok=True)
    # linear-phase lowpass at 0.5 Nyquist (the 16 -> 8 kHz antialias FIR)
    taps = 257
    t = np.arange(taps) - taps // 2
    h = np.sinc(t * 0.5) * np.hamming(taps)
    np.save(os.path.join(filt_dir, "filter_16_to_8.npy"),
            (h / h.sum()).astype(np.float32))

    overlap_list = os.path.join(out_root, "overlap.scp")
    with open(overlap_list, "w") as f:
        f.write("\n".join(names[: min(200, len(names))]) + "\n")

    dist = {
        "_source": "pase+.cfg probabilities wired to synthetic local "
                   "assets (python -m pase_tpu_torch.make_bench_corpus)",
        "overlap_dir": wav_dir,
        "overlap_list": overlap_list,
        "overlap_snrs": [5, 7.5, 10],
        "overlap_reverb": True,
        "overlap_p": 0.1,
        "noises_dir": [noise_dir],
        "noises_snrs": [0, 5, 10],
        "noises_p": 0.4,
        "clip_factors": [0.1, 0.3, 0.5],
        "clip_p": 0.2,
        "chop_factors": [[0.05, 0.025], [0.1, 0.05]],
        "chop_p": 0.2,
        "downsample_data_root": filt_dir,
        "downsample_fmt": "npy",
        "downsample_irfiles": ["filter_16_to_8.npy"],
        "downsample_p": 0.25,
        "bandrop_data_root": filt_dir,
        "bandrop_fmt": "npy",
        "bandrop_irfiles": [],
        "bandrop_p": 0.35,
        "reverb_data_root": ir_dir,
        "reverb_fmt": "npy",
        "reverb_p": 0.5,
        "reverb_irfiles": ir_files,
    }
    with open(os.path.join(out_root, "dist.cfg"), "w") as f:
        json.dump(dist, f, indent=1)


def main(argv=None):
    opts = build_argparser().parse_args(argv)
    from pase_tpu_torch.data_prep import build_cfg
    wav_dir = os.path.join(opts.out_root, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    rng = np.random.RandomState(opts.seed + 1)
    names = write_utterances(opts, wav_dir, rng)
    scp = os.path.join(opts.out_root, "tr.scp")
    with open(scp, "w") as f:
        f.write("\n".join(names) + "\n")
    build_cfg(argparse.Namespace(
        data_root=wav_dir, train_scp=scp, test_scp=None, libri_dict=None,
        cfg_file=os.path.join(opts.out_root, "data.cfg"), val_ratio=0.1,
        seed=3))
    write_assets(opts.out_root, names, wav_dir, rng)
    print(f"corpus ready under {opts.out_root}")


if __name__ == "__main__":
    main()
