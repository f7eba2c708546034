"""A seeded synthetic wav corpus on disk, in LibriSpeech's layout.

    write_synthetic_corpus(root, train_seconds=7200, valid_seconds=120)

writes ``{spk}-{chap}-{utt:04d}.wav`` files (16 kHz PCM16) under
``root/wav`` and their data cfg (``root/data_cfg.json``: per split the
file list, speakers and total_wav_dur in samples), the layout that
``--data_root`` / ``--data_cfg`` of the training and statistics CLIs and
``LibriSpeechTupleDataset`` read. Each chapter holds several utterances,
so every utterance has same-prefix neighbors; the utterances of a
chapter are speech-like signals of one synthetic speaker (the
``SyntheticChunkBatcher`` family: five harmonics of one f0 with a 1/k^tilt
spectrum, a slow envelope, noise), so the contrastive tasks have
something to learn. Lengths are uniform in [min_seconds, max_seconds].
"""

import json
import os

import numpy as np

from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
from pase_tpu_torch.data.io import write_wav

SR = 16000


def write_synthetic_corpus(root, train_seconds, valid_seconds, seed=0,
                           utts_per_chapter=4, min_seconds=1.0,
                           max_seconds=16.0):
    """Write the corpus under ``root``; returns (wav root, data cfg path).
    Each split gets utterances until its audio reaches its seconds."""
    wav_root = os.path.join(root, "wav")
    os.makedirs(wav_root, exist_ok=True)
    rng = np.random.RandomState(seed)
    signal = SyntheticChunkBatcher(1, 0, seed=seed + 1)
    cfg = {}
    spk = 100
    for split, seconds in (("train", train_seconds),
                           ("valid", valid_seconds)):
        files, speakers, total = [], [], 0
        while total < seconds * SR:
            spk += 1
            speakers.append(str(spk))
            f0 = rng.uniform(80, 260, size=(1, 1))
            tilt = rng.uniform(0.7, 1.5, size=(1, 1))
            for utt in range(utts_per_chapter):
                n = int(rng.uniform(min_seconds, max_seconds) * SR)
                name = f"{spk}-{spk * 10}-{utt:04d}.wav"
                write_wav(os.path.join(wav_root, name),
                          signal._speechlike(f0, tilt, n)[0])
                files.append({"filename": name, "speaker": str(spk)})
                total += n
        cfg[split] = {"data": files, "speakers": speakers,
                      "total_wav_dur": total}
    cfg["speakers"] = cfg["train"]["speakers"] + cfg["valid"]["speakers"]
    cfg_path = os.path.join(root, "data_cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    return wav_root, cfg_path
