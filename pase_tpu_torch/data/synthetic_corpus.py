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

    write_synthetic_ami(root, n_meetings=4, meeting_seconds=330)

writes a seeded meeting tree in AMI's layout: per meeting
``<meet>/audio/<meet>.Headset-<h>.wav`` (one synthetic speaker per
headset, talking in bursts of 2-6 s between pauses of 0.8-2.5 s over a
faint floor) and ``<meet>/audio/<meet>.Array1-0<c>.wav`` for c = 1..8
(each a mix of the headsets, each delayed by 0-40 samples and attenuated
by 0.15-0.6, plus noise), the tree ``data_prep ami-segment`` reads.
"""

import json
import os

import numpy as np

from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
from pase_tpu_torch.data.io import write_wav

SR = 16000
# an AMI meeting's headsets and Array1 channels
AMI_HEADSETS, AMI_CHANNELS = 4, 8


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


def _bursts(n, rng):
    """An on / off mask of n samples: bursts of 2-6 s between pauses of
    0.8-2.5 s (the first a pause), with 10 ms ramps."""
    mask = np.zeros(n, np.float32)
    pos = int(rng.uniform(0.8, 2.5) * SR)
    ramp = np.linspace(0.0, 1.0, SR // 100, dtype=np.float32)
    while pos < n:
        length = int(rng.uniform(2.0, 6.0) * SR)
        seg = np.ones(min(length, n - pos), np.float32)
        r = min(len(ramp), len(seg) // 2)
        if r:
            seg[:r] = ramp[:r]
            seg[len(seg) - r:] = ramp[:r][::-1]
        mask[pos:pos + len(seg)] = seg
        pos += length + int(rng.uniform(0.8, 2.5) * SR)
    return mask


def write_synthetic_ami(root, n_meetings=4, meeting_seconds=330.0, seed=0):
    """Write the AMI-layout meeting tree (module docstring) under
    ``root``; returns the meeting ids."""
    rng = np.random.RandomState(seed)
    signal = SyntheticChunkBatcher(1, 0, seed=seed + 1)
    n = int(meeting_seconds * SR)
    meetings = [f"ES{2002 + m}a" for m in range(n_meetings)]
    for meet in meetings:
        folder = os.path.join(root, meet, "audio")
        os.makedirs(folder, exist_ok=True)
        heads = []
        for h in range(AMI_HEADSETS):
            f0 = rng.uniform(80, 260, size=(1, 1))
            tilt = rng.uniform(0.7, 1.5, size=(1, 1))
            wav = (signal._speechlike(f0, tilt, n)[0] * _bursts(n, rng)
                   + 0.002 * rng.randn(n).astype(np.float32))
            write_wav(os.path.join(folder, f"{meet}.Headset-{h}.wav"), wav)
            heads.append(wav)
        for c in range(1, AMI_CHANNELS + 1):
            mix = 0.01 * rng.randn(n).astype(np.float32)
            for wav in heads:
                d = rng.randint(0, 41)
                mix[d:] += rng.uniform(0.15, 0.6) * wav[:n - d]
            write_wav(os.path.join(folder, f"{meet}.Array1-0{c}.wav"), mix)
    return meetings
