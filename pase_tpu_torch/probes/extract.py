"""Frozen-encoder feature extraction for the downstream probes.

``FeatureExtractor`` runs one utterance at a time (batch 1): the wav is
zero-padded to a multiple of ``pad_to`` samples, encoded with no output
mode, trimmed to the exact utterance's ceil(T/160) frames, and only then
``select_output`` applies the mode, so the 'avg_concat' / 'avg_norm'
statistics never see pad frames. ``feature_type`` 'mfcc' / 'fbank' gives
the classical-feature baseline instead (trimmed to T//160 frames). The
encoder and the baseline features run on the card unless ``device='cpu'``
asks for the CPU. ``speaker_mean_norm`` subtracts each speaker's mean
frame.
"""

import numpy as np
import torch

from pase_tpu_torch.data.io import read_wav
from pase_tpu_torch.frontend import select_output, wf_builder
from pase_tpu_torch.ops import features as FT

BASELINES = {"mfcc": FT.mfcc, "fbank": FT.fbanks}


class FeatureExtractor:
    """Frozen-encoder (or classical-feature baseline) extractor:
    ``extract(wav [T]) -> [frames, D]`` numpy, the mode applied."""

    def __init__(self, fe_cfg, ckpt_path=None, mode=None, pad_to=1600,
                 feature_type="pase", device="cuda"):
        if feature_type != "pase" and feature_type not in BASELINES:
            raise ValueError(f"feature_type {feature_type!r}: pase, "
                             f"{', '.join(BASELINES)}")
        self.feature_type = feature_type
        self.device = torch.device(device)
        self.encoder = None
        if feature_type == "pase":
            self.encoder = wf_builder(fe_cfg, device=device)
            if ckpt_path:
                self.encoder.load_pretrained(ckpt_path, load_last=True)
        self.mode = mode
        self.pad_to = pad_to

    def extract(self, wav):
        """[T] wav -> [frames, D] features (mode applied)."""
        t = len(wav)
        bucket = int(np.ceil(t / self.pad_to)) * self.pad_to
        x = np.zeros((1, bucket), dtype=np.float32)
        x[0, :t] = wav
        if self.feature_type != "pase":
            with torch.no_grad():
                y = BASELINES[self.feature_type](
                    torch.from_numpy(x).to(self.device))[0, :t // 160]
                y = select_output(y.T[None], self.mode)[0].T     # [F, D]
            return y.cpu().numpy()
        frames = int(np.ceil(t / 160))
        y = self.encoder(x, mode=None)[:, :, :frames]            # (1, D, F)
        return select_output(y, self.mode)[0].T.cpu().numpy()

    def extract_file(self, path):
        wav, _ = read_wav(path)
        return self.extract(wav)


def speaker_mean_norm(utt_feats, utt2spk):
    """Per-speaker mean subtraction: {utt: [F, D]} -> the same with each
    speaker's mean frame (over all its utterances' frames) subtracted."""
    sums, counts = {}, {}
    for utt, feats in utt_feats.items():
        spk = utt2spk[utt]
        sums[spk] = sums.get(spk, 0) + feats.sum(axis=0)
        counts[spk] = counts.get(spk, 0) + feats.shape[0]
    means = {s: sums[s] / counts[s] for s in sums}
    return {u: f - means[utt2spk[u]] for u, f in utt_feats.items()}
