"""Kaldi data-directory reader / writer.

The port of ``pase_tpu/data/kaldi_dir.py``: a Kaldi data dir is a
directory of space-separated ``<key> <value...>`` maps (utt2spk, wav.scp,
text, segments, spk2utt, utt2dur). The CHiME-5 pairing of
``data/prep.py`` (``chime5_pair``) walks the worn-mic and array
directories' transcripts through it.
"""

import os
import re


def _read_map(path):
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, _, val = line.partition(" ")
            out[key] = val.strip()
    return out


def _write_map(path, d):
    with open(path, "w") as f:
        for k in sorted(d):
            f.write(f"{k} {d[k]}\n")


class KaldiDataDir:
    """A Kaldi data directory as maps: ``utt2spk``, ``utt2wav`` (wav.scp;
    a value may be a sox pipe), ``utt2text``, ``utt2segments`` (utt ->
    (reco, beg_s, end_s)), ``spk2utt`` (from utt2spk when the file is
    absent) and ``utt2dur``."""

    def __init__(self, directory, preload=True):
        self.directory = directory
        self.utt2spk = {}
        self.utt2wav = {}
        self.utt2text = {}
        self.utt2segments = {}
        self.spk2utt = {}
        self.utt2dur = {}
        if preload:
            self.read()

    def _path(self, name):
        return os.path.join(self.directory, name)

    def read(self):
        read_any = False
        for name, target in (("utt2spk", self.utt2spk),
                             ("wav.scp", self.utt2wav),
                             ("text", self.utt2text)):
            p = self._path(name)
            if os.path.exists(p):
                target.update(_read_map(p))
                read_any = True
        if not read_any:
            raise FileNotFoundError(
                f"{self.directory}: no utt2spk / wav.scp / text found — "
                "not a Kaldi data dir")
        p = self._path("segments")
        if os.path.exists(p):
            for utt, val in _read_map(p).items():
                reco, beg, end = val.split(" ")
                self.utt2segments[utt] = (reco, float(beg), float(end))
        p = self._path("spk2utt")
        if os.path.exists(p):
            self.spk2utt = {k: v.split(" ") for k, v in _read_map(p).items()}
        elif self.utt2spk:
            for utt, spk in self.utt2spk.items():
                self.spk2utt.setdefault(spk, []).append(utt)
        p = self._path("utt2dur")
        if os.path.exists(p):
            self.utt2dur = {k: float(v) for k, v in _read_map(p).items()}
        return self

    def write(self, directory=None):
        d = directory or self.directory
        os.makedirs(d, exist_ok=True)
        if self.utt2spk:
            _write_map(os.path.join(d, "utt2spk"), self.utt2spk)
        if self.utt2wav:
            _write_map(os.path.join(d, "wav.scp"), self.utt2wav)
        if self.utt2text:
            _write_map(os.path.join(d, "text"), self.utt2text)
        if self.utt2segments:
            _write_map(os.path.join(d, "segments"),
                       {k: f"{r} {b} {e}" for k, (r, b, e)
                        in self.utt2segments.items()})
        if self.spk2utt:
            _write_map(os.path.join(d, "spk2utt"),
                       {k: " ".join(v) for k, v in self.spk2utt.items()})
        if self.utt2dur:
            _write_map(os.path.join(d, "utt2dur"),
                       {k: str(v) for k, v in self.utt2dur.items()})

    @property
    def num_spk(self):
        return len(self.spk2utt)

    @property
    def num_utt(self):
        return len(self.utt2spk)

    @property
    def total_duration(self):
        return float(sum(self.utt2dur.values()))


def parse_wav_entry(entry):
    """(wav path, 0-based channel or None) of a wav.scp value: a bare path,
    or CHiME-5's sox remix pipe ``sox <file.wav> -t wav - remix <c> |``;
    (None, None) for another pipe."""
    entry = entry.strip()
    if entry.endswith("|"):
        m = re.search(r"\s(\S+\.wav)\s.*remix\s([1-9])", entry)
        if m:
            return m.group(1), int(m.group(2)) - 1
        return None, None
    return entry, None
