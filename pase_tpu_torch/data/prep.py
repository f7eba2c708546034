"""Corpus preparation: energy-VAD segmentation and AMI's parallel
headset / far-field segments and data cfg.

The port of the VAD and AMI builders of ``pase_tpu/data/prep.py`` (numpy
and the standard library, as there; the same inputs give the same files,
sample for sample, and the same cfg):

* ``energy_vad_segments``: mean-|x| frame energies binarized at a share
  of their mean, a forward mean over ``smooth_window`` frames, then a
  high / low hysteresis; segments strictly longer than ``min_len``.
* ``vad_segment_corpus``: VAD each (peak-normalized) long recording and
  cut ``<name>-<side>-<segid>.wav`` segments.
* ``ami_segment``: VAD an AMI meeting's headsets (``<meet>/audio/
  <meet>.Headset-<h>.wav``) into one shared ``<meet>.Headset.vad`` list,
  cut each headset's segments ``<meet>.Headset-<h>-<seg>.wav`` and, at
  the same windows, the distant Array1 channels' segments
  ``<meet>.Headset-<h>-<seg>.Arr1-0<c>.wav`` (``<meet>.Array1-0<c>.wav``
  each peak-normalized), and save the utt2spk map.
* ``ami_data_cfg``: the data cfg of a train and a test scp of those
  segments: each entry the headset segment under 'filename', its distant
  segments under their channel keys, 'spk'; a seeded valid split.
"""

import os
import random
import re

import numpy as np

from pase_tpu_torch.data.io import read_wav, read_wav_channels, write_wav

# the side letter of a channel in a segment's name
_CHANNEL_SIDES = {0: "A", 1: "B", 2: "C", 3: "D"}


def energy_vad_segments(signal, wlen=3200, wshift=80, en_th=0.3,
                        smooth_window=40, smooth_th_low=0.25,
                        smooth_th_high=0.6, min_len=24000):
    """[(beg, end)] sample bounds of the speech segments of ``signal``.

    Frame i covers [i wshift, i wshift + wlen) (frames ending inside the
    signal); its energy is the mean |x|, binarized at ``en_th`` x the mean
    energy, smoothed with a forward mean over ``smooth_window`` frames
    (cut at the end). A segment opens where the smoothed value exceeds
    ``smooth_th_high`` (not at the last frame) and closes where it falls
    under ``smooth_th_low`` or at the last frame, both bounds offset by
    wlen samples; segments of at most ``min_len`` samples are dropped."""
    n = len(signal)
    if n <= wlen:
        return []
    k = (n - 1 - wlen) // wshift + 1
    if k <= 0:
        return []
    cs = np.concatenate([[0.0], np.cumsum(np.abs(signal), dtype=np.float64)])
    begs = np.arange(k, dtype=np.int64) * wshift
    en = (cs[begs + wlen] - cs[begs]) / wlen
    en_bin = (en > en.mean() * en_th).astype(np.float64)
    cb = np.concatenate([[0.0], np.cumsum(en_bin)])
    hi = np.minimum(np.arange(k) + smooth_window, k)
    smooth = (cb[hi] - cb[np.arange(k)]) / np.maximum(hi - np.arange(k), 1)

    segs = []
    vad = False
    beg = 0
    for i in range(k):
        if not vad:
            if smooth[i] > smooth_th_high and i < k - 1:
                vad = True
                beg = int(begs[i]) + wlen
        else:
            if i == k - 1:
                segs.append((beg, int(begs[i]) + wlen))
                break
            if smooth[i] < smooth_th_low:
                vad = False
                segs.append((beg, int(begs[i]) + wlen))
    return [(b, e) for b, e in segs if e - b > min_len]


def _pick_channel(wav, channel):
    """Channel ``channel`` of an [N, C] recording; a mono one has only 0."""
    if wav.ndim > 1:
        return wav[:, channel]
    if channel > 0:
        raise ValueError(f"asked for channel {channel} of a mono file")
    return wav


def _peak_normalized(path, channel=0):
    """(channel ``channel`` of the wav at ``path`` divided by its peak
    |x| (unless silent), its sample rate)."""
    wav, sr = read_wav_channels(path)
    sig = _pick_channel(wav, channel)
    peak = np.max(np.abs(sig))
    if peak > 0:
        sig = sig / peak
    return sig, sr


def vad_segment_corpus(data_root, file_list, out_root, channel=0,
                       vad_list_path=None, **vad_kwargs):
    """VAD each file of ``file_list`` (paths under ``data_root``; channel
    ``channel``, peak-normalized), write the VAD list (``file beg end
    segid`` lines) to ``vad_list_path`` if given, and cut the segments as
    ``<stem>-<side>-<segid>.wav`` under ``out_root`` (the files' folders
    mirrored). Returns the number of segments written."""
    if channel not in _CHANNEL_SIDES:
        raise ValueError(
            f"channel must be one of {sorted(_CHANNEL_SIDES)} "
            f"(segment names carry a side letter), got {channel}")
    entries = []
    for fname in file_list:
        sig, sr = _peak_normalized(os.path.join(data_root, fname), channel)
        for seg_id, (b, e) in enumerate(energy_vad_segments(sig,
                                                            **vad_kwargs)):
            entries.append((fname, b, e, seg_id, sr))
    if vad_list_path:
        with open(vad_list_path, "w") as f:
            for fname, b, e, seg_id, _ in entries:
                f.write(f"{fname} {b} {e} {seg_id}\n")
    side = _CHANNEL_SIDES[channel]
    n_out = 0
    cur_name, cur_sig = None, None
    for fname, b, e, seg_id, sr in entries:
        if fname != cur_name:
            cur_sig, _ = _peak_normalized(os.path.join(data_root, fname),
                                          channel)
            cur_name = fname
        stem = re.sub(r"\.(wav|sph)$", "", fname, flags=re.I)
        out_path = os.path.join(out_root, f"{stem}-{side}-{seg_id}.wav")
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        write_wav(out_path, cur_sig[b:e], sr)
        n_out += 1
    return n_out


def ami_mic_path(meetid, chan, cond="ihm"):
    """(meeting-relative folder, wav name) of a headset (``ihm``) or a
    distant Array1 channel (``sdm``)."""
    meetpath = f"{meetid}/audio"
    if cond == "ihm":
        return meetpath, f"{meetid}.Headset-{chan}.wav"
    if cond == "sdm":
        return meetpath, f"{meetid}.Array1-0{chan}.wav"
    raise ValueError(f"cond must be ihm or sdm, got {cond}")


def ami_segment(data_root, out_root, meetings, map_ihm2sdm="1,3,5,7",
                utt2spk_name="utt2spk.npy", headsets=(0, 1, 2, 3),
                **vad_kwargs):
    """Segment AMI meetings into parallel headset / distant-channel wavs
    under ``out_root`` (module docstring). A meeting's VAD list is kept
    and reused where ``<meet>.Headset.vad`` exists; missing headsets and
    channels are skipped. Returns (and saves as ``utt2spk_name``) the
    utt2spk map: segment wav name -> its headset."""
    sdms = [s for s in map_ihm2sdm.split(",") if s != ""]
    for s in sdms:
        if s not in list("01234567"):
            raise ValueError(f"AMI has distant mics 0..7, got {s}")
    file2spk = {}
    for meeting in meetings:
        vad_path = os.path.join(out_root, f"{meeting}.Headset.vad")
        os.makedirs(out_root, exist_ok=True)
        if not os.path.exists(vad_path):
            lines = []
            for h in headsets:
                meetpath, hs_file = ami_mic_path(meeting, h, "ihm")
                path = os.path.join(data_root, meetpath, hs_file)
                if not os.path.exists(path):
                    continue
                sig, _ = _peak_normalized(path)
                for seg_id, (b, e) in enumerate(
                        energy_vad_segments(sig, **vad_kwargs)):
                    lines.append(f"{hs_file} {b} {e} {seg_id}\n")
            with open(vad_path, "w") as f:
                f.writelines(lines)
        with open(vad_path) as f:
            entries = [ln.rstrip().split(" ") for ln in f if ln.rstrip()]

        for h in headsets:
            meetpath, hs_file = ami_mic_path(meeting, h, "ihm")
            path = os.path.join(data_root, meetpath, hs_file)
            if not os.path.exists(path):
                continue
            sig, sr = _peak_normalized(path)
            os.makedirs(os.path.join(out_root, meetpath), exist_ok=True)
            for wav_file, b, e, seg_id in entries:
                if wav_file != hs_file:
                    continue
                out_wav = wav_file.replace(".wav", f"-{seg_id}.wav")
                write_wav(os.path.join(out_root, meetpath, out_wav),
                          sig[int(b):int(e)], sr)
                file2spk[out_wav] = wav_file.replace(".wav", "")
        for sdm in sdms:
            meetpath, sdm_file = ami_mic_path(meeting, sdm, "sdm")
            path = os.path.join(data_root, meetpath, sdm_file)
            if not os.path.exists(path):
                continue
            sig, sr = _peak_normalized(path)
            os.makedirs(os.path.join(out_root, meetpath), exist_ok=True)
            for wav_file, b, e, seg_id in entries:
                stem = wav_file.replace(".wav", "")
                out_wav = f"{stem}-{seg_id}.Arr1-0{sdm}.wav"
                write_wav(os.path.join(out_root, meetpath, out_wav),
                          sig[int(b):int(e)], sr)
                file2spk[out_wav] = stem
    np.save(os.path.join(out_root, utt2spk_name), file2spk,
            allow_pickle=True)
    return file2spk


_AMI_IHM_RE = re.compile(r".*Headset\-\d\-(\d)*\.wav")
_AMI_SPK_RE = re.compile(r"(.*Headset\-\d).*")
_AMI_SDM_RE = re.compile(r"(.*Headset\-\d\-[\d)]*)(\.Arr1-0)(\d).*")


def _ami_parse_list(scp_path, chans):
    """An scp of segment wavs -> (utt2spk of its headset segments, headset
    segment -> {channel: distant segment}); with ``chans``, the headset
    segments missing any of them are dropped from both."""
    with open(scp_path) as f:
        entries = [ln.strip() for ln in f if ln.strip()]
    ihms = [e for e in entries if _AMI_IHM_RE.search(e)]
    utt2spk = {}
    for p in ihms:
        bsn = os.path.basename(p)
        m = _AMI_SPK_RE.match(bsn)
        utt2spk[bsn] = m.group(1) if m else None
    ihm2sdms = {k: {} for k in utt2spk}
    if chans:
        for p in entries:
            m = _AMI_SDM_RE.match(os.path.basename(p))
            if not m:
                continue
            ihm = m.group(1) + ".wav"
            chan = m.group(3)
            sdm = m.group(1) + m.group(2) + m.group(3) + ".wav"
            if chan not in chans:
                continue
            if ihm in ihm2sdms:
                ihm2sdms[ihm][chan] = sdm
        for ihm in list(ihm2sdms):
            if len(ihm2sdms[ihm]) != len(chans):
                ihm2sdms.pop(ihm)
                utt2spk.pop(ihm, None)
    return utt2spk, ihm2sdms


def ami_path_of(utt):
    """A segment's name -> its path in the corpus,
    '<meetid>/audio/<name>'."""
    m = re.match(r"(.*)\.Headset.*", os.path.basename(utt))
    if m is None:
        raise ValueError(f"cannot extract meeting id from {utt} — "
                         "is this an AMI segment name?")
    return f"{m.group(1)}/audio/{os.path.basename(utt)}"


def ami_data_cfg(data_root, train_scp, test_scp, map_ihm2sdm="1,3,5,7",
                 val_ratio=0.1, seed=3):
    """The AMI data cfg (module docstring): the train scp's headset
    segments shuffled by ``random.Random(seed)``, the first ``val_ratio``
    of them the valid split, the test scp's the test split; per split
    its speakers and total_wav_dur (samples read from ``data_root``)."""
    rng = random.Random(seed)
    chans = [c for c in map_ihm2sdm.split(",") if c != ""]
    utt2spk, ihm2sdms = _ami_parse_list(train_scp, chans)
    utt2spk_te, ihm2sdms_te = _ami_parse_list(test_scp, chans)

    cfg = {s: {"data": [], "speakers": [], "total_wav_dur": 0}
           for s in ("train", "valid", "test")}
    cfg["speakers"] = []

    keys = list(utt2spk.keys())
    rng.shuffle(keys)
    n_valid = int(len(keys) * val_ratio)
    split_keys = {"valid": keys[:n_valid], "train": keys[n_valid:],
                  "test": list(utt2spk_te.keys())}
    maps = {"train": (utt2spk, ihm2sdms), "valid": (utt2spk, ihm2sdms),
            "test": (utt2spk_te, ihm2sdms_te)}
    for split in ("train", "valid", "test"):
        u2s, i2s = maps[split]
        dur = 0
        for utt in split_keys[split]:
            spk = u2s[utt]
            if spk not in cfg["speakers"]:
                cfg["speakers"].append(spk)
                cfg[split]["speakers"].append(spk)
            entry = {"filename": ami_path_of(utt), "spk": spk}
            for chan, sdm in i2s[utt].items():
                entry[chan] = ami_path_of(sdm)
            cfg[split]["data"].append(entry)
            wav, _ = read_wav(os.path.join(data_root, ami_path_of(utt)))
            dur += len(wav)
        cfg[split]["total_wav_dur"] = dur
    return cfg

