"""Corpus preparation: energy-VAD segmentation, AMI's parallel headset /
far-field segments and data cfg, and the other corpora's builders.

The port of the builders of ``pase_tpu/data/prep.py`` (numpy and the
standard library, as there, with the same random.Random /
np.random.RandomState calls in the same order; the same inputs and seed
give the same files, byte for byte, and the same cfg):

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
* ``vctk_data_cfg``: VCTK's speaker-split cfg from speaker-info.txt.
* ``openslr_rirs_cfg``: the OpenSLR-28 RIRs as a reverb distortion cfg.
* ``voxceleb_lists`` / ``voxforge_lists``: the spk-id / LID probe assets
  (fixed-length wavs, lists, utt2spk / utt2lang maps).
* ``chime5_pair`` / ``chime5_data_cfg``: CHiME-5's worn / array pairs of
  two Kaldi data dirs (``data/kaldi_dir.py``), their cfg and segments.
* ``iemocap_segment``: IEMOCAP's dialogs cut into per-emotion utterances.
* ``arff_lld_to_npy``: openSMILE LLD ARFFs as .npy features.
"""

import json
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



# ---------------------------------------------------------------------------
# VCTK
# ---------------------------------------------------------------------------


def vctk_data_cfg(data_root, train_split=0.88, valid_split=0.06,
                  min_len=16000, max_utts_spk=None):
    """The VCTK cfg: speaker-info.txt read as a whitespace table under a
    header row (a longer row's trailing words joined with '_' into the
    last column, a shorter one padded with 'UNK'); the speakers, in file
    order, split into train / valid / test by the two shares; each
    speaker's wavs of wav16/ (else wav48/) p<spk>/, sorted, at most
    ``max_utts_spk[split]`` counted per speaker (0: all), those shorter
    than ``min_len`` samples skipped."""
    spks = {}
    ws = re.compile(r"\s+")
    with open(os.path.join(data_root, "speaker-info.txt")) as f:
        header = []
        for li, line in enumerate(f, start=1):
            content = [c for c in ws.split(line.rstrip()) if c != ""]
            if li == 1:
                header = content
                continue
            if not content:
                continue
            if len(content) > len(header):
                content = content[:len(header) - 1] + \
                    ["_".join(content[len(header) - 1:])]
            elif len(content) < len(header):
                content += ["UNK"] * (len(header) - len(content))
            spks[content[0]] = dict(zip(header[1:], content[1:]))
    spk_ids = list(spks)
    n = len(spk_ids)
    n_train = int(np.floor(train_split * n))
    n_valid = int(np.floor(valid_split * n))
    wav_dir = "wav16" if os.path.exists(os.path.join(data_root, "wav16")) \
        else "wav48"
    caps = {"train": 0, "valid": 0, "test": 0}
    if max_utts_spk:
        caps.update(max_utts_spk)
    cfg = {"train": {"data": [], "speakers": []},
           "valid": {"data": [], "speakers": []},
           "test": {"data": [], "speakers": []},
           "speakers": spks}
    ptr = 0
    for split, split_n in (("train", n_train), ("valid", n_valid),
                           ("test", n - n_train - n_valid)):
        total = 0
        cap = caps[split] if caps[split] > 0 else np.inf
        for spk in spk_ids[ptr:ptr + split_n]:
            spk_dir = os.path.join(data_root, wav_dir, "p" + spk)
            wavs = sorted(
                os.path.join(spk_dir, w) for w in os.listdir(spk_dir)
                if w.endswith(".wav")) if os.path.isdir(spk_dir) else []
            count = 0
            for wav_path in wavs:
                if count >= cap:
                    break
                count += 1
                x, _ = read_wav(wav_path)
                if len(x) < min_len:
                    continue
                total += len(x)
                cfg[split]["data"].append(
                    {"filename": os.path.join(wav_dir, "p" + spk,
                                              os.path.basename(wav_path)),
                     "spk": spk})
                if spk not in cfg[split]["speakers"]:
                    cfg[split]["speakers"].append(spk)
        cfg[split]["total_wav_dur"] = total
        ptr += split_n
    return cfg


# ---------------------------------------------------------------------------
# OpenSLR-28 RIRs
# ---------------------------------------------------------------------------


def openslr_rirs_cfg(data_root, out_file, small_room_ratio=1.0,
                     medium_room_ratio=1.0, large_room_ratio=1.0,
                     existing_cfg=None, seed=None):
    """A distortion cfg (new, or ``existing_cfg`` with its reverb keys
    replaced) whose reverb bank is the OpenSLR-28 simulated RIRs: the 5th
    field of each line of <room>/rir_list, a room's list shuffled by one
    random.Random(seed) and cut to its ratio when the ratio is below 1,
    all sorted. Writes ``out_file`` (JSON, indent 2) and returns it."""
    if existing_cfg is not None:
        with open(existing_cfg) as f:
            out = json.load(f)
        out["reverb_data_root"] = data_root
        out["reverb_fmt"] = "wav"
        out["reverb_irfiles"] = []
    else:
        out = {"reverb_data_root": data_root, "reverb_fmt": "wav",
               "reverb_irfiles": []}
    rng = random.Random(seed)
    final = []
    for room, ratio in (("smallroom", small_room_ratio),
                        ("mediumroom", medium_room_ratio),
                        ("largeroom", large_room_ratio)):
        rir_list = os.path.join(data_root, room, "rir_list")
        if not os.path.exists(rir_list):
            continue
        with open(rir_list) as f:
            rirs = [line.split(" ")[4].strip() for line in f
                    if len(line.split(" ")) > 4]
        if ratio < 1.0:
            rng.shuffle(rirs)
            rirs = rirs[:int(len(rirs) * ratio)]
        final.extend(rirs)
    out["reverb_irfiles"].extend(sorted(final))
    with open(out_file, "w") as f:
        json.dump(out, f, indent=2)
    return out


# ---------------------------------------------------------------------------
# VoxCeleb / VoxForge probe assets
# ---------------------------------------------------------------------------


def _fixed_length(y, n_samples, rng):
    """A random ``n_samples`` crop (start rng.randint(0, len - n)), or the
    signal tiled up to that length."""
    if len(y) > n_samples:
        ridx = rng.randint(0, len(y) - n_samples)
        return y[ridx:ridx + n_samples]
    mul = int(np.ceil(n_samples / max(len(y), 1)))
    return np.tile(y, mul)[:n_samples]


def _dump_list(items, path):
    with open(path, "w") as f:
        for el in items:
            f.write(el + "\n")


def voxceleb_lists(path_to_data, out_path, nspk=100, out_length=10,
                   sr=16000, seed=None):
    """mini-VoxCeleb: ``nspk`` speaker dirs (spk/session/utt.wav) drawn by
    np.random.RandomState(seed), one train and one test recording each,
    written ``out_length`` s long as ``<spk>_-_<session>_-_<utt>`` under
    train/ and test/, with lists/train_list, lists/test_list and
    lists/utt2spk.npy. Returns (train, test, utt2spk)."""
    rng = np.random.RandomState(seed)
    spk_dirs = sorted(d for d in os.listdir(path_to_data)
                      if os.path.isdir(os.path.join(path_to_data, d)))
    if nspk > len(spk_dirs):
        raise ValueError(f"asked for {nspk} speakers, corpus has "
                         f"{len(spk_dirs)}")
    spk_list = rng.choice(spk_dirs, nspk, replace=False)
    for sub in ("train", "test", "lists"):
        os.makedirs(os.path.join(out_path, sub), exist_ok=True)
    train_list, test_list, utt2spk = [], [], {}
    n_samples = sr * out_length
    for i, spk in enumerate(spk_list):
        recs = []
        spk_root = os.path.join(path_to_data, spk)
        for sess in sorted(os.listdir(spk_root)):
            sess_dir = os.path.join(spk_root, sess)
            if not os.path.isdir(sess_dir):
                continue
            recs += [os.path.join(sess_dir, r)
                     for r in sorted(os.listdir(sess_dir))
                     if r.lower().endswith(".wav")]
        if len(recs) < 2:
            raise ValueError(f"speaker {spk} has <2 recordings")
        tr_rec, te_rec = rng.choice(recs, 2, replace=False)
        for rec, sub, lst in ((tr_rec, "train", train_list),
                              (te_rec, "test", test_list)):
            y, _ = read_wav(rec)
            y = _fixed_length(y, n_samples, rng)
            name = "_-_".join([spk, os.path.basename(os.path.dirname(rec)),
                               os.path.basename(rec)])
            write_wav(os.path.join(out_path, sub, name), y, sr)
            lst.append(name)
            utt2spk[name] = i
    _dump_list(train_list, os.path.join(out_path, "lists", "train_list"))
    _dump_list(test_list, os.path.join(out_path, "lists", "test_list"))
    np.save(os.path.join(out_path, "lists", "utt2spk.npy"), utt2spk,
            allow_pickle=True)
    return train_list, test_list, utt2spk


def simple_frame_vad(y, sr, win_s=0.025, hop_s=0.010, percent_thr=0.5,
                     nrg_thr=0.0, context=5):
    """The samples of ``y`` in speech frames: per-frame log energies
    (DC removed) standardized; a frame is speech where more than
    ``percent_thr`` of the frames of its +-``context`` neighbourhood exceed
    ``nrg_thr``; its samples are kept."""
    win, hop = int(sr * win_s), int(sr * hop_s)
    if len(y) < win:
        return y
    k = 1 + (len(y) - win) // hop
    idx = np.arange(k)[:, None] * hop + np.arange(win)[None, :]
    frames = y[idx]
    frames = frames - frames.mean(axis=1, keepdims=True)
    nrg = np.log(np.mean(frames * frames, axis=1) + 1e-10)
    nrg = (nrg - nrg.mean()) / (nrg.std() + 1e-10)
    above = (nrg > nrg_thr).astype(np.float64)
    ca = np.concatenate([[0.0], np.cumsum(above)])
    lo = np.maximum(np.arange(k) - context, 0)
    hi = np.minimum(np.arange(k) + context, k - 1)
    frac = (ca[hi] - ca[lo]) / np.maximum(hi - lo + 1, 1)
    mask = np.zeros(len(y), bool)
    for i in np.flatnonzero(frac > percent_thr):
        mask[i * hop:i * hop + win] = True
    return y[mask]


def voxforge_lists(path_to_metadata, path_to_data, out_path, nrecs=30,
                   out_length=10, sr=16000, vad=False, traintest=True,
                   seed=None):
    """VoxForge LID assets: the metadata csv's rows (``wav,Language,...``)
    grouped by language; up to ``nrecs`` recordings a language drawn by
    np.random.RandomState(seed), the first third to test, the rest to
    train; each longer than 2 s, optionally VAD'ed
    (``simple_frame_vad``), written ``out_length`` s long as
    ``<lang>_-_<wav>``, with lists/ and utt2lang.npy. Returns (train,
    test, utt2lang)."""
    rng = np.random.RandomState(seed)
    lang2rec = {}
    with open(path_to_metadata) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 2:
                continue
            lang2rec.setdefault(parts[1], []).append(parts[0])
    for sub in (("train", "test", "lists") if traintest else ()):
        os.makedirs(os.path.join(out_path, sub), exist_ok=True)
    train_list, test_list, utt2lang = [], [], {}
    n_samples = sr * out_length

    def prep_one(rec, dest):
        src = os.path.join(path_to_data, rec)
        if not os.path.exists(src):
            return False
        y, fs = read_wav(src)
        if len(y) <= fs * 2:
            return False
        if vad:
            y = simple_frame_vad(y, fs)
        if len(y) == 0:
            return False
        write_wav(dest, _fixed_length(y, n_samples, rng), sr)
        return True

    for i, lang in enumerate(lang2rec):
        recs = lang2rec[lang]
        if len(recs) < 2:
            raise ValueError(f"not enough recordings for language {lang}")
        if traintest:
            sel = rng.choice(recs, min(nrecs, len(recs)), replace=False)
            mid = len(sel) // 3
            for recs_, sub, lst in ((sel[mid:], "train", train_list),
                                    (sel[:mid], "test", test_list)):
                for rec in recs_:
                    name = f"{lang}_-_{rec}"
                    if prep_one(rec, os.path.join(out_path, sub, name)):
                        lst.append(name)
                        utt2lang[name] = i
        else:
            os.makedirs(out_path, exist_ok=True)
            for rec in recs:
                prep_one(rec, os.path.join(out_path, f"{lang}_-_{rec}"))
    if traintest:
        _dump_list(train_list, os.path.join(out_path, "lists",
                                            "train_list"))
        _dump_list(test_list, os.path.join(out_path, "lists", "test_list"))
        np.save(os.path.join(out_path, "lists", "utt2lang.npy"), utt2lang,
                allow_pickle=True)
    return train_list, test_list, utt2lang


# ---------------------------------------------------------------------------
# CHiME-5 worn / array pairs
# ---------------------------------------------------------------------------


def chime5_pair(ihm_dir, sdm_dir, min_words_per_seg=2):
    """The worn-mic (ihm) and array (sdm) utterances of two Kaldi dirs
    paired by '<session>_<part> <transcript>' (the first of a repeated key
    kept; transcripts of fewer than ``min_words_per_seg`` words dropped)
    and by speaker: spk -> {'ihm': [utts], 'sdm': [utts]}, aligned."""
    from pase_tpu_torch.data.kaldi_dir import KaldiDataDir
    ihm, sdm = KaldiDataDir(ihm_dir), KaldiDataDir(sdm_dir)

    def text_ids(dd):
        out = {}
        for utt, txt in dd.utt2text.items():
            if len(txt.split(" ")) < min_words_per_seg:
                continue
            ps = utt.split("_")
            key = f"{ps[0]}_{ps[1]} {txt}" if len(ps) > 1 else f"{utt} {txt}"
            out.setdefault(key, utt)
        return out

    t_ihm, t_sdm = text_ids(ihm), text_ids(sdm)
    spk2chunks = {s: {"ihm": [], "sdm": []} for s in ihm.spk2utt}
    for key in sorted(set(t_ihm) & set(t_sdm)):
        u_ihm, u_sdm = t_ihm[key], t_sdm[key]
        spk = ihm.utt2spk.get(u_ihm)
        if spk is None or spk != sdm.utt2spk.get(u_sdm):
            continue
        spk2chunks[spk]["ihm"].append(u_ihm)
        spk2chunks[spk]["sdm"].append(u_sdm)
    return spk2chunks


def chime5_data_cfg(ihm_dir, sdm_dir, out_dir, valid_spk="P42",
                    test_spk="P41", fs=16000, min_words_per_seg=2,
                    cut_segments=True):
    """The CHiME-5 parallel data cfg ({'filename': '<spk>-<i>.wav', '1':
    '<spk>_<reco>-<i>.wav', 'spk'}) of ``chime5_pair``'s pairs, speaker
    ``valid_spk`` the valid split and ``test_spk`` the test split; with
    ``cut_segments`` each pair's two segments cut from their session
    recordings (one read a recording; the sox pipe's channel, else the
    first) into ``out_dir``."""
    from pase_tpu_torch.data.kaldi_dir import KaldiDataDir, parse_wav_entry
    ihm, sdm = KaldiDataDir(ihm_dir), KaldiDataDir(sdm_dir)
    spk2chunks = chime5_pair(ihm_dir, sdm_dir, min_words_per_seg)
    cfg = {s: {"data": [], "speakers": [], "total_wav_dur": 0}
           for s in ("train", "valid", "test")}
    cfg["speakers"] = []
    cut_jobs = {}
    for spk in sorted(spk2chunks):
        for idx, (u_ihm, u_sdm) in enumerate(zip(spk2chunks[spk]["ihm"],
                                                 spk2chunks[spk]["sdm"])):
            reco_i, beg_i, end_i = ihm.utt2segments[u_ihm]
            reco_s, beg_s, end_s = sdm.utt2segments[u_sdm]
            out_ihm = f"{spk}-{idx}.wav"
            out_sdm = f"{spk}_{reco_s}-{idx}.wav"
            for reco, beg, end, out, dd in (
                    (reco_i, beg_i, end_i, out_ihm, ihm),
                    (reco_s, beg_s, end_s, out_sdm, sdm)):
                path, chan = parse_wav_entry(dd.utt2wav[reco])
                cut_jobs.setdefault(path, []).append(
                    (beg, end, chan, os.path.join(out_dir, out)))
            dset = "train"
            if spk == valid_spk:
                dset = "valid"
            elif spk == test_spk:
                dset = "test"
            cfg[dset]["data"].append({"filename": out_ihm, "1": out_sdm,
                                      "spk": spk})
            if spk not in cfg[dset]["speakers"]:
                cfg[dset]["speakers"].append(spk)
            if spk not in cfg["speakers"]:
                cfg["speakers"].append(spk)
            cfg[dset]["total_wav_dur"] += int((end_i - beg_i) * fs)
    if cut_segments:
        os.makedirs(out_dir, exist_ok=True)
        for path, jobs in cut_jobs.items():
            if path is None or not os.path.exists(path):
                continue
            sig, sr = read_wav_channels(path)
            for beg, end, chan, out in jobs:
                b, e = int(beg * sr), int(end * sr)
                if b >= e or e > len(sig):
                    continue
                if sig.ndim > 1:
                    piece = sig[b:e, 0 if chan is None else chan]
                else:
                    piece = sig[b:e]
                write_wav(out, piece, sr)
    return cfg


# ---------------------------------------------------------------------------
# IEMOCAP emotion-probe assets
# ---------------------------------------------------------------------------

IEMO_KEEP = ("neu", "hap", "sad", "ang", "exc")
_IEMO_LINE = re.compile(
    r"^\[(\d+\.\d+)\s*-\s*(\d+\.\d+)\]\t(\S+)\t(\w{3})\t\[")


def parse_emoevaluation(path):
    """[(t_start, t_end, utt_id, emotion)] of the '[t0 - t1]\\tutt\\temo\\t[v,
    a, d]' rows of one IEMOCAP EmoEvaluation file."""
    out = []
    with open(path) as f:
        for line in f:
            m = _IEMO_LINE.match(line.strip())
            if m:
                out.append((float(m.group(1)), float(m.group(2)),
                            m.group(3), m.group(4)))
    return out


def iemocap_segment(iemocap_root, out_root, keep=IEMO_KEEP):
    """Cut each Session*/dialog recording into its utterances of the
    ``keep`` emotions, 'exc' written as 'hap': the window [ceil(t0 sr),
    ceil(t1 sr)) of the speaker's channel (the utterance id's gender
    letter: F the left, M the right), to
    ``<out>/session<k>/<label>/<utt>.wav``. Returns {'session<k>':
    {emotion: utterances written}}."""
    counts = {}
    sessions = sorted(d for d in os.listdir(iemocap_root)
                      if d.lower().startswith("session") and
                      os.path.isdir(os.path.join(iemocap_root, d)))
    for sess in sessions:
        k = re.sub(r"\D", "", sess) or sess
        sess_out = f"session{k}"
        counts[sess_out] = {}
        emo_dir = os.path.join(iemocap_root, sess, "dialog", "EmoEvaluation")
        wav_dir = os.path.join(iemocap_root, sess, "dialog", "wav")
        if not os.path.isdir(emo_dir):
            continue
        for emof in sorted(os.listdir(emo_dir)):
            epath = os.path.join(emo_dir, emof)
            if not (os.path.isfile(epath) and emof.endswith(".txt")):
                continue
            wpath = os.path.join(wav_dir, os.path.splitext(emof)[0] + ".wav")
            if not os.path.exists(wpath):
                continue
            sig, sr = read_wav_channels(wpath)
            for t0, t1, utt, emo in parse_emoevaluation(epath):
                if emo not in keep:
                    continue
                b, e = int(np.ceil(t0 * sr)), int(np.ceil(t1 * sr))
                if sig.ndim > 1:
                    chan = 0 if utt.split("_")[-1][:1] == "F" else 1
                    piece = sig[b:e, min(chan, sig.shape[1] - 1)]
                else:
                    piece = sig[b:e]
                if piece.size == 0:
                    continue
                label = "hap" if emo == "exc" else emo
                dest = os.path.join(out_root, sess_out, label)
                os.makedirs(dest, exist_ok=True)
                write_wav(os.path.join(dest, utt + ".wav"), piece, sr)
                counts[sess_out][emo] = counts[sess_out].get(emo, 0) + 1
    return counts


# ---------------------------------------------------------------------------
# openSMILE ARFF LLDs -> npy
# ---------------------------------------------------------------------------


def read_arff(path):
    """(attribute names, [frames, attributes] object array) of the numeric
    ARFF subset openSMILE writes; cells that are not numbers stay
    strings."""
    attrs, rows = [], []
    in_data = False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("%"):
                continue
            low = line.lower()
            if low.startswith("@attribute"):
                attrs.append(line.split(None, 2)[1].strip("'\""))
            elif low.startswith("@data"):
                in_data = True
            elif in_data:
                cells = []
                for c in line.split(","):
                    c = c.strip().strip("'\"")
                    try:
                        cells.append(float(c))
                    except ValueError:
                        cells.append(c)
                rows.append(cells)
    return attrs, np.array(rows, dtype=object)


def _interp_sentinel(x, sentinel=-1e10):
    """Linear interpolation across the frames at ``sentinel``, the edges
    holding the nearest valid value (all or none valid: unchanged)."""
    voiced = x > sentinel / 2
    if not voiced.any() or voiced.all():
        return x
    idx = np.arange(len(x))
    return np.interp(idx, idx[voiced], x[voiced]).astype(x.dtype)


def arff_lld_to_npy(arff_files, out_stats=None):
    """openSMILE IS09 frame-level LLD ARFFs -> ``<file>.npy`` [feats,
    frames] each (the name / frameTime columns and the class column
    dropped; the column named F0_sma logged, unvoiced frames interpolated),
    and with ``out_stats`` a pickle of {'mean', 'std'} over all frames.
    Returns the written paths."""
    import pickle
    written, all_frames = [], []
    for afile in arff_files:
        attrs, data = read_arff(afile)
        f0_idx = attrs.index("F0_sma")
        feat = data[:, 2:-1].astype(np.float32)
        f0 = feat[:, f0_idx - 2]
        lf0 = np.where(f0 > 0, np.log(np.maximum(f0, 1e-12)), -1e10)
        feat[:, f0_idx - 2] = _interp_sentinel(lf0.astype(np.float32))
        if out_stats is not None:
            all_frames.append(feat)
        npy_path = os.path.splitext(afile)[0] + ".npy"
        np.save(npy_path, feat.T)
        written.append(npy_path)
    if out_stats is not None and all_frames:
        x = np.concatenate(all_frames, axis=0)
        with open(out_stats, "wb") as f:
            pickle.dump({"mean": np.mean(x, axis=0),
                         "std": np.std(x, axis=0)}, f)
    return written
