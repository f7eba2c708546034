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
import wave

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


# ---------------------------------------------------------------------------
# seeded trees in the other corpora's layouts (the data_prep builders')
# ---------------------------------------------------------------------------


def _speaker(rng, signal, n):
    """n samples of one synthetic speaker (a random f0 and tilt) in bursts
    over a faint floor."""
    f0 = rng.uniform(80, 260, size=(1, 1))
    tilt = rng.uniform(0.7, 1.5, size=(1, 1))
    return (signal._speechlike(f0, tilt, n)[0] * _bursts(n, rng)
            + 0.002 * rng.randn(n).astype(np.float32))


def write_multichannel_wav(path, data, sr=SR):
    """[N, C] float samples (clipped to [-1, 1]) as C-channel 16-bit PCM."""
    pcm = (np.clip(np.asarray(data, np.float64), -1.0, 1.0)
           * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def write_synthetic_long_wavs(root, n_files=3, seconds=40.0, seed=0):
    """``n_files`` long recordings ``<spk>-<chap>.wav`` of one speaker
    each, directly under ``root`` (the flat tree ``data_prep segment``
    cuts); returns their names."""
    rng = np.random.RandomState(seed)
    signal = SyntheticChunkBatcher(1, 0, seed=seed + 1)
    os.makedirs(root, exist_ok=True)
    names = []
    for i in range(n_files):
        n = int(seconds * SR * rng.uniform(0.8, 1.0))
        names.append(f"{100 + i}-{10 + i}.wav")
        write_wav(os.path.join(root, names[-1]), _speaker(rng, signal, n))
    return names


def write_synthetic_vctk(root, n_spk=6, n_utts=3, seed=0):
    """VCTK's layout: speaker-info.txt (ID AGE GENDER ACCENTS REGION, some
    regions of two words, one row without a region) and
    wav48/p<spk>/p<spk>_<i>.wav, the last utterance of each speaker
    shorter than one second; returns the speaker ids."""
    rng = np.random.RandomState(seed)
    signal = SyntheticChunkBatcher(1, 0, seed=seed + 1)
    spks = [str(225 + i) for i in range(n_spk)]
    info = ["ID  AGE  GENDER  ACCENTS  REGION"]
    for k, s in enumerate(spks):
        info.append(f"{s}  {20 + k}  {'FM'[k % 2]}  English"
                    + ("" if k == 1 else "  Southern  England" if k % 2
                       else "  Surrey"))
        folder = os.path.join(root, "wav48", f"p{s}")
        os.makedirs(folder, exist_ok=True)
        for i in range(n_utts):
            n = int(SR * (rng.uniform(1.2, 2.0) if i < n_utts - 1 else 0.5))
            write_wav(os.path.join(folder, f"p{s}_{i:03d}.wav"),
                      _speaker(rng, signal, n))
    with open(os.path.join(root, "speaker-info.txt"), "w") as f:
        f.write("\n".join(info) + "\n")
    return spks


def write_synthetic_rirs(root, rooms=(("smallroom", 5), ("mediumroom", 4),
                                      ("largeroom", 3)), seed=0):
    """OpenSLR-28's layout: <room>/rir_list lines naming
    simulated_rirs_16k/<room>/Room001/Room001-<i>.wav, and those IR wavs
    (a unit peak after a few samples, then a decaying tail)."""
    rng = np.random.RandomState(seed)
    for room, n in rooms:
        os.makedirs(os.path.join(root, room), exist_ok=True)
        lines = []
        for i in range(n):
            rel = f"simulated_rirs_16k/{room}/Room001/Room001-{i + 1:05d}.wav"
            lines.append(f"--rir-id {room}-Room001-{i + 1:05d} --room-id "
                         f"{room}-Room001 {rel}")
            os.makedirs(os.path.dirname(os.path.join(root, rel)),
                        exist_ok=True)
            ir = rng.randn(4000) * np.exp(-np.arange(4000) / 800.0) * 0.1
            ir[rng.randint(0, 40)] = 1.0
            write_wav(os.path.join(root, rel), ir.astype(np.float32))
        with open(os.path.join(root, room, "rir_list"), "w") as f:
            f.write("\n".join(lines) + "\n")


def write_synthetic_voxceleb(root, n_spk=4, n_sessions=2, n_utts=2,
                             seconds=3.0, seed=0):
    """VoxCeleb1's layout: id<spk>/<session>/<utt>.wav, one synthetic
    speaker per id, lengths around ``seconds``; returns the ids."""
    rng = np.random.RandomState(seed)
    signal = SyntheticChunkBatcher(1, 0, seed=seed + 1)
    ids = [f"id{10001 + i}" for i in range(n_spk)]
    for spk in ids:
        for s in range(n_sessions):
            folder = os.path.join(root, spk, f"sess{s:02d}")
            os.makedirs(folder, exist_ok=True)
            for u in range(n_utts):
                n = int(SR * seconds * rng.uniform(0.5, 1.5))
                write_wav(os.path.join(folder, f"{u + 1:05d}.wav"),
                          _speaker(rng, signal, n))
    return ids


def write_synthetic_voxforge(root, langs=("Italian", "French", "German"),
                             n_recs=4, seconds=3.0, seed=0):
    """VoxForge's assets: a metadata csv (``wav,Language,user,idx`` rows)
    and its wavs in one folder, one of each language's recordings
    shorter than the 2 s the builder skips; returns (csv, wav folder)."""
    rng = np.random.RandomState(seed)
    signal = SyntheticChunkBatcher(1, 0, seed=seed + 1)
    data = os.path.join(root, "wav")
    os.makedirs(data, exist_ok=True)
    rows = []
    for lang in langs:
        for i in range(n_recs):
            name = f"{lang[:2].lower()}-{i}.wav"
            n = int(SR * (1.5 if i == n_recs - 1 else
                          seconds * rng.uniform(1.0, 1.5)))
            write_wav(os.path.join(data, name), _speaker(rng, signal, n))
            rows.append(f"{name},{lang},user{i},{i}")
    meta = os.path.join(root, "voxforge_samples.csv")
    with open(meta, "w") as f:
        f.write("\n".join(rows) + "\n")
    return meta, data


def write_synthetic_chime5(root, speakers=("P09", "P10", "P41", "P42"),
                           n_utts=4, session="S03", seconds=30.0, seed=0):
    """CHiME-5's Kaldi data dirs for one session: ``worn`` (one mono
    recording <session>_<spk>.wav per speaker) and ``array`` (a 4-channel
    U01 recording, a mix of the speakers, read through the sox remix pipe
    of channel 2), both with utt2spk, text (one one-word transcript each,
    which the pairing drops), segments (the array's windows a little
    wider) and wav.scp. Returns (worn dir, array dir)."""
    rng = np.random.RandomState(seed)
    signal = SyntheticChunkBatcher(1, 0, seed=seed + 1)
    audio = os.path.join(root, "audio")
    os.makedirs(audio, exist_ok=True)
    n = int(seconds * SR)
    mix = 0.01 * rng.randn(n, 4).astype(np.float32)
    worn = {"utt2spk": {}, "text": {}, "segments": {}, "wav.scp": {}}
    array = {"utt2spk": {}, "text": {}, "segments": {}, "wav.scp": {}}
    reco_a = f"{session}_U01"
    array["wav.scp"][reco_a] = (f"sox {os.path.join(audio, reco_a)}.wav "
                                "-t wav - remix 2 |")
    for k, spk in enumerate(speakers):
        wav = _speaker(rng, signal, n)
        reco = f"{session}_{spk}"
        write_wav(os.path.join(audio, reco + ".wav"), wav)
        worn["wav.scp"][reco] = os.path.join(audio, reco + ".wav")
        for c in range(4):
            mix[:, c] += rng.uniform(0.15, 0.5) * wav
        for u in range(n_utts):
            beg = round(rng.uniform(0.0, seconds - 3.0), 2)
            end = round(beg + rng.uniform(0.8, 2.5), 2)
            words = " ".join(f"w{rng.randint(100)}" for _ in range(
                1 if u == 0 else rng.randint(2, 6)))
            stamp = f"{int(beg * 100):07d}-{int(end * 100):07d}"
            for dd, utt, rec, pad in (
                    (worn, f"{spk}_{session}_{stamp}", reco, 0.0),
                    (array, f"{spk}_{session}_U01-{stamp}", reco_a, 0.05)):
                dd["utt2spk"][utt] = spk
                dd["text"][utt] = words
                dd["segments"][utt] = (f"{rec} {max(beg - pad, 0.0):.2f} "
                                       f"{end + pad:.2f}")
    write_multichannel_wav(os.path.join(audio, reco_a + ".wav"), mix)
    dirs = []
    for name, dd in (("worn", worn), ("array", array)):
        folder = os.path.join(root, name)
        os.makedirs(folder, exist_ok=True)
        for fname, entries in dd.items():
            with open(os.path.join(folder, fname), "w") as f:
                for key in sorted(entries):
                    f.write(f"{key} {entries[key]}\n")
        dirs.append(folder)
    return tuple(dirs)


IEMOCAP_EMOTIONS = ("neu", "hap", "sad", "ang", "exc", "fru", "xxx")


def write_synthetic_iemocap(root, n_sessions=2, n_dialogs=2, n_utts=6,
                            seed=0):
    """IEMOCAP_full_release's layout: Session<k>/dialog/EmoEvaluation/
    <dialog>.txt (a header, '[t0 - t1]\\t<utt>\\t<emo>\\t[v, a, d]' rows
    with evaluator lines between them, emotions drawn from
    IEMOCAP_EMOTIONS) and Session<k>/dialog/wav/<dialog>.wav (stereo: the
    female speaker left, the male right); returns the release folder."""
    rng = np.random.RandomState(seed)
    signal = SyntheticChunkBatcher(1, 0, seed=seed + 1)
    rel = os.path.join(root, "IEMOCAP_full_release")
    for s in range(1, n_sessions + 1):
        emo_dir = os.path.join(rel, f"Session{s}", "dialog", "EmoEvaluation")
        wav_dir = os.path.join(rel, f"Session{s}", "dialog", "wav")
        os.makedirs(emo_dir, exist_ok=True)
        os.makedirs(wav_dir, exist_ok=True)
        for d in range(n_dialogs):
            dialog = f"Ses{s:02d}F_impro{d + 1:02d}"
            n = int(SR * (2.5 * n_utts + 1))
            stereo = np.stack([_speaker(rng, signal, n),
                               _speaker(rng, signal, n)], axis=1)
            write_multichannel_wav(os.path.join(wav_dir, dialog + ".wav"),
                                   stereo)
            lines = ["% [START_TIME - END_TIME] TURN_NAME EMOTION [V, A, D]",
                     ""]
            t = 0.3
            for u in range(n_utts):
                dur = rng.uniform(0.5, 2.0)
                who = "FM"[rng.randint(2)]
                emo = IEMOCAP_EMOTIONS[rng.randint(len(IEMOCAP_EMOTIONS))]
                lines.append(f"[{t:.4f} - {t + dur:.4f}]\t{dialog}_{who}"
                             f"{u:03d}\t{emo}\t[2.5000, 3.0000, 2.0000]")
                lines.append(f"C-E{u % 3 + 1}:\tNeutral;\t()")
                t += dur + rng.uniform(0.1, 0.4)
            with open(os.path.join(emo_dir, dialog + ".txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
    return rel


def write_synthetic_arff(root, n_files=3, n_frames=50, seed=0):
    """openSMILE IS09 LLD ARFFs: name, frameTime, three LLDs (F0_sma the
    second, zero on unvoiced frames), class; returns their paths."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    paths = []
    for i in range(n_files):
        rows = []
        for t in range(n_frames):
            f0 = rng.uniform(80, 250) if rng.rand() > 0.3 else 0.0
            rows.append(f"'utt{i}',{t * 0.01:.2f},{rng.rand():.6f},"
                        f"{f0:.4f},{rng.randn():.6f},{i % 2}")
        text = ("@relation emo_lld\n\n@attribute name string\n"
                "@attribute frameTime numeric\n"
                "@attribute pcm_RMSenergy_sma numeric\n"
                "@attribute F0_sma numeric\n"
                "@attribute pcm_zcr_sma numeric\n"
                "@attribute class numeric\n\n@data\n" + "\n".join(rows)
                + "\n")
        paths.append(os.path.join(root, f"utt{i}.arff"))
        with open(paths[-1], "w") as f:
            f.write(text)
    return paths
