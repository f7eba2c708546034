"""Dataset preparation CLI of the PyTorch port.

  build-cfg   — scp lists -> data-config JSON with train / valid / test
                splits (a speaker-held-out valid split), per-split total
                durations and speakers
  segment     — long wavs cut into <prefix>-<idx>.wav segments of
                --seg_len seconds (the LibriSpeech tuple sampler's names)
  probe-lists — downstream-probe lists (`wav label`), class_map.json and
                utt2class.json from an utt2class map (+ lists) or a
                directory-per-class tree
  vad-segment — energy-VAD long recordings into speech-segment wavs
  ami-segment — AMI's headset / far-field parallel segments + utt2spk.npy
  ami-cfg     — the AMI data cfg with per-channel distant-mic entries
  vctk-cfg    — VCTK's speaker-split data cfg from speaker-info.txt
  rirs-cfg    — the OpenSLR-28 RIR bank as a reverb distortion cfg
  voxceleb-lists — mini-VoxCeleb spk-id probe assets
  voxforge-lists — VoxForge LID probe assets
  chime5-cfg  — CHiME-5's worn / array paired data cfg from Kaldi dirs
  iemocap-segment — IEMOCAP sessions cut into per-class utterance wavs
  arff-to-npy — openSMILE IS09 LLD ARFFs -> npy features

The same subcommands, options, defaults and printed lines as the root
``data_prep.py``, and the same files (``data/prep.py``), all on the host.

    python -m pase_tpu_torch.data_prep ami-segment --data_root amicorpus \\
        --out_root ami_seg --ami_meeting_ids meetings.txt
    python -m pase_tpu_torch.data_prep ami-cfg --data_root ami_seg \\
        --train_scp train.scp --test_scp test.scp --cfg_file ami.cfg
    python -m pase_tpu_torch.data_prep chime5-cfg --ihm_dir worn \\
        --sdm_dir array --out_dir chime5_seg --cfg_file chime5.cfg
"""

import argparse
import json
import os
import random


def _read_scp(path):
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def _print_splits(path, cfg):
    print(f"Wrote {path}: " + ", ".join(
        f"{s}={len(cfg[s]['data'])}" for s in ("train", "valid", "test")))


def build_cfg(opts):
    """The data cfg of --train_scp (and --test_scp): the train list
    shuffled by random.Random(--seed), the first --val_ratio of its
    speakers (sorted; the name's part before the first '-') held out as
    the valid split; unreadable files skipped with a message."""
    from pase_tpu_torch.data.io import read_wav
    spk_info = {}
    if opts.libri_dict and os.path.exists(opts.libri_dict):
        with open(opts.libri_dict) as f:
            spk_info = json.load(f)

    def spk_of(fname):
        base = os.path.basename(fname)
        return base.split("-")[0] if "-" in base else "unk"

    def build_split(files):
        data, spks, total = [], set(), 0
        for fname in files:
            try:
                wav, _ = read_wav(os.path.join(opts.data_root, fname))
            except Exception as e:      # noqa: BLE001 - the root CLI's skip
                print(f"skipping {fname}: {e}")
                continue
            spk = spk_of(fname)
            spks.add(spk)
            total += len(wav)
            data.append({"filename": fname, "speaker": spk})
        return {"data": data, "speakers": sorted(spks),
                "total_wav_dur": total}

    train_files = _read_scp(opts.train_scp)
    random.Random(opts.seed).shuffle(train_files)
    spks = sorted({spk_of(f) for f in train_files})
    n_va_spk = max(int(len(spks) * opts.val_ratio), 1)
    va_spks = set(spks[:n_va_spk])
    cfg = {"speakers": spks,
           "train": build_split([f for f in train_files
                                 if spk_of(f) not in va_spks]),
           "valid": build_split([f for f in train_files
                                 if spk_of(f) in va_spks])}
    if opts.test_scp:
        cfg["test"] = build_split(_read_scp(opts.test_scp))
    if spk_info:
        cfg["spk2idx"] = {s: i for i, s in enumerate(spks)}
    with open(opts.cfg_file, "w") as f:
        json.dump(cfg, f, indent=2)
    print(f"Wrote {opts.cfg_file}: "
          f"{len(cfg['train']['data'])} train / "
          f"{len(cfg['valid']['data'])} valid files, "
          f"{cfg['train']['total_wav_dur'] / 16000 / 3600.0:.2f} h train")


def segment(opts):
    """Each wav of --data_root (sorted) cut every --seg_len seconds into
    <prefix>-<i>.wav under --out_root, a last piece shorter than a quarter
    segment dropped."""
    from pase_tpu_torch.data.io import read_wav, write_wav
    os.makedirs(opts.out_root, exist_ok=True)
    seg = int(opts.seg_len * 16000)
    count = 0
    for fname in sorted(os.listdir(opts.data_root)):
        if not fname.endswith(".wav"):
            continue
        wav, sr = read_wav(os.path.join(opts.data_root, fname))
        prefix = os.path.splitext(fname)[0]
        for i in range(0, max(len(wav) - seg // 2, 1), seg):
            piece = wav[i:i + seg]
            if len(piece) < seg // 4:
                continue
            write_wav(os.path.join(opts.out_root, f"{prefix}-{i // seg}.wav"),
                      piece, sr)
            count += 1
    print(f"Wrote {count} segments to {opts.out_root}")


def probe_lists(opts):
    """run_probe-format lists (`relpath label` per line: tr.lst, te.lst)
    with class_map.json and utt2class.json under --out_dir. Labels from
    --utt2class (a .npy or .json map; bare names match relpaths by
    basename) or --class_from dirname; membership from --train_list /
    --test_list, else the labelled wavs under --data_root split by
    --holdout top-level dirs or, per class, by random.Random(--seed) at
    --test_ratio. Class ids follow the sorted labels."""
    os.makedirs(opts.out_dir, exist_ok=True)

    def scan_wavs():
        out = []
        for dirpath, _, files in os.walk(opts.data_root):
            for f in sorted(files):
                if f.lower().endswith(".wav"):
                    out.append(os.path.relpath(os.path.join(dirpath, f),
                                               opts.data_root))
        return sorted(out)

    if opts.utt2class:
        from pase_tpu_torch.data.dataset import _load_utt2class
        u2c = {k: str(v) for k, v in _load_utt2class(opts.utt2class).items()}
        lookup = dict(u2c)
        for k, v in u2c.items():
            lookup.setdefault(os.path.basename(k), v)

        def label_of(rel):
            return lookup.get(rel, lookup.get(os.path.basename(rel)))
    elif opts.class_from == "dirname":
        def label_of(rel):
            d = os.path.dirname(rel)
            return os.path.basename(d) if d else None
    else:
        raise SystemExit("probe-lists needs --utt2class or "
                         "--class_from dirname")

    if opts.train_list:
        tr = _read_scp(opts.train_list)
        te = _read_scp(opts.test_list) if opts.test_list else []
    else:
        wavs = [w for w in scan_wavs() if label_of(w) is not None]
        if not wavs:
            raise SystemExit(f"no labeled wavs under {opts.data_root}")
        if opts.holdout:
            pats = opts.holdout.split(",")
            te = [w for w in wavs
                  if any(w.split(os.sep)[0] == p for p in pats)]
            te_set = set(te)
            tr = [w for w in wavs if w not in te_set]
        else:
            rng = random.Random(opts.seed)
            byc = {}
            for w in wavs:
                byc.setdefault(label_of(w), []).append(w)
            tr, te = [], []
            for c in sorted(byc):
                fs = byc[c]
                rng.shuffle(fs)
                n_te = max(int(round(len(fs) * opts.test_ratio)), 1) \
                    if len(fs) > 1 else 0
                te += fs[:n_te]
                tr += fs[n_te:]
            tr.sort()
            te.sort()

    labels = sorted({label_of(w) for w in tr + te if label_of(w)})
    cmap = {c: i for i, c in enumerate(labels)}

    def write_split(name, files):
        n = 0
        with open(os.path.join(opts.out_dir, name), "w") as f:
            for w in files:
                lab = label_of(w)
                if lab is None:
                    print(f"skipping {w}: no class label")
                    continue
                f.write(f"{w} {cmap[lab]}\n")
                n += 1
        return n

    n_tr = write_split("tr.lst", tr)
    n_te = write_split("te.lst", te)
    with open(os.path.join(opts.out_dir, "class_map.json"), "w") as f:
        json.dump(cmap, f, indent=2, sort_keys=True)
    with open(os.path.join(opts.out_dir, "utt2class.json"), "w") as f:
        json.dump({w: cmap[label_of(w)] for w in tr + te
                   if label_of(w) is not None}, f, indent=2, sort_keys=True)
    print(f"Wrote {opts.out_dir}: {n_tr} train / {n_te} test utts, "
          f"{len(cmap)} classes")


def vad_segment(opts):
    from pase_tpu_torch.data.prep import vad_segment_corpus
    if opts.file_list:
        files = _read_scp(opts.file_list)
    else:
        files = sorted(
            os.path.relpath(os.path.join(dp, fn), opts.data_root)
            for dp, _, fns in os.walk(opts.data_root)
            for fn in fns if fn.lower().endswith(".wav"))
    n = vad_segment_corpus(opts.data_root, files, opts.out_root,
                           channel=opts.channel,
                           vad_list_path=opts.vad_list)
    print(f"Wrote {n} VAD segments to {opts.out_root}")


def ami_segment_cmd(opts):
    from pase_tpu_torch.data.prep import ami_segment
    u2s = ami_segment(opts.data_root, opts.out_root,
                      _read_scp(opts.ami_meeting_ids),
                      map_ihm2sdm=opts.map_ihm2sdm,
                      utt2spk_name=opts.utt2spk_dict)
    print(f"Wrote {len(u2s)} AMI segments to {opts.out_root}")


def ami_cfg_cmd(opts):
    from pase_tpu_torch.data.prep import ami_data_cfg
    cfg = ami_data_cfg(opts.data_root, opts.train_scp, opts.test_scp,
                       map_ihm2sdm=opts.map_ihm2sdm,
                       val_ratio=opts.val_ratio, seed=opts.seed)
    with open(opts.cfg_file, "w") as f:
        json.dump(cfg, f)
    _print_splits(opts.cfg_file, cfg)


def vctk_cfg_cmd(opts):
    from pase_tpu_torch.data.prep import vctk_data_cfg
    cfg = vctk_data_cfg(opts.data_root, train_split=opts.train_split,
                        valid_split=opts.valid_split, min_len=opts.min_len,
                        max_utts_spk={"train": opts.max_train_utts_spk,
                                      "valid": opts.max_valid_utts_spk,
                                      "test": opts.max_test_utts_spk})
    with open(opts.cfg_file, "w") as f:
        json.dump(cfg, f)
    _print_splits(opts.cfg_file, cfg)


def rirs_cfg_cmd(opts):
    from pase_tpu_torch.data.prep import openslr_rirs_cfg
    out = openslr_rirs_cfg(opts.data_root, opts.out_file,
                           small_room_ratio=opts.small_room_ratio,
                           medium_room_ratio=opts.medium_room_ratio,
                           large_room_ratio=opts.large_room_ratio,
                           existing_cfg=opts.existing_cfg, seed=opts.seed)
    print(f"Wrote {opts.out_file} with {len(out['reverb_irfiles'])} IRs")


def voxceleb_cmd(opts):
    from pase_tpu_torch.data.prep import voxceleb_lists
    tr, te, _ = voxceleb_lists(opts.path_to_data, opts.out_path,
                               nspk=opts.nspk, out_length=opts.out_length,
                               sr=opts.out_sr, seed=opts.seed)
    print(f"Wrote {len(tr)} train / {len(te)} test utts under "
          f"{opts.out_path}")


def voxforge_cmd(opts):
    from pase_tpu_torch.data.prep import voxforge_lists
    tr, te, _ = voxforge_lists(opts.path_to_metadata, opts.path_to_data,
                               opts.out_path, nrecs=opts.nrecs,
                               out_length=opts.out_length, sr=opts.out_sr,
                               vad=opts.vad, traintest=True, seed=opts.seed)
    print(f"Wrote {len(tr)} train / {len(te)} test utts under "
          f"{opts.out_path}")


def chime5_cmd(opts):
    from pase_tpu_torch.data.prep import chime5_data_cfg
    cfg = chime5_data_cfg(opts.ihm_dir, opts.sdm_dir, opts.out_dir,
                          valid_spk=opts.valid_spk, test_spk=opts.test_spk,
                          cut_segments=not opts.no_cut)
    with open(opts.cfg_file, "w") as f:
        json.dump(cfg, f)
    _print_splits(opts.cfg_file, cfg)


def iemocap_cmd(opts):
    from pase_tpu_torch.data.prep import iemocap_segment
    counts = iemocap_segment(opts.iemocap_root, opts.out_dir)
    for sess in sorted(counts):
        total = sum(counts[sess].values())
        print(f"{sess}: {total} utts " + json.dumps(counts[sess]))


def arff_cmd(opts):
    from pase_tpu_torch.data.prep import arff_lld_to_npy
    files = list(opts.arff_files or [])
    if opts.arff_root:
        for base, _, names in os.walk(opts.arff_root):
            files += [os.path.join(base, n) for n in names
                      if n.endswith(".arff")]
    written = arff_lld_to_npy(sorted(files), out_stats=opts.out_stats)
    print(f"Wrote {len(written)} npy files"
          + (f" + stats {opts.out_stats}" if opts.out_stats else ""))


def build_parser():
    p = argparse.ArgumentParser(prog="python -m pase_tpu_torch.data_prep")
    sub = p.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build-cfg")
    b.add_argument("--data_root", required=True)
    b.add_argument("--train_scp", required=True)
    b.add_argument("--test_scp", default=None)
    b.add_argument("--libri_dict", default=None)
    b.add_argument("--cfg_file", required=True)
    b.add_argument("--val_ratio", type=float, default=0.1)
    b.add_argument("--seed", type=int, default=3)

    s = sub.add_parser("segment")
    s.add_argument("--data_root", required=True)
    s.add_argument("--out_root", required=True)
    s.add_argument("--seg_len", type=float, default=15.0)

    pl = sub.add_parser("probe-lists")
    pl.add_argument("--data_root", required=True)
    pl.add_argument("--out_dir", required=True)
    pl.add_argument("--utt2class", default=None,
                    help="utt2spk/utt2lang map (.npy pickled dict or .json)")
    pl.add_argument("--class_from", default=None, choices=["dirname"],
                    help="infer label from parent directory name")
    pl.add_argument("--train_list", default=None,
                    help="existing bare filename list (reference asset)")
    pl.add_argument("--test_list", default=None)
    pl.add_argument("--holdout", default=None,
                    help="comma-sep top-level dirs held out as test "
                         "(e.g. session5 for IEMOCAP leave-session-out)")
    pl.add_argument("--test_ratio", type=float, default=0.2)
    pl.add_argument("--seed", type=int, default=0)

    vs = sub.add_parser("vad-segment")
    vs.add_argument("--data_root", required=True)
    vs.add_argument("--out_root", required=True)
    vs.add_argument("--file_list", default=None,
                    help="relpaths to segment (default: all wavs)")
    vs.add_argument("--vad_list", default=None,
                    help="write the `file beg end segid` VAD list here")
    vs.add_argument("--channel", type=int, default=0)

    ams = sub.add_parser("ami-segment")
    ams.add_argument("--data_root", required=True)
    ams.add_argument("--out_root", required=True)
    ams.add_argument("--ami_meeting_ids", required=True)
    ams.add_argument("--map_ihm2sdm", default="1,3,5,7")
    ams.add_argument("--utt2spk_dict", default="utt2spk.npy")

    amc = sub.add_parser("ami-cfg")
    amc.add_argument("--data_root", required=True)
    amc.add_argument("--train_scp", required=True)
    amc.add_argument("--test_scp", required=True)
    amc.add_argument("--cfg_file", required=True)
    amc.add_argument("--map_ihm2sdm", default="1,3,5,7")
    amc.add_argument("--val_ratio", type=float, default=0.1)
    amc.add_argument("--seed", type=int, default=3)

    vc = sub.add_parser("vctk-cfg")
    vc.add_argument("--data_root", required=True)
    vc.add_argument("--cfg_file", required=True)
    vc.add_argument("--train_split", type=float, default=0.88)
    vc.add_argument("--valid_split", type=float, default=0.06)
    vc.add_argument("--min_len", type=int, default=16000)
    vc.add_argument("--max_train_utts_spk", type=int, default=0)
    vc.add_argument("--max_valid_utts_spk", type=int, default=0)
    vc.add_argument("--max_test_utts_spk", type=int, default=0)

    rc = sub.add_parser("rirs-cfg")
    rc.add_argument("--data_root", required=True)
    rc.add_argument("--out_file", required=True)
    rc.add_argument("--small_room_ratio", type=float, default=1.0)
    rc.add_argument("--medium_room_ratio", type=float, default=1.0)
    rc.add_argument("--large_room_ratio", type=float, default=1.0)
    rc.add_argument("--existing_cfg", default=None)
    rc.add_argument("--seed", type=int, default=None)

    vxc = sub.add_parser("voxceleb-lists")
    vxc.add_argument("--path_to_data", required=True)
    vxc.add_argument("--out_path", required=True)
    vxc.add_argument("--nspk", type=int, default=100)
    vxc.add_argument("--out_length", type=int, default=10)
    vxc.add_argument("--out_sr", type=int, default=16000)
    vxc.add_argument("--seed", type=int, default=None)

    vxf = sub.add_parser("voxforge-lists")
    vxf.add_argument("--path_to_data", required=True)
    vxf.add_argument("--path_to_metadata", required=True)
    vxf.add_argument("--out_path", required=True)
    vxf.add_argument("--nrecs", type=int, default=30)
    vxf.add_argument("--out_length", type=int, default=10)
    vxf.add_argument("--out_sr", type=int, default=16000)
    vxf.add_argument("--vad", action="store_true")
    vxf.add_argument("--seed", type=int, default=None)

    c5 = sub.add_parser("chime5-cfg")
    c5.add_argument("--ihm_dir", required=True)
    c5.add_argument("--sdm_dir", required=True)
    c5.add_argument("--out_dir", required=True)
    c5.add_argument("--cfg_file", required=True)
    c5.add_argument("--valid_spk", default="P42")
    c5.add_argument("--test_spk", default="P41")
    c5.add_argument("--no_cut", action="store_true",
                    help="only write the cfg, do not cut segment wavs")

    im = sub.add_parser("iemocap-segment",
                        help="cut IEMOCAP sessions into per-class utt wavs")
    im.add_argument("--iemocap_root", required=True,
                    help="IEMOCAP_full_release dir holding Session1..5")
    im.add_argument("--out_dir", required=True)

    ar = sub.add_parser("arff-to-npy",
                        help="openSMILE IS09 LLD ARFF -> npy features")
    ar.add_argument("--arff_root", default=None,
                    help="walk this tree for .arff files")
    ar.add_argument("--arff_files", default=None, nargs="+")
    ar.add_argument("--out_stats", default=None,
                    help="optional {'mean','std'} pickle over all frames")
    return p


def main(argv=None):
    opts = build_parser().parse_args(argv)
    {"build-cfg": build_cfg, "segment": segment, "probe-lists": probe_lists,
     "vad-segment": vad_segment, "ami-segment": ami_segment_cmd,
     "ami-cfg": ami_cfg_cmd, "vctk-cfg": vctk_cfg_cmd,
     "rirs-cfg": rirs_cfg_cmd, "voxceleb-lists": voxceleb_cmd,
     "voxforge-lists": voxforge_cmd, "chime5-cfg": chime5_cmd,
     "iemocap-segment": iemocap_cmd, "arff-to-npy": arff_cmd}[opts.cmd](opts)


if __name__ == "__main__":
    main()
