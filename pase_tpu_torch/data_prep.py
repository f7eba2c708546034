"""Dataset preparation CLI of the PyTorch port.

  build-cfg   — scp lists -> data-config JSON with train / valid / test
                splits (a speaker-held-out valid split), per-split total
                durations and speakers
  vad-segment — energy-VAD long recordings into speech-segment wavs
  ami-segment — AMI's headset / far-field parallel segments + utt2spk.npy
  ami-cfg     — the AMI data cfg with per-channel distant-mic entries

The same subcommands, options and defaults as the root ``data_prep.py``,
and the same files (``data/prep.py``). Its other subcommands parse here
and raise ``NotImplementedError``: ROADMAP.md, queue 1, item 11b part 4.

    python -m pase_tpu_torch.data_prep ami-segment --data_root amicorpus \\
        --out_root ami_seg --ami_meeting_ids meetings.txt
    python -m pase_tpu_torch.data_prep ami-cfg --data_root ami_seg \\
        --train_scp train.scp --test_scp test.scp --cfg_file ami.cfg
"""

import argparse
import json
import os
import random

ROADMAP_PREP = "ROADMAP.md, queue 1, item 11b part 4: corpus preparation"
# the root CLI's subcommands that are not ported yet
UNPORTED = ("segment", "probe-lists", "vctk-cfg", "rirs-cfg",
            "voxceleb-lists", "voxforge-lists", "chime5-cfg",
            "iemocap-segment", "arff-to-npy")


def _read_scp(path):
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


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
    print(f"Wrote {opts.cfg_file}: "
          + ", ".join(f"{s}={len(cfg[s]['data'])}"
                      for s in ("train", "valid", "test")))


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

    for name in UNPORTED:
        sub.add_parser(name, help=f"not ported yet ({ROADMAP_PREP})")
    return p


def main(argv=None):
    opts, rest = build_parser().parse_known_args(argv)
    if opts.cmd in UNPORTED:
        raise NotImplementedError(
            f"data_prep {opts.cmd} is not ported yet: {ROADMAP_PREP}")
    if rest:
        build_parser().error(f"unrecognized arguments: {' '.join(rest)}")
    {"build-cfg": build_cfg, "vad-segment": vad_segment,
     "ami-segment": ami_segment_cmd, "ami-cfg": ami_cfg_cmd}[opts.cmd](opts)


if __name__ == "__main__":
    main()
