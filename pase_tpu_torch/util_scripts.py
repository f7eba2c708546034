"""Utility CLI of the PyTorch port.

  forward-chunk  — encode wavs of any length with a frozen encoder in
                   independent windows (same flags and semantics as
                   ``util_scripts.py forward-chunk`` of the JAX package)

Run as ``python -m pase_tpu_torch.util_scripts forward-chunk
--fe_cfg cfg/frontend/PASE+.cfg --fe_ckpt FE_e199.ckpt --wav_list ...``.
"""

import argparse
import os

import numpy as np
import torch

HOP = 160


def _encode_wav_list(opts, encode_fn):
    """--wav_list loop: one .npy per list entry under --out_dir, keeping
    each entry's relative path (spk1/utt.wav and spk2/utt.wav differ)."""
    out_dir = opts.out_dir or "."
    with open(opts.wav_list) as f:
        files = [ln.strip() for ln in f if ln.strip()]
    for rel in files:
        key = os.path.splitext(rel)[0].lstrip(os.sep)
        out_file = os.path.join(out_dir, key + ".npy")
        os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
        encode_fn(os.path.join(opts.files_root or "", rel), out_file)


def forward_chunk(opts):
    """Encode each wav in independent windows of --chunk_size samples (the
    tail zero-padded), concatenate, trim to len(wav)//160 frames and save
    an [emb, F] .npy."""
    if opts.streaming:
        raise NotImplementedError(
            "--streaming is not ported yet: ROADMAP.md, queue 1: streaming "
            "encoder")
    if opts.time_shard:
        raise NotImplementedError(
            "--time_shard is not ported yet: ROADMAP.md, queue 1: multi-GPU")
    if not opts.wav_list and not (opts.in_wav and opts.out_file):
        raise SystemExit(
            "forward-chunk needs --in_wav + --out_file, or --wav_list")
    # feature extraction at full float32 precision (no TF32 matmuls or
    # convolutions), as the JAX CLI runs at 'highest'
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from pase_tpu_torch.data.io import read_wav
    from pase_tpu_torch.frontend import wf_builder
    enc = wf_builder(opts.fe_cfg, device=opts.device)
    if opts.fe_ckpt:
        enc.load_pretrained(opts.fe_ckpt, load_last=True)
    chunk = opts.chunk_size

    def encode_one(in_wav, out_file):
        wav, _ = read_wav(in_wav)
        feats = []
        for beg in range(0, len(wav), chunk):
            piece = wav[beg:beg + chunk]
            if len(piece) < chunk:
                piece = np.pad(piece, (0, chunk - len(piece)))
            feats.append(enc(piece[None, None, :])[0].cpu().numpy())
        out = np.concatenate(feats, axis=1)[:, :len(wav) // HOP]
        np.save(out_file, out)
        print(f"{in_wav}: {out.shape} -> {out_file}")

    if opts.wav_list:
        _encode_wav_list(opts, encode_one)
        return
    encode_one(opts.in_wav, opts.out_file)


def build_parser():
    p = argparse.ArgumentParser(prog="python -m pase_tpu_torch.util_scripts")
    sub = p.add_subparsers(dest="cmd", required=True)
    fc = sub.add_parser("forward-chunk")
    fc.add_argument("--fe_cfg", required=True)
    fc.add_argument("--fe_ckpt", default=None,
                    help="native FE_e*.npz or reference torch FE_e*.ckpt; "
                         "without it the seeded random init is used")
    fc.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the encoder runs (default: the card)")
    fc.add_argument("--in_wav", default=None)
    fc.add_argument("--out_file", default=None)
    fc.add_argument("--wav_list", default=None,
                    help="batch mode: file of wav paths (one per line); "
                         "writes <out_dir>/<relative path>.npy per wav")
    fc.add_argument("--files_root", default="",
                    help="prefix joined to each --wav_list entry")
    fc.add_argument("--out_dir", default=".",
                    help="output dir for --wav_list mode")
    fc.add_argument("--chunk_size", type=int, default=160000)
    fc.add_argument("--streaming", action="store_true", default=False,
                    help="not ported yet (raises)")
    fc.add_argument("--time_shard", action="store_true", default=False,
                    help="not ported yet (raises)")
    return p


def main(argv=None):
    opts = build_parser().parse_args(argv)
    {"forward-chunk": forward_chunk}[opts.cmd](opts)


if __name__ == "__main__":
    main()
