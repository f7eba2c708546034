"""Utility CLI of the PyTorch port.

  forward-chunk  — encode wavs of any length with a frozen encoder in
                   independent windows, or with ``--streaming`` through
                   the exact online encoder in pieces of ``--chunk_size``
                   (same flags and semantics as ``util_scripts.py
                   forward-chunk`` of the JAX package)
  export         — write a ``torch.export`` serving artifact of the encoder
                   (``serving.py``; the counterpart of ``export-jax``)
  serve-encode   — encode wavs with such an artifact, no model code (same
                   [emb, F] .npy contract as forward-chunk)

Run as ``python -m pase_tpu_torch.util_scripts forward-chunk
--fe_cfg cfg/frontend/PASE+.cfg --fe_ckpt FE_e199.ckpt --wav_list ...``.
"""

import argparse
import os

import numpy as np

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


def _encoder(opts):
    from pase_tpu_torch.frontend import wf_builder
    enc = wf_builder(opts.fe_cfg, device=opts.device)
    if opts.fe_ckpt:
        enc.load_pretrained(opts.fe_ckpt, load_last=True)
    return enc


def _needs_input(opts, cmd):
    if not opts.wav_list and not (opts.in_wav and opts.out_file):
        raise SystemExit(f"{cmd} needs --in_wav + --out_file, or --wav_list")


def forward_chunk(opts):
    """Encode each wav in independent windows of --chunk_size samples (the
    tail zero-padded), or with --streaming through the online encoder in
    pieces of --chunk_size; concatenate, trim to len(wav)//160 frames and
    save an [emb, F] .npy."""
    if opts.time_shard:
        raise NotImplementedError(
            "--time_shard is not ported yet: ROADMAP.md, queue 1: multi-GPU")
    _needs_input(opts, "forward-chunk")
    from pase_tpu_torch.data.io import read_wav
    from pase_tpu_torch.precision import full_precision
    from pase_tpu_torch.streaming import stream_frames
    full_precision()
    enc = _encoder(opts)
    chunk = opts.chunk_size

    def encode_one(in_wav, out_file):
        wav, _ = read_wav(in_wav)
        if opts.streaming:
            # the exact online encoder: the frames of one forward of the
            # whole file, fed in pieces of --chunk_size
            feats = [stream_frames(enc, wav[None], chunk)[0].cpu().numpy()]
        else:
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


def export(opts):
    """Write a serving artifact: one program per --chunk_sizes bucket, and
    with --streaming_chunk the prime / step / flush programs of the online
    encoder, traced on --device (the device the artifact serves)."""
    from pase_tpu_torch.serving import (export_encoder,
                                        export_streaming_encoder)
    enc = _encoder(opts)
    chunk_sizes = [int(t) for t in opts.chunk_sizes.split(",") if t]
    export_encoder(enc, opts.out_dir, chunk_sizes=chunk_sizes,
                   weights_dtype=opts.weights_dtype)
    print(f"exported {len(chunk_sizes)} bucket(s) {chunk_sizes} for "
          f"{opts.device} -> {opts.out_dir}")
    if opts.streaming_chunk:
        export_streaming_encoder(enc, opts.out_dir,
                                 chunk=opts.streaming_chunk,
                                 weights_dtype=opts.weights_dtype)
        print(f"exported streaming prime/step/flush programs (chunk "
              f"{opts.streaming_chunk}) -> {opts.out_dir}")


def serve_encode(opts):
    """Encode wavs with an ``export`` artifact (no model code, no cfg):
    the [emb, F] .npy contract of forward-chunk; --batch_size > 1 batches
    list entries of one bucket through one call; --streaming drives the
    streaming programs (the tail zero-padded to a whole chunk, frames
    trimmed to len // hop)."""
    from pase_tpu_torch.data.io import read_wav
    from pase_tpu_torch.serving import (ServingEncoder,
                                        ServingStreamingEncoder)
    _needs_input(opts, "serve-encode")
    if opts.streaming:
        if opts.batch_size > 1:
            raise SystemExit("--streaming does not batch a wav list; "
                             "stream each file (batch_size 1)")
        srv = ServingStreamingEncoder(opts.export_dir)
        hop = int(srv.meta["hop"])

        def one(in_wav, out_file):
            wav, _ = read_wav(in_wav)
            c = srv.chunk
            padded = np.pad(wav, (0, (-len(wav)) % c))
            srv.reset()
            ys = [srv.push(padded[i:i + c])
                  for i in range(0, len(padded), c)] + [srv.flush()]
            out = np.concatenate(ys, axis=2)[0][:, :len(wav) // hop]
            np.save(out_file, out)
            print(f"{in_wav}: {out.shape} -> {out_file} (streaming chunk "
                  f"{c})")
    else:
        srv = ServingEncoder(opts.export_dir)

        def one(in_wav, out_file):
            wav, _ = read_wav(in_wav)
            out = srv.encode(wav)
            np.save(out_file, out)
            print(f"{in_wav}: {out.shape} -> {out_file} (buckets "
                  f"{srv.buckets})")

    if opts.wav_list and opts.batch_size > 1:
        with open(opts.wav_list) as f:
            files = [ln.strip() for ln in f if ln.strip()]
        for beg in range(0, len(files), opts.batch_size):
            names = files[beg:beg + opts.batch_size]
            outs = srv.encode_batch([
                read_wav(os.path.join(opts.files_root or "", rel))[0]
                for rel in names])
            for rel, out in zip(names, outs):
                key = os.path.splitext(rel)[0].lstrip(os.sep)
                out_file = os.path.join(opts.out_dir or ".", key + ".npy")
                os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
                np.save(out_file, out)
                print(f"{rel}: {out.shape} -> {out_file}")
        return
    if opts.wav_list:
        _encode_wav_list(opts, one)
        return
    one(opts.in_wav, opts.out_file)


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
                    help="stream each wav through the exact online encoder "
                         "in pieces of --chunk_size (pase_tpu_torch/"
                         "streaming.py)")
    fc.add_argument("--time_shard", action="store_true", default=False,
                    help="not ported yet (raises)")

    ex = sub.add_parser("export")
    ex.add_argument("--fe_cfg", required=True)
    ex.add_argument("--fe_ckpt", default=None,
                    help="native FE_e*.npz or reference torch FE_e*.ckpt; "
                         "without it the seeded random init is used")
    ex.add_argument("--out_dir", required=True)
    ex.add_argument("--chunk_sizes", default="8000,16000,32000,64000",
                    help="comma-separated static time buckets (samples)")
    ex.add_argument("--streaming_chunk", type=int, default=None,
                    help="also export the online encoder as prime/step/"
                         "flush programs at this chunk size (samples)")
    ex.add_argument("--weights_dtype", default=None,
                    help="e.g. bfloat16: the programs take their weights "
                         "in that type and compute in float32")
    ex.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the device the artifact is traced on and serves "
                         "(default: the card)")

    se = sub.add_parser("serve-encode")
    se.add_argument("--export_dir", required=True)
    se.add_argument("--in_wav", default=None)
    se.add_argument("--out_file", default=None)
    se.add_argument("--wav_list", default=None,
                    help="batch mode: file of wav paths (one per line); "
                         "writes <out_dir>/<relative path>.npy per wav")
    se.add_argument("--files_root", default="")
    se.add_argument("--out_dir", default=".")
    se.add_argument("--batch_size", type=int, default=1,
                    help=">1 batches list entries of one bucket through "
                         "one call")
    se.add_argument("--streaming", action="store_true",
                    help="drive the streaming (prime/step/flush) programs "
                         "instead of the offline buckets")
    return p


def main(argv=None):
    opts = build_parser().parse_args(argv)
    {"forward-chunk": forward_chunk, "export": export,
     "serve-encode": serve_encode}[opts.cmd](opts)


if __name__ == "__main__":
    main()
