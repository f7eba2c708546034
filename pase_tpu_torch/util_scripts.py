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
  eval-ckpts     — the trainer's eval loss of each FE_e*.npz of a run
                   (the workers at their seeded init), one JSON file
  precompute-feats — every regression worker's target features of whole
                   utterances into a .feats.npz cache (``data/cache.py``)
  profile-step   — one JSON line: the train step's prepare vs model +
                   optimizer ms, steps/s, audio-s/s (bench.py's
                   distortion stack and ZNorm unless --bare)
  export-torch   — a native FE_e*.npz as a reference-keyed torch state
                   dict (``checkpoint.export_torch_state_dict``)

The flags and outputs are those of ``util_scripts.py``'s subcommands of
the same names; ``--device`` picks the card (default) or the CPU. Run as
``python -m pase_tpu_torch.util_scripts forward-chunk
--fe_cfg cfg/frontend/PASE+.cfg --fe_ckpt FE_e199.ckpt --wav_list ...``.
"""

import argparse
import glob
import json
import os
import tempfile

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


def _cfgs(opts):
    with open(opts.fe_cfg) as f:
        fe_cfg = json.load(f)
    with open(opts.net_cfg) as f:
        wk_cfg = json.load(f)
    return fe_cfg, wk_cfg


def eval_ckpts(opts):
    """The eval loss of every FE_e*.npz in --ckpt_dir (sorted by name),
    each loaded into the encoder of one Trainer whose workers keep their
    seeded init: --n_batches batches of the valid split of --data_root /
    --data_cfg (or --synthetic batches), written to --out_file as {name:
    total}."""
    from pase_tpu_torch.checkpoint import load_frontend_ckpt
    from pase_tpu_torch.data.dataset import (ChunkBatcher,
                                             LibriSpeechTupleDataset,
                                             SyntheticChunkBatcher)
    from pase_tpu_torch.precision import full_precision
    from pase_tpu_torch.trainer import Trainer
    full_precision()
    fe_cfg, wk_cfg = _cfgs(opts)
    cfg = dict(backprop_mode="base", hop=160, bpe=opts.n_batches, epoch=1,
               batch_size=opts.batch_size, chunk_size=opts.chunk_size,
               log_freq=100, save_path=opts.save_path
               or tempfile.mkdtemp(prefix="eval_ckpts_"))
    tr = Trainer(fe_cfg, wk_cfg, cfg, device=opts.device)
    if opts.synthetic:
        batcher = SyntheticChunkBatcher(opts.batch_size, opts.chunk_size)
    else:
        batcher = ChunkBatcher(LibriSpeechTupleDataset(
            opts.data_root, opts.data_cfg, "valid"), opts.batch_size,
            opts.chunk_size)
    results = {}
    for ck in sorted(glob.glob(os.path.join(opts.ckpt_dir, "FE_e*.npz"))):
        load_frontend_ckpt(ck, tr.model.frontend)
        m = tr.evaluate(batcher, n_batches=opts.n_batches)
        results[os.path.basename(ck)] = m["total"]
        print(f"{ck}: total loss {m['total']:.4f}")
    tr.logger.close()
    with open(opts.out_file, "w") as f:
        json.dump(results, f, indent=2)
    return results


def precompute_feats(opts):
    """Cache every regression worker's target features of the utterances
    of --wav_list (first column) or of --data_cfg's train and valid
    splits under --out_dir (``data/cache.precompute_features``)."""
    from pase_tpu_torch.data.cache import precompute_features
    from pase_tpu_torch.model import parse_workers_cfg
    meta = parse_workers_cfg(opts.net_cfg)
    if opts.wav_list:
        with open(opts.wav_list) as f:
            files = [ln.split()[0] for ln in f if ln.strip()]
    else:
        from pase_tpu_torch.data.io import load_data_cfg
        cfg = load_data_cfg(opts.data_cfg)
        files = [d["filename"] for split in ("train", "valid")
                 if split in cfg for d in cfg[split]["data"]]
    n = precompute_features(opts.data_root, files, meta, opts.out_dir,
                            hop=opts.hop, overwrite=opts.overwrite,
                            device=opts.device)
    print(f"Cached features for {n} new / {len(files)} listed utts "
          f"in {opts.out_dir}")
    return n


def profile_step(opts):
    """Print one JSON line of ``profiling.profile_train_step``: a fresh
    Trainer of --fe_cfg / --net_cfg at --batch_size x --chunk_size under
    --compute_dtype, with bench.py's distortion stack on its seeded
    assets and ZNorm statistics of 2 synthetic batches of 8 unless
    --bare (model and targets only)."""
    from pase_tpu_torch.precision import full_precision
    from pase_tpu_torch.profiling import profile_train_step
    from pase_tpu_torch.trainer import Trainer
    full_precision()
    fe_cfg, wk_cfg = _cfgs(opts)
    cfg = dict(backprop_mode="base", hop=160, bpe=1, epoch=1,
               batch_size=opts.batch_size, chunk_size=opts.chunk_size,
               log_freq=100, compute_dtype=opts.compute_dtype,
               save_path=tempfile.mkdtemp(prefix="profile_step_"))
    dcfg = assets = stats = None
    if not opts.bare:
        from pase_tpu_torch.bench import bench_assets
        from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
        from pase_tpu_torch.data.pipeline import compute_stats
        from pase_tpu_torch.model import parse_workers_cfg
        dcfg, assets = bench_assets(opts.chunk_size)
        stats = compute_stats(SyntheticChunkBatcher(8, opts.chunk_size,
                                                    seed=11),
                              parse_workers_cfg(wk_cfg), max_batches=2,
                              device=opts.device)
    tr = Trainer(fe_cfg, wk_cfg, cfg, stats=stats, dist_cfg=dcfg,
                 dist_assets=assets, device=opts.device)
    out = profile_train_step(tr, opts.batch_size, opts.chunk_size,
                             n_meas=opts.n_meas)
    tr.logger.close()
    print(json.dumps(out))
    return out


def export_torch(opts):
    """Write the native encoder artifact --in_ckpt as a reference-keyed
    torch state dict --out_ckpt."""
    import torch
    from pase_tpu_torch.checkpoint import (export_torch_state_dict,
                                           load_variables_npz)
    out = export_torch_state_dict(load_variables_npz(opts.in_ckpt))
    torch.save(out, opts.out_ckpt)
    print(f"Exported {len(out)} tensors -> {opts.out_ckpt}")
    return out


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

    def device_flag(parser):
        parser.add_argument("--device", default="cuda",
                            choices=("cuda", "cpu"),
                            help="where it runs (default: the card)")

    ec = sub.add_parser("eval-ckpts")
    ec.add_argument("--fe_cfg", required=True)
    ec.add_argument("--net_cfg", required=True)
    ec.add_argument("--ckpt_dir", required=True)
    ec.add_argument("--data_root", default=None)
    ec.add_argument("--data_cfg", default=None)
    ec.add_argument("--out_file", default="ckpt_losses.json")
    ec.add_argument("--batch_size", type=int, default=16)
    ec.add_argument("--chunk_size", type=int, default=16000)
    ec.add_argument("--n_batches", type=int, default=10)
    ec.add_argument("--save_path", default=None,
                    help="where the eval's metrics.jsonl goes (default: a "
                         "new temporary directory)")
    ec.add_argument("--synthetic", action="store_true")
    device_flag(ec)

    pc = sub.add_parser("precompute-feats")
    pc.add_argument("--net_cfg", required=True)
    pc.add_argument("--data_root", required=True)
    pc.add_argument("--wav_list", default=None)
    pc.add_argument("--data_cfg", default=None,
                    help="alternative to --wav_list: cache every "
                         "train+valid utterance of a data cfg")
    pc.add_argument("--out_dir", required=True)
    pc.add_argument("--hop", type=int, default=160)
    pc.add_argument("--overwrite", action="store_true", default=False)
    device_flag(pc)

    ps = sub.add_parser("profile-step")
    ps.add_argument("--fe_cfg", required=True)
    ps.add_argument("--net_cfg", required=True)
    ps.add_argument("--batch_size", type=int, default=32)
    ps.add_argument("--chunk_size", type=int, default=32000)
    ps.add_argument("--compute_dtype", default=None)
    ps.add_argument("--n_meas", type=int, default=20)
    ps.add_argument("--bare", action="store_true", default=False,
                    help="skip distortions + ZNorm (model+targets only)")
    device_flag(ps)

    et = sub.add_parser("export-torch")
    et.add_argument("--in_ckpt", required=True)
    et.add_argument("--out_ckpt", required=True)
    return p


def main(argv=None):
    opts = build_parser().parse_args(argv)
    return {"forward-chunk": forward_chunk, "export": export,
            "serve-encode": serve_encode, "eval-ckpts": eval_ckpts,
            "precompute-feats": precompute_feats,
            "profile-step": profile_step,
            "export-torch": export_torch}[opts.cmd](opts)


if __name__ == "__main__":
    main()
