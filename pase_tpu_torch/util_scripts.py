"""Utility CLI of the PyTorch port.

  forward-chunk  — encode wavs of any length with a frozen encoder in
                   independent windows, or with ``--streaming`` through
                   the exact online encoder in pieces of ``--chunk_size``,
                   or with ``--time_shard`` in one forward of each whole
                   wav over the visible cards (same flags and semantics
                   as ``util_scripts.py forward-chunk`` of the JAX
                   package)
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
  clusterize     — KMeans over the frame embeddings of a wav list (.npz of
                   centers and assignments)
  project-features — PCA of the frame embeddings to --n_components (.npy)
  prosodic-eval  — the prosody head of a weights_PASE-*.npz against the
                   prosody targets: logF0 / energy / zcr RMSE, U/V accuracy
  make-fbanks    — a <stem>.npy of fbank features per wav of a list
  vadproc        — a <stem>.vad file of `beg end` speech regions (samples)
                   per wav of a list (frame-energy VAD)
  make-contaminated — the distortion stack of a --dtrans_cfg applied to
                   each whole wav of a list
  select-ckpt    — the best of a glob of probe-metric JSONs
  encode-codec2  — every wav of a directory through the codec2 round trip
                   of the host distortion stage (a cache for codec2_cachedir)

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


def _time_shard_devices(device):
    """The devices of --time_shard: every visible card on the card, the
    CPU once on the CPU."""
    import torch
    if torch.device(device).type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device)]


def forward_chunk(opts):
    """Encode each wav in independent windows of --chunk_size samples (the
    tail zero-padded), or with --streaming through the online encoder in
    pieces of --chunk_size, or with --time_shard in one forward of the
    whole file with its time axis over the visible cards
    (``parallel/sp.py``; the wav zero-padded to the grid of D x 160
    samples); concatenate, trim to len(wav)//160 frames and save an
    [emb, F] .npy."""
    _needs_input(opts, "forward-chunk")
    from pase_tpu_torch.data.io import read_wav
    from pase_tpu_torch.streaming import stream_frames
    enc = _encoder(opts)
    chunk = opts.chunk_size

    def encode_one(in_wav, out_file):
        wav, _ = read_wav(in_wav)
        if opts.time_shard:
            from pase_tpu_torch.parallel.sp import encode_time_sharded
            devices = _time_shard_devices(opts.device)
            grid = len(devices) * HOP
            n = -(-len(wav) // grid) * grid
            piece = np.pad(wav.astype(np.float32), (0, n - len(wav)))
            y = encode_time_sharded(enc, piece[None], devices)
            out = y[0, :len(wav) // HOP].T.cpu().numpy()
            np.save(out_file, out)
            print(f"{in_wav}: {out.shape} -> {out_file} (time-sharded "
                  f"over {len(devices)} devices)")
            return
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
    from pase_tpu_torch.trainer import Trainer
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
    from pase_tpu_torch.profiling import profile_train_step
    from pase_tpu_torch.trainer import Trainer
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


def _wav_paths(opts):
    """The first column of each non-empty line of --wav_list."""
    with open(opts.wav_list) as f:
        return [ln.split()[0] for ln in f if ln.strip()]


def kmeans_init(n, k, seed=0):
    """``k`` distinct rows of ``n``, drawn by a CPU torch.Generator seeded
    with ``seed`` (JAX's draw, ``jax.random.choice``, cannot be reproduced
    here)."""
    import torch
    return torch.randperm(n, generator=torch.Generator().manual_seed(seed))[:k]


def kmeans_assign(x, centers, sq):
    """The first nearest of ``centers`` [k, D] to each row of ``x`` [N, D]
    by |x|^2 + |c|^2 - 2 x c^T (``sq``: |x|^2 as [N, 1])."""
    import torch
    d = sq + torch.sum(centers ** 2, 1)[None] - 2 * x @ centers.T
    return torch.argmin(d, dim=1)


def kmeans_means(x, assign, centers):
    """Lloyd's update: each centre the mean of its rows (one-hot sums); an
    empty cluster keeps its centre."""
    import torch
    onehot = torch.nn.functional.one_hot(assign, centers.shape[0]).to(x.dtype)
    counts = onehot.sum(0)
    new = (onehot.T @ x) / torch.clamp(counts[:, None], min=1)
    return torch.where(counts[:, None] > 0, new, centers)


def kmeans(x, k, iters=50, seed=0, init_idx=None):
    """Lloyd's KMeans of the rows of ``x`` [N, D] on its device, as the JAX
    package's ``util_scripts.kmeans``: ``kmeans_assign`` then
    ``kmeans_means``, ``iters`` times. The ``k`` initial centres are the
    rows ``init_idx``, or ``kmeans_init(N, k, seed)``'s. Returns (centers
    [k, D], the last step's assignments [N]) as numpy."""
    import torch
    if init_idx is None:
        init_idx = kmeans_init(x.shape[0], k, seed)
    centers = x[torch.as_tensor(np.array(init_idx), device=x.device)]
    sq = torch.sum(x ** 2, 1)[:, None]
    for _ in range(iters):
        assign = kmeans_assign(x, centers, sq)
        centers = kmeans_means(x, assign, centers)
    return centers.cpu().numpy(), assign.cpu().numpy()


def _frame_features(opts):
    """The frame embeddings [sum of frames, D] of the first --max_utts
    wavs of --wav_list (``probes.extract.FeatureExtractor``)."""
    from pase_tpu_torch.probes.extract import FeatureExtractor
    ex = FeatureExtractor(opts.fe_cfg, opts.fe_ckpt, device=opts.device)
    return np.concatenate([
        ex.extract_file(os.path.join(opts.data_root, p))
        for p in _wav_paths(opts)[:opts.max_utts or None]], axis=0)


def clusterize(opts, init_idx=None):
    """KMeans (--k centres, 50 steps) of the frame embeddings of a wav
    list on --device; writes --out_file (.npz: centers, assignments).
    ``init_idx``: the initial centres' rows (default: ``kmeans``'s
    seeded draw)."""
    import torch
    x = torch.as_tensor(_frame_features(opts), device=opts.device)
    centers, assign = kmeans(x, opts.k, init_idx=init_idx)
    np.savez(opts.out_file, centers=centers, assignments=assign)
    print(f"KMeans k={opts.k}: inertia counts "
          f"{np.bincount(assign, minlength=opts.k)}")
    return centers, assign


def project_features(opts):
    """PCA of the frame embeddings of a wav list: centred frames, their
    covariance and its eigenvectors on the host (numpy), the frames
    projected on the --n_components largest; writes --out_file (.npy)."""
    x = _frame_features(opts)
    x = x - x.mean(axis=0)
    w, v = np.linalg.eigh(x.T @ x / len(x))
    proj = x @ v[:, ::-1][:, :opts.n_components]
    np.save(opts.out_file, proj)
    ev = w[::-1][:opts.n_components] / w.sum()
    print(f"projected {x.shape} -> {proj.shape}; explained var "
          f"{ev.round(3).tolist()}")
    return proj, w


def prosodic_eval(opts):
    """The prosody head of a full PASE checkpoint (weights_PASE-*.npz, of
    either package) against the prosody targets of each wav of a list (cut
    to whole 160-sample frames): the encoder in eval mode, then the head;
    with r > 1 the centre offset of its d-major frames (channel c = d r +
    j); de-normalized with --stats. Prints and returns {lf0_rmse,
    egy_rmse, zcr_rmse, uv_acc, n_utts} (columns [lf0, uv, egy, zcr])."""
    import torch
    from pase_tpu_torch.checkpoint import (load_model_variables,
                                           load_variables)
    from pase_tpu_torch.data.io import read_wav
    from pase_tpu_torch.data.pipeline import load_stats_pkl
    from pase_tpu_torch.model import build_pase
    from pase_tpu_torch.ops.features import prosody
    fe_cfg, wk_cfg = _cfgs(opts)
    model, meta = build_pase(fe_cfg, wk_cfg)
    flat, _ = load_variables(opts.ckpt)
    load_model_variables(model, {k: v for k, v in flat.items() if
                                 k.startswith(("params/", "batch_stats/"))})
    model.to(opts.device).eval()
    stats = load_stats_pkl(opts.stats) if opts.stats else None
    entry = next(e for e in meta["regr"] if e["name"] == "prosody")
    head, r = model.workers["prosody"], int(entry.get("r", 1) or 1)
    rmse = {"lf0": [], "egy": [], "zcr": []}
    uv_acc = []
    paths = _wav_paths(opts)[:opts.max_utts]
    for p in paths:
        wav, _ = read_wav(os.path.join(opts.data_root, p))
        t = (len(wav) // HOP) * HOP
        x = torch.as_tensor(wav[None, :t], dtype=torch.float32,
                            device=opts.device)
        with torch.no_grad():
            h = model.frontend(x).transpose(1, 2)            # [1, emb, F]
            pred = head(h, 1.0).transpose(1, 2)[0].cpu().numpy()
            truth = prosody(x)[0].cpu().numpy()              # [F, D]
        if r > 1:
            pred = pred.reshape(len(pred), -1, r)[..., r // 2]
        if stats and "prosody" in stats:
            mean = np.asarray(stats["prosody"]["mean"]).reshape(-1)
            std = np.asarray(stats["prosody"]["std"]).reshape(-1)
            pred = pred * std[:pred.shape[1]] + mean[:pred.shape[1]]
        n = min(len(pred), len(truth))
        pred, truth = pred[:n], truth[:n]
        for col, name in ((0, "lf0"), (2, "egy"), (3, "zcr")):
            rmse[name].append(
                float(np.sqrt(np.mean((pred[:, col] - truth[:, col]) ** 2))))
        uv_acc.append(float((np.round(np.clip(pred[:, 1], 0, 1))
                             == truth[:, 1]).mean()))
    res = {f"{k}_rmse": float(np.mean(v)) for k, v in rmse.items()}
    res["uv_acc"] = float(np.mean(uv_acc))
    res["n_utts"] = len(paths)
    print(json.dumps(res))
    if opts.out_file:
        with open(opts.out_file, "w") as f:
            json.dump(res, f)
    return res


def make_fbanks(opts):
    """python_speech_features log fbanks (``ops.features.fbanks``,
    --n_filters, with deltas) of each wav of a list on --device, one
    <out_dir>/<stem>.npy [T // 160, 3 n_filters] each."""
    import torch
    from pase_tpu_torch.data.io import read_wav
    from pase_tpu_torch.ops.features import fbanks
    os.makedirs(opts.out_dir, exist_ok=True)
    paths = _wav_paths(opts)
    for p in paths:
        wav, _ = read_wav(os.path.join(opts.data_root, p))
        with torch.no_grad():
            y = fbanks(torch.as_tensor(wav[None], device=opts.device),
                       n_filters=opts.n_filters)[0].cpu().numpy()
        np.save(os.path.join(opts.out_dir, os.path.splitext(
            os.path.basename(p))[0] + ".npy"), y)
    print(f"Wrote {len(paths)} fbank files to {opts.out_dir}")
    return len(paths)


def vadproc(opts):
    """Frame-energy VAD of each wav of a list (on the host): 160-sample
    frames, speech where the frame's energy in dB exceeds max(the loudest
    frame's + --thresh_db, -55); writes <out_dir>/<stem>.vad, one `beg end`
    line (samples) per speech region."""
    from pase_tpu_torch.data.io import read_wav
    os.makedirs(opts.out_dir, exist_ok=True)
    paths = _wav_paths(opts)
    win = HOP
    for p in paths:
        wav, _ = read_wav(os.path.join(opts.data_root, p))
        n = len(wav) // win
        fe = 10 * np.log10(
            np.mean(wav[:n * win].reshape(n, win) ** 2, axis=1) + 1e-12)
        thresh = max(fe.max() + opts.thresh_db, -55.0)
        regions, beg = [], None
        for i, s in enumerate(fe > thresh):
            if s and beg is None:
                beg = i
            elif not s and beg is not None:
                regions.append((beg * win, i * win))
                beg = None
        if beg is not None:
            regions.append((beg * win, n * win))
        out = os.path.join(opts.out_dir,
                           os.path.splitext(os.path.basename(p))[0] + ".vad")
        with open(out, "w") as f:
            for b, e in regions:
                f.write(f"{b} {e}\n")
    print(f"Wrote VAD regions for {len(paths)} files to {opts.out_dir}")
    return len(paths)


def make_contaminated(opts):
    """The distortion stack of --dtrans_cfg (its assets built for
    --chunk_size, as ``train.build_distortions`` builds them) applied on
    --device to each whole wav of a list, cut to whole 160-sample frames;
    each file's draws from one torch.Generator seeded with --seed, in list
    order. Writes <out_dir>/<basename>. A wav longer than the noise or
    overlap bank (2 x --chunk_size) has no slice of it to take: refused,
    as the JAX tool's slice is."""
    import torch
    from pase_tpu_torch.data import distortions
    from pase_tpu_torch.data.io import read_wav, write_wav
    from pase_tpu_torch.train import build_distortions
    cfg, assets, _ = build_distortions(argparse.Namespace(
        dtrans_cfg=[opts.dtrans_cfg]), opts.chunk_size)
    if cfg is None:
        raise ValueError(f"--dtrans_cfg {opts.dtrans_cfg!r} names no stack")
    assets = assets.to(opts.device)
    banks = [b.shape[1] for b in (assets.noise_bank, assets.overlap_bank)
             if b is not None]
    os.makedirs(opts.out_dir, exist_ok=True)
    paths = _wav_paths(opts)
    gen = torch.Generator(device=opts.device).manual_seed(opts.seed)
    for p in paths:
        wav, sr = read_wav(os.path.join(opts.data_root, p))
        t = (len(wav) // HOP) * HOP
        if banks and t > min(banks):
            raise ValueError(
                f"{p}: {t} samples, longer than the {min(banks)}-sample "
                f"noise / overlap bank of --chunk_size {opts.chunk_size}")
        x = torch.as_tensor(wav[None, :t], device=opts.device)
        draws = distortions.draw_distortions(gen, 1, t, cfg, assets)
        with torch.no_grad():
            y, _ = distortions.apply_distortions(x, draws, cfg, assets)
        write_wav(os.path.join(opts.out_dir, os.path.basename(p)),
                  y[0].cpu().numpy(), sr)
    print(f"Contaminated {len(paths)} files -> {opts.out_dir}")
    return len(paths)


def select_ckpt(opts):
    """The file of --metrics_glob whose --metric is best (largest: JAX's
    --maximize is store_true with default True, so it cannot be turned
    off); prints {"best": path, metric: value}."""
    best, best_v = None, None
    for f in glob.glob(opts.metrics_glob):
        with open(f) as fh:
            m = json.load(fh)
        v = m.get(opts.metric)
        if v is None:
            continue
        if best_v is None or (v > best_v if opts.maximize else v < best_v):
            best, best_v = f, v
    out = {"best": best, opts.metric: best_v}
    print(json.dumps(out))
    return out


def encode_codec2(opts):
    """Pre-encode every ``*.wav`` of --input_dir through the codec2 round
    trip (``data.host_distortions.Codec2RoundTrip`` at --kbps) into
    --output_dir under the same names, in a pool of --num_workers threads:
    the tool that fills the distortion cache (the JAX tool; the reference's
    util_scripts/encode_codec2.py). Each wav is treated as 16 kHz, as
    there. Returns the number of files."""
    from concurrent.futures import ThreadPoolExecutor
    from pase_tpu_torch.data.host_distortions import Codec2RoundTrip
    from pase_tpu_torch.data.io import read_wav, write_wav
    c2 = Codec2RoundTrip(kbps=opts.kbps)
    wavs = sorted(glob.glob(os.path.join(opts.input_dir, "*.wav")))
    os.makedirs(opts.output_dir, exist_ok=True)

    def one(path):
        x, sr = read_wav(path)
        y = c2(x.astype(np.float32))
        write_wav(os.path.join(opts.output_dir, os.path.basename(path)),
                  y, sr)

    with ThreadPoolExecutor(max_workers=opts.num_workers) as pool:
        list(pool.map(one, wavs))
    print(f"encoded {len(wavs)} wavs -> {opts.output_dir}")
    return len(wavs)


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
                    help="one forward of each whole wav with its time "
                         "axis over the visible cards (parallel/sp.py)")

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

    cl = sub.add_parser("clusterize")
    cl.add_argument("--fe_cfg", required=True)
    cl.add_argument("--fe_ckpt", default=None)
    cl.add_argument("--wav_list", required=True)
    cl.add_argument("--data_root", default="")
    cl.add_argument("--k", type=int, default=128)
    cl.add_argument("--max_utts", type=int, default=None)
    cl.add_argument("--out_file", default="clusters.npz")
    device_flag(cl)

    mf = sub.add_parser("make-fbanks")
    mf.add_argument("--wav_list", required=True)
    mf.add_argument("--data_root", default="")
    mf.add_argument("--out_dir", required=True)
    mf.add_argument("--n_filters", type=int, default=40)
    device_flag(mf)

    vp = sub.add_parser("vadproc")
    vp.add_argument("--wav_list", required=True)
    vp.add_argument("--data_root", default="")
    vp.add_argument("--out_dir", required=True)
    vp.add_argument("--thresh_db", type=float, default=-40.0)

    mc = sub.add_parser("make-contaminated")
    mc.add_argument("--wav_list", required=True)
    mc.add_argument("--data_root", default="")
    mc.add_argument("--out_dir", required=True)
    mc.add_argument("--dtrans_cfg", required=True)
    mc.add_argument("--chunk_size", type=int, default=32000)
    mc.add_argument("--seed", type=int, default=0)
    device_flag(mc)

    sc = sub.add_parser("select-ckpt")
    sc.add_argument("--metrics_glob", required=True)
    sc.add_argument("--metric", default="test_sentence_acc")
    sc.add_argument("--maximize", action="store_true", default=True,
                    help="always on, as in the JAX CLI")

    pf = sub.add_parser("project-features")
    pf.add_argument("--fe_cfg", required=True)
    pf.add_argument("--fe_ckpt", default=None)
    pf.add_argument("--wav_list", required=True)
    pf.add_argument("--data_root", default="")
    pf.add_argument("--n_components", type=int, default=2)
    pf.add_argument("--max_utts", type=int, default=None)
    pf.add_argument("--out_file", default="projected.npy")
    device_flag(pf)

    c2 = sub.add_parser("encode-codec2")
    c2.add_argument("input_dir")
    c2.add_argument("output_dir")
    c2.add_argument("--kbps", type=int, default=1600)
    c2.add_argument("--num_workers", type=int, default=8)

    pe = sub.add_parser("prosodic-eval")
    pe.add_argument("--fe_cfg", required=True)
    pe.add_argument("--net_cfg", required=True)
    pe.add_argument("--ckpt", required=True,
                    help="full PASE checkpoint (weights_PASE-*.npz)")
    pe.add_argument("--wav_list", required=True)
    pe.add_argument("--data_root", default="")
    pe.add_argument("--stats", default=None)
    pe.add_argument("--max_utts", type=int, default=None)
    pe.add_argument("--out_file", default=None)
    device_flag(pe)
    return p


def main(argv=None):
    opts = build_parser().parse_args(argv)
    from pase_tpu_torch.precision import full_precision
    full_precision()        # float32 as the JAX CLI's: no TF32
    return {"forward-chunk": forward_chunk, "export": export,
            "serve-encode": serve_encode, "eval-ckpts": eval_ckpts,
            "precompute-feats": precompute_feats,
            "profile-step": profile_step,
            "export-torch": export_torch, "clusterize": clusterize,
            "make-fbanks": make_fbanks, "vadproc": vadproc,
            "make-contaminated": make_contaminated,
            "select-ckpt": select_ckpt,
            "project-features": project_features,
            "encode-codec2": encode_codec2,
            "prosodic-eval": prosodic_eval}[opts.cmd](opts)


if __name__ == "__main__":
    main()
