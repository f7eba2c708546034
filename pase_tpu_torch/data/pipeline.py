"""In-step batch preparation and the trainset statistics.

The port of ``pase_tpu/data/pipeline.py`` for one synthetic or in-memory
corpus. Per step, given raw chunks {chunk, chunk_ctxt, chunk_rand} on the
device:
  1. optional norm_and_scale (random gain per sample);
  2. cchunk := the clean chunk (the denoising target);
  3. worker feature targets from the clean chunk;
  4. ZNorm of the targets with a stats dict ({key: {'mean', 'std'}}),
     then, under a compute dtype (``precision.py``), the targets stored
     in it (the losses cast them back to float32 at the criterion);
  5. the distortion stack (``data/distortions.py``) on 'chunk' only, and
     the frame-level 'overlap' label when the workers have an overlap
     worker.
Targets come from clean audio; the encoder sees the distorted chunk.

The int16 wire format, per-corpus distortion masks (``dist_mask``), the
zero-speech rows (``zs_mask``) and explicit clean chunks (``cchunk``)
belong to disk-fed training and raise.
"""

import pickle

import numpy as np
import torch

from pase_tpu_torch.data.distortions import (apply_distortions,
                                             draw_distortions)
from pase_tpu_torch.ops.features import feature_fn_for_worker
from pase_tpu_torch.precision import get_compute_dtype

ROADMAP_DISK = "ROADMAP.md, queue 1: disk-fed training"
_DISK_KEYS = ("dist_mask", "zs_mask", "cchunk")


def norm_and_scale(wav, generator=None):
    """wav / max|wav| * U[0, 1) per sample."""
    mx = wav.abs().amax(dim=-1, keepdim=True)
    g = torch.rand((wav.shape[0], 1), generator=generator, dtype=wav.dtype,
                   device=wav.device)
    return wav / torch.clamp(mx, min=1e-12) * g


def make_prepare_fn(workers_meta, stats=None, dist_cfg=None, assets=None,
                    hop=160, random_scale=False):
    """Build prepare(batch, generator=None, draws=None) -> model-ready
    batch dict.

    workers_meta: ``model.parse_workers_cfg`` output. stats: {key:
    {'mean', 'std'}} with 1-D per-dim arrays. dist_cfg / assets: a
    ``DistortionConfig`` and its ``DistortionAssets`` (both, or the stack
    is off). ``generator`` draws the random gains of ``random_scale`` and
    the distortions; ``draws`` (a ``DistortionDraws``) replaces the
    latter."""
    feat_fns = {}
    for e in workers_meta.get("regr", []):
        fn = feature_fn_for_worker(e["name"], e.get("transform"), hop=hop)
        if fn is not None:
            feat_fns[e["name"]] = fn
    has_overlap = any(e["name"] == "overlap"
                      for e in workers_meta.get("cls", []))
    distort = dist_cfg is not None and assets is not None
    stats = stats or {}
    on_device = {}

    def cached(key, make):
        if key not in on_device:
            on_device[key] = make()
        return on_device[key]

    def znorm(name, feats):
        if name not in stats:
            return feats
        mean, std = cached((name, feats.device), lambda: tuple(
            torch.as_tensor(np.asarray(stats[name][k], np.float32),
                            device=feats.device) for k in ("mean", "std")))
        return (feats - mean) / std

    def prepare(batch, generator=None, draws=None):
        for k, v in batch.items():
            if k in _DISK_KEYS or v.dtype == torch.int16:
                raise NotImplementedError(
                    f"batch entry {k!r} ({v.dtype}) belongs to disk-fed "
                    f"training, not ported yet: {ROADMAP_DISK}")
        chunk, ctxt, rand = (batch["chunk"], batch["chunk_ctxt"],
                             batch["chunk_rand"])
        b, t = chunk.shape
        if random_scale:
            chunk = norm_and_scale(chunk, generator)
            ctxt = norm_and_scale(ctxt, generator)
            rand = norm_and_scale(rand, generator)
        out = {"chunk_ctxt": ctxt, "chunk_rand": rand, "cchunk": chunk}
        cd = get_compute_dtype()
        with torch.no_grad():
            for name, fn in feat_fns.items():
                feats = znorm(name, fn(chunk))
                out[name] = feats if cd is None else feats.to(cd)
            overlap = chunk.new_zeros((b, t // hop))
            if distort:
                dev_assets = cached(("assets", chunk.device),
                                    lambda: assets.to(chunk.device))
                if draws is None:
                    draws = draw_distortions(generator, b, t, dist_cfg,
                                             dev_assets)
                chunk, overlap = apply_distortions(chunk, draws, dist_cfg,
                                                   dev_assets, dec_res=hop)
        out["chunk"] = chunk
        if has_overlap:
            out["overlap"] = batch.get("overlap", overlap)
        return out

    return prepare


# ---------------------------------------------------------------------------
# trainset statistics (make_trainset_statistics.py semantics)
# ---------------------------------------------------------------------------


def compute_stats(batcher, workers_meta, hop=160, max_batches=20,
                  device="cuda"):
    """ZNorm statistics of the worker targets over up to max_batches
    batches of ``batcher`` (numpy or torch {chunk, chunk_ctxt,
    chunk_rand}), prepared on ``device`` without distortions:
      mean[d] = mean over samples of the per-sample temporal mean,
      std[d]  = std over samples (unbiased) of the per-sample temporal
                std (unbiased).
    Schema: {key: {'mean': [D], 'std': [D]}} of float32 numpy arrays."""
    prepare = make_prepare_fn(workers_meta, hop=hop)
    per_sample = {}
    for bi, batch in enumerate(batcher):
        if bi >= max_batches:
            break
        dev = prepare({k: torch.as_tensor(v, dtype=torch.float32,
                                          device=device)
                       for k, v in batch.items()})
        for k, v in dev.items():
            if v.dim() != 3:
                continue
            ms, ss = per_sample.setdefault(k, ([], []))
            ms.append(v.mean(dim=1).cpu().numpy())           # [B, D]
            ss.append(v.std(dim=1, unbiased=True).cpu().numpy())
    return {k: {"mean": np.concatenate(ms).mean(axis=0),
                "std": np.concatenate(ss).std(axis=0, ddof=1)}
            for k, (ms, ss) in per_sample.items()}


def save_stats_pkl(stats, path):
    """Write stats as a pickle of {key: {'mean', 'std'}} numpy arrays, the
    layout ``load_stats_pkl`` and the JAX package read."""
    with open(path, "wb") as f:
        pickle.dump({k: {"mean": np.asarray(v["mean"]),
                         "std": np.asarray(v["std"])}
                     for k, v in stats.items()}, f)


def load_stats_pkl(path):
    """Load a stats pkl (numpy arrays, or the reference's torch tensors)
    as {key: {'mean': float32 [D], 'std': float32 [D]}}. Unpickles the
    file: load only stats files this project or the reference wrote."""
    try:
        with open(path, "rb") as f:
            stats = pickle.load(f)
    except (pickle.UnpicklingError, RuntimeError, AttributeError):
        with open(path, "rb") as f:
            stats = torch.load(f, map_location="cpu", weights_only=False)
    out = {}
    for k, v in stats.items():
        mean, std = v["mean"], v["std"]
        if hasattr(mean, "numpy"):
            mean, std = mean.numpy(), std.numpy()
        out[k] = {"mean": np.asarray(mean, np.float32),
                  "std": np.asarray(std, np.float32)}
    return out
