"""In-step batch preparation, without distortions.

The port of ``pase_tpu/data/pipeline.py`` ``make_prepare_fn`` for a run
with no distortion config. Per step, given raw chunks {chunk, chunk_ctxt,
chunk_rand} on the device:
  1. optional norm_and_scale (random gain per sample);
  2. cchunk := the clean chunk (the denoising target);
  3. worker feature targets from the clean chunk;
  4. ZNorm of the targets with a stats dict ({key: {'mean', 'std'}}).
The encoder sees the chunk as it came: distortions are later work
(ROADMAP.md, queue 1: batch prepare, the distortion stack).
"""

import pickle

import numpy as np
import torch

from pase_tpu_torch.ops.features import feature_fn_for_worker

ROADMAP_DISTORTIONS = ("ROADMAP.md, queue 1: batch prepare (the distortion "
                       "stack)")


def norm_and_scale(wav, generator=None):
    """wav / max|wav| * U[0, 1) per sample."""
    mx = wav.abs().amax(dim=-1, keepdim=True)
    g = torch.rand((wav.shape[0], 1), generator=generator, dtype=wav.dtype,
                   device=wav.device)
    return wav / torch.clamp(mx, min=1e-12) * g


def make_prepare_fn(workers_meta, stats=None, dist_cfg=None, hop=160,
                    random_scale=False):
    """Build prepare(batch, generator=None) -> model-ready batch dict.

    workers_meta: ``model.parse_workers_cfg`` output. stats: {key:
    {'mean', 'std'}} with 1-D per-dim arrays. ``generator`` draws the
    random gains of ``random_scale``."""
    if dist_cfg is not None:
        raise NotImplementedError(
            f"distortions are not ported yet: {ROADMAP_DISTORTIONS}")
    feat_fns = {}
    for e in workers_meta.get("regr", []):
        fn = feature_fn_for_worker(e["name"], e.get("transform"), hop=hop)
        if fn is not None:
            feat_fns[e["name"]] = fn
    if any(e["name"] == "overlap" for e in workers_meta.get("cls", [])):
        raise NotImplementedError(
            f"the overlap worker needs the distortion stack: "
            f"{ROADMAP_DISTORTIONS}")
    stats = stats or {}
    stats_dev = {}

    def znorm(name, feats):
        if name not in stats:
            return feats
        key = (name, feats.device)
        if key not in stats_dev:
            stats_dev[key] = tuple(
                torch.as_tensor(np.asarray(stats[name][k], np.float32),
                                device=feats.device) for k in ("mean", "std"))
        mean, std = stats_dev[key]
        return (feats - mean) / std

    def prepare(batch, generator=None):
        chunk, ctxt, rand = (batch["chunk"], batch["chunk_ctxt"],
                             batch["chunk_rand"])
        if random_scale:
            chunk = norm_and_scale(chunk, generator)
            ctxt = norm_and_scale(ctxt, generator)
            rand = norm_and_scale(rand, generator)
        out = {"chunk": chunk, "chunk_ctxt": ctxt, "chunk_rand": rand,
               "cchunk": chunk}
        with torch.no_grad():
            for name, fn in feat_fns.items():
                out[name] = znorm(name, fn(chunk))
        return out

    return prepare


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
