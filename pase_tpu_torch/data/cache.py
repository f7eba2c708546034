"""Precomputed worker-target feature cache.

``precompute_features`` computes each regression worker's features over
whole utterances once, one ``<basename>.feats.npz`` per utterance (each
worker's [T_frames, D] float32 features and '_hop'); the layout is the
JAX package's (``pase_tpu/data/cache.py``), so either package reads the
other's cache. ``CachedTargetBatcher`` then emits the cached slices at
each chunk's offset under the worker names, and ``make_prepare_fn``
passes them through (ZNorm and the compute dtype still apply) instead of
computing the targets in the step.

Cached features are computed over the full utterance and sliced at
``beg // hop``, so the framing context at a chunk's edges differs slightly
from the in-step path, which frames the isolated chunk. An utterance
shorter than the chunk is padded as ``crop_at`` pads audio, at frame
level. Not supported with ``random_scale`` (the features were computed at
the original gain) or ``zero_speech_p > 0`` (synthetic samples have no
cache file).
"""

import os

import numpy as np
import torch

from pase_tpu_torch.data.dataset import ChunkBatcher, crop_at, crop_chunk
from pase_tpu_torch.data.io import read_wav

CACHE_EXT = ".feats.npz"


def _cache_path(cache_dir, fname):
    bname = os.path.splitext(os.path.basename(fname))[0]
    return os.path.join(cache_dir, bname + CACHE_EXT)


def precompute_features(data_root, filenames, workers_meta, out_dir, hop=160,
                        bucket=16000, overwrite=False, device="cuda"):
    """One .feats.npz per utterance under ``out_dir`` with each regression
    worker's [T_frames, D] float32 features of the whole wav, computed on
    ``device``. Each wav is zero-padded up to a multiple of ``bucket``
    samples (the JAX producer's shapes), then the frame axis is cut back to
    len // hop. Existing files are kept unless ``overwrite``. Returns the
    number of files written."""
    from pase_tpu_torch.ops.features import feature_fn_for_worker
    feat_fns = {}
    for e in workers_meta.get("regr", []):
        fn = feature_fn_for_worker(e["name"], e.get("transform"), hop=hop)
        if fn is not None:
            feat_fns[e["name"]] = fn
    if not feat_fns:
        raise ValueError("no feature-target workers in the cfg")
    os.makedirs(out_dir, exist_ok=True)
    n_done = 0
    for fname in filenames:
        out_path = _cache_path(out_dir, fname)
        if os.path.exists(out_path) and not overwrite:
            continue
        wav, _ = read_wav(os.path.join(data_root, fname))
        n = len(wav)
        n_frames = n // hop
        padded = -(-max(n, hop) // bucket) * bucket
        x = torch.zeros((1, padded), dtype=torch.float32, device=device)
        x[0, :n] = torch.from_numpy(wav)
        arrs = {}
        with torch.no_grad():
            for name, fn in feat_fns.items():
                arrs[name] = fn(x)[0, :n_frames].float().cpu().numpy()
        arrs["_hop"] = np.int64(hop)
        np.savez(out_path, **arrs)
        n_done += 1
    return n_done


class CachedTargetBatcher(ChunkBatcher):
    """A ChunkBatcher that also loads the cached features of each sampled
    utterance and slices them at the chunk's offset, emitted under the
    worker names. Plain tuple datasets only (no parallel clean tree, no
    MetaConcat, no zero-speech); the batches are the JAX class's bit for
    bit."""

    def __init__(self, dataset, batch_size, chunk_size, cache_dir,
                 worker_names, hop=160, seed=0, prefetch=4,
                 max_cached_utts=256):
        super().__init__(dataset, batch_size, chunk_size, seed=seed,
                         prefetch=prefetch)
        if getattr(dataset, "zero_speech_p", 0.0):
            raise ValueError("cached targets are incompatible with "
                             "zero_speech_p (no cache for synthetic "
                             "samples)")
        if getattr(dataset, "parallel", False) or \
                getattr(dataset, "datasets", None) is not None:
            raise ValueError("cached targets support plain tuple "
                             "datasets only (not parallel-clean or "
                             "MetaConcat)")
        self.cache_dir = cache_dir
        self.worker_names = list(worker_names)
        self.hop = hop
        self._feat_cache = {}
        self._max_cached = max_cached_utts

    def _feats_of(self, fname):
        hit = self._feat_cache.get(fname)
        if hit is not None:
            return hit
        path = _cache_path(self.cache_dir, fname)
        with np.load(path) as z:
            feats = {n: z[n] for n in self.worker_names}
            hop = int(z["_hop"]) if "_hop" in z else self.hop
        if hop != self.hop:
            raise ValueError(f"{path}: cached hop {hop} != {self.hop}")
        if len(self._feat_cache) >= self._max_cached:
            self._feat_cache.pop(next(iter(self._feat_cache)))
        self._feat_cache[fname] = feats
        return feats

    @staticmethod
    def _slice_frames(f, f0, nf):
        """[T, D] -> [nf, D] from frame f0; short utterances padded as
        ``crop_at`` pads audio (reflect tail when the pad is shorter than
        the piece, else tile), at frame level."""
        piece = f[f0:f0 + nf]
        if len(piece) < nf:
            if len(piece) == 0:
                piece = np.zeros((1, f.shape[1]), f.dtype)
            p = nf - len(piece)
            if p < len(piece):
                pad = piece[-2:-2 - p:-1]
            else:
                reps = int(np.ceil(nf / len(piece)))
                return np.tile(piece, (reps, 1))[:nf]
            piece = np.concatenate([piece, pad])
        return piece

    def _make_batch(self):
        b, t = self.batch_size, self.chunk_size
        nf = t // self.hop
        chunk = np.empty((b, t), dtype=np.float32)
        ctxt = np.empty((b, t), dtype=np.float32)
        rand = np.empty((b, t), dtype=np.float32)
        feats = {n: None for n in self.worker_names}
        for i in range(b):
            idx = self.rng.randint(len(self.ds))
            uttname = self.ds.wavs[idx]["filename"]
            wav, cwav, rwav = self.ds.sample_tuple(idx, self.rng)
            beg = (self.rng.randint(0, len(wav) - t)
                   if len(wav) > t else 0)
            chunk[i] = (wav[beg:beg + t] if len(wav) > t
                        else crop_at(wav, 0, t))
            ctxt[i] = crop_chunk(cwav, t, self.rng)
            rand[i] = crop_chunk(rwav, t, self.rng)
            utt_feats = self._feats_of(uttname)
            for n in self.worker_names:
                sl = self._slice_frames(utt_feats[n], beg // self.hop, nf)
                if feats[n] is None:
                    feats[n] = np.empty((b,) + sl.shape, np.float32)
                feats[n][i] = sl
        out = {"chunk": chunk, "chunk_ctxt": ctxt, "chunk_rand": rand}
        out.update({n: v for n, v in feats.items() if v is not None})
        return out

