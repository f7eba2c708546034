"""In-step batch preparation and the trainset statistics.

The port of ``pase_tpu/data/pipeline.py``. Per step, given raw chunks
{chunk, chunk_ctxt, chunk_rand} on the device (float32, or int16 PCM
from the int16 wire, divided by 32768 here):
  1. optional norm_and_scale (random gain per sample; 'chunk' and an
     aligned 'cchunk' share one gain);
  2. cchunk := the batch's aligned clean chunk (a parallel clean/noisy
     corpus) or else the clean chunk itself (the denoising target);
  3. worker feature targets from cchunk, or passed through where the
     batch already holds them (the precomputed-feature cache,
     ``data/cache.py``);
  4. ZNorm of the targets with a stats dict ({key: {'mean', 'std'}}),
     then, under a compute dtype (``precision.py``), the targets stored
     in it (the losses cast them back to float32 at the criterion);
  5. the distortion stack (``data/distortions.py``) on 'chunk' only, and
     the frame-level 'overlap' label when the workers have an overlap
     worker. A batch's ``dist_mask`` leaves the rows of an undistorted
     corpus as they were (label 0); its ``zs_mask`` (zero-speech rows)
     skips the stack on those rows and, with a zero-speech noise bank,
     adds bank noise at a random SNR to them instead.
Targets come from clean audio; the encoder sees the distorted chunk.
Injected SPC / Gap frame indices (``INDEX_KEYS``, parity harnesses) pass
through unchanged.
"""

import pickle
from typing import NamedTuple

import numpy as np
import torch

from pase_tpu_torch.data.distortions import (additive, apply_distortions,
                                             draw_distortions)
from pase_tpu_torch.ops.features import feature_fn_for_worker
from pase_tpu_torch.parallel.mesh import draw_rows
from pase_tpu_torch.precision import get_compute_dtype

# integer batch entries that pass through the prepare to the model
INDEX_KEYS = ("spc_idx", "gap_idx")


class ZeroSpeechDraws(NamedTuple):
    """The zero-speech additive's draws of one step, [B] each: the bank
    row, the start in it, the index into the SNRs."""
    row: torch.Tensor
    beg: torch.Tensor
    snr: torch.Tensor

    def to(self, device):
        return ZeroSpeechDraws(*(a.to(device) for a in self))


def draw_zero_speech(generator, b, t, bank, snrs):
    """The zero-speech draws for a [b, t] batch, on the generator's
    device."""
    dev = generator.device if generator is not None else bank.device

    def randint(high):
        return torch.randint(0, high, (b,), generator=generator, device=dev)

    return ZeroSpeechDraws(randint(bank.shape[0]),
                           randint(max(bank.shape[1] - t, 1)),
                           randint(len(snrs)))


def norm_and_scale(wav, generator=None):
    """wav / max|wav| * U[0, 1) per sample."""
    mx = wav.abs().amax(dim=-1, keepdim=True)
    return wav / torch.clamp(mx, min=1e-12) * _gains(wav, generator)


def _gains(wav, generator):
    """U[0, 1) per row of wav [B, T], [B, 1] (drawn for the global batch
    under a ``row_shard``)."""
    return draw_rows(lambda m: torch.rand(
        (m, 1), generator=generator, dtype=wav.dtype, device=wav.device),
        wav.shape[0])


def make_prepare_fn(workers_meta, stats=None, dist_cfg=None, assets=None,
                    hop=160, random_scale=False, zs_bank=None,
                    zs_snrs=(0, 5, 10)):
    """Build prepare(batch, generator=None, draws=None, zs_draws=None) ->
    model-ready batch dict.

    workers_meta: ``model.parse_workers_cfg`` output. stats: {key:
    {'mean', 'std'}} with 1-D per-dim arrays. dist_cfg / assets: a
    ``DistortionConfig`` and its ``DistortionAssets`` (both, or the stack
    is off). zs_bank / zs_snrs: the zero-speech additive, a [n, L] noise
    bank and its SNRs in dB, applied to the encoder input of the rows the
    batch's zs_mask flags (their targets and cchunk stay the silence).
    ``generator`` draws, in this order, the random gains of
    ``random_scale``, the distortions and the zero-speech additive (each
    for the global batch under a ``parallel.mesh.row_shard``, of which
    the rank keeps its rows); ``draws`` (a ``DistortionDraws``) and
    ``zs_draws`` (a ``ZeroSpeechDraws``) replace the latter two."""
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

    def prepare(batch, generator=None, draws=None, zs_draws=None):
        # the int16 wire's PCM16 grid: x / 32768 is read_wav's value
        batch = {k: (v.float() / 32768.0 if v.dtype == torch.int16 else v)
                 for k, v in batch.items()}
        chunk, ctxt, rand = (batch["chunk"], batch["chunk_ctxt"],
                             batch["chunk_rand"])
        clean = batch.get("cchunk")
        b, t = chunk.shape
        if random_scale:
            if clean is not None:
                # one gain for the noisy chunk and its aligned clean one
                mx = torch.clamp(chunk.abs().amax(dim=-1, keepdim=True),
                                 min=1e-12)
                g = _gains(chunk, generator)
                chunk, clean = chunk / mx * g, clean / mx * g
            else:
                chunk = norm_and_scale(chunk, generator)
            ctxt = norm_and_scale(ctxt, generator)
            rand = norm_and_scale(rand, generator)
        if clean is None:
            clean = chunk
        out = {"chunk_ctxt": ctxt, "chunk_rand": rand, "cchunk": clean}
        cd = get_compute_dtype()
        zs_m = batch.get("zs_mask")
        with torch.no_grad():
            for name, fn in feat_fns.items():
                feats = znorm(name, batch[name] if name in batch
                              else fn(clean))
                out[name] = feats if cd is None else feats.to(cd)
            overlap = chunk.new_zeros((b, t // hop))
            if distort:
                dev_assets = cached(("assets", chunk.device),
                                    lambda: assets.to(chunk.device))
                if draws is None:
                    draws = draw_rows(lambda m: draw_distortions(
                        generator, m, t, dist_cfg, dev_assets), b)
                dchunk, overlap = apply_distortions(chunk, draws, dist_cfg,
                                                    dev_assets, dec_res=hop)
                if "dist_mask" in batch:
                    m = batch["dist_mask"][:, None]
                    dchunk = torch.where(m > 0, dchunk, chunk)
                    overlap = overlap * m
                if zs_m is not None:
                    dchunk = torch.where(zs_m[:, None] > 0, chunk, dchunk)
                    overlap = overlap * (1.0 - zs_m[:, None])
                chunk = dchunk
            if zs_bank is not None and zs_m is not None:
                bank = cached(("zs_bank", chunk.device),
                              lambda: torch.as_tensor(
                                  zs_bank, dtype=torch.float32).to(
                                      chunk.device))
                if zs_draws is None:
                    zs_draws = draw_rows(lambda m: draw_zero_speech(
                        generator, m, t, bank, zs_snrs), b)
                noisy = additive(chunk, zs_draws.row, zs_draws.beg,
                                 zs_draws.snr, bank, tuple(zs_snrs))
                chunk = torch.where(zs_m[:, None] > 0, noisy, chunk)
        out["chunk"] = chunk
        if has_overlap:
            out["overlap"] = batch.get("overlap", overlap)
        for k in INDEX_KEYS:
            # injected SPC / Gap frame indices ride through to the model
            if k in batch:
                out[k] = batch[k]
        return out

    return prepare


# ---------------------------------------------------------------------------
# trainset statistics (make_trainset_statistics.py semantics)
# ---------------------------------------------------------------------------


def compute_stats(batcher, workers_meta, hop=160, max_batches=20,
                  device="cuda", random_scale=False, seed=0):
    """ZNorm statistics of the worker targets over up to max_batches
    batches of ``batcher`` (numpy or torch {chunk, chunk_ctxt,
    chunk_rand}), prepared on ``device`` without distortions (with
    ``random_scale``, random gains from a generator seeded with ``seed``):
      mean[d] = mean over samples of the per-sample temporal mean,
      std[d]  = std over samples (unbiased) of the per-sample temporal
                std (unbiased).
    Schema: {key: {'mean': [D], 'std': [D]}} of float32 numpy arrays."""
    prepare = make_prepare_fn(workers_meta, hop=hop,
                              random_scale=random_scale)
    generator = torch.Generator(device=device).manual_seed(seed)
    per_sample = {}
    it = iter(batcher)
    try:
        for _ in range(max_batches):
            batch = next(it, None)
            if batch is None:
                break
            dev = prepare({k: torch.as_tensor(v, dtype=torch.float32,
                                              device=device)
                           for k, v in batch.items()}, generator)
            for k, v in dev.items():
                if v.dim() != 3:
                    continue
                ms, ss = per_sample.setdefault(k, ([], []))
                ms.append(v.mean(dim=1).cpu().numpy())           # [B, D]
                ss.append(v.std(dim=1, unbiased=True).cpu().numpy())
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
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
