"""The N-step loss-trajectory gate of the port against the JAX step.

The protocol of ``experiments/chaos_control.py``, without the reference
checkout: the JAX train step against itself with every initial parameter
multiplied by (1 + one ulp) gives the floor of how far two correct runs
drift apart; the port is held to the unperturbed JAX run. Per worker and
for 'total', the port passes when its mean relative deviation over the
steps is at most 1 % or at most twice the floor's (the r5 criterion of
``benchmarks/trajectory_parity_full_r5.json``); the largest deviation is
reported beside it.

The run is ``tests/test_training_regression.py``'s: the narrow encoder,
mfcc, prosody, a fused lps head (r=7) and mi, the distortion stack
(reverb .5, overlap .3, noise .5, clip .3, chop .3) on its synthetic
assets, batch 8 x 4800, 40 steps, poly lr. Both sides start from the
port's seeded init (the JAX side through the weight bridge) and train on
the numpy ``SyntheticChunkBatcher`` (seed 0); the port takes the JAX
step's own distortion draws, recorded per step. The JAX runs (float32,
float32 + (1 + 2^-23), bf16, bf16 + (1 + 2^-8): an f32 ulp vanishes in
the policy's casts) live in ``tests/fixtures/torch_port_trajectory.json``,
written by ``tests/torch_port_make_trajectory.py``; this module needs no
JAX.
"""

import json

import numpy as np
import torch

from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
from pase_tpu_torch.data.distortions import (DistortionAssets,
                                             DistortionConfig,
                                             DistortionDraws)
from pase_tpu_torch.trainer import Trainer

FRONTEND = {
    "kwidths": [65, 10, 5, 5], "strides": [1, 10, 4, 4],
    "fmaps": [32, 32, 64, 64], "emb_dim": 64, "norm_out": True,
    "rnn_pool": True, "rnn_layers": 1, "denseskips": True,
}
WORKERS = {
    "regr": [
        {"num_outputs": 39, "dropout": 0, "hidden_size": 64,
         "hidden_layers": 1, "name": "mfcc", "r": 1,
         "loss": "MSELoss", "skip": False},
        {"num_outputs": 12, "dropout": 0, "hidden_size": 64,
         "hidden_layers": 1, "name": "prosody", "r": 1,
         "loss": "MSELoss", "skip": False},
        {"num_outputs": 3075, "dropout": 0, "hidden_size": 64,
         "hidden_layers": 1, "name": "lps", "r": 7, "context": 1,
         "loss": "MSELoss", "skip": False},
    ],
    "cls": [
        {"num_outputs": 1, "dropout": 0, "hidden_size": 64,
         "hidden_layers": 1, "name": "mi", "loss": "BCEWithLogitsLoss",
         "skip": False},
    ],
}
DIST = dict(reverb_p=0.5, overlap_p=0.3, noises_p=0.5, clip_p=0.3,
            chop_p=0.3)
BATCH, CHUNK, STEPS = 8, 4800, 40
MODEL_SEED, BATCH_SEED, RNG_SEED = 0, 0, 0
# one ulp at 1.0 of each precision: float32, and bf16 (8 significand bits)
PERTURB = {"f32": 2.0 ** -23, "bf16": 2.0 ** -8}
COMPUTE = {"f32": None, "bf16": "bfloat16"}
MEAN_REL, FLOOR_X = 0.01, 2.0


def train_cfg(precision="f32", save_path="traj_ckpt"):
    return dict(backprop_mode="base", hop=160, bpe=100, epoch=10,
                batch_size=BATCH, chunk_size=CHUNK, log_freq=1000,
                fe_lr=5e-4, min_lr=5e-4, lr_mode="poly", seed=MODEL_SEED,
                compute_dtype=COMPUTE[precision], save_path=save_path)


def synth_assets(t=CHUNK):
    """The synthetic asset banks of ``_synth_assets`` in
    tests/test_training_regression.py: two IRs of 1000 taps (a direct
    path, one echo each), 3 noise and 2 overlap rows of 2t samples from
    numpy.random.RandomState(0)."""
    rng = np.random.RandomState(0)
    ir = np.zeros((2, 1000), dtype=np.float32)
    ir[:, 0] = 1.0
    ir[0, 300] = 0.4
    ir[1, 700] = 0.2
    return DistortionAssets(
        ir_bank=torch.from_numpy(ir),
        ir_pmax=torch.zeros(2, dtype=torch.int32),
        noise_bank=torch.from_numpy(rng.randn(3, t * 2).astype(np.float32)
                                    * 0.1),
        overlap_bank=torch.from_numpy(rng.randn(2, t * 2).astype(np.float32)
                                      * 0.1))


def batches(steps=STEPS):
    it = iter(SyntheticChunkBatcher(BATCH, CHUNK, seed=BATCH_SEED))
    return [next(it) for _ in range(steps)]


def make_trainer(precision="f32", device="cuda", save_path="traj_ckpt",
                 **cfg):
    """The port's trainer of the gate, its weights from MODEL_SEED; ``cfg``
    overrides entries of ``train_cfg``."""
    return Trainer(FRONTEND, WORKERS,
                   {**train_cfg(precision, save_path), **cfg},
                   dist_cfg=DistortionConfig(**DIST),
                   dist_assets=synth_assets(), device=device)


def load_fixture(path):
    with open(path) as f:
        return json.load(f)


def draws_of(record):
    """A fixture step's draws (field -> nested list) as DistortionDraws:
    float lists as float32, integer lists as int64."""
    out = {}
    for k, v in record.items():
        a = np.asarray(v)
        out[k] = torch.from_numpy(a.astype(np.float32 if a.dtype.kind == "f"
                                           else np.int64))
    return DistortionDraws(**out)


def run_port(fixture, precision, device="cuda", steps=STEPS,
             save_path="traj_ckpt"):
    """The port's per-step losses ({worker: float}, 'total') over the
    fixture's batches and draws."""
    tr = make_trainer(precision, device, save_path)
    traj = []
    for raw, rec in zip(batches(steps), fixture["draws"][:steps]):
        losses = tr.train_step(raw, draws=draws_of(rec))
        traj.append({k: float(v) for k, v in losses.items()})
    tr.logger.close()
    return traj


def mean_max_rel(ref, other):
    """{name: (mean, max) over steps of |other - ref| / |ref|}."""
    out = {}
    for n in ref[0]:
        rel = np.array([abs(b[n] - a[n]) / max(abs(a[n]), 1e-9)
                        for a, b in zip(ref, other)])
        out[n] = (float(rel.mean()), float(rel.max()))
    return out


def verdict(fixture, precision, port_traj):
    """The gate of one precision over len(port_traj) steps: per worker and
    'total' the port's mean and max relative deviation from the JAX run,
    the one-ulp floor's, and ok (mean <= 1 % or <= 2x the floor's mean)."""
    n = len(port_traj)
    ref = fixture["runs"][precision][:n]
    floor = mean_max_rel(ref, fixture["runs"][precision + "_ulp"][:n])
    ours = mean_max_rel(ref, port_traj)
    rows = {}
    for name, (mean, mx) in ours.items():
        fmean, fmax = floor[name]
        rows[name] = {"mean_rel": mean, "max_rel": mx,
                      "floor_mean_rel": fmean, "floor_max_rel": fmax,
                      "ok": mean <= MEAN_REL
                      or mean <= FLOOR_X * max(fmean, 1e-9)}
    return rows, all(r["ok"] for r in rows.values())


def format_rows(rows):
    return "; ".join(
        f"{k} {r['mean_rel']:.2e} (max {r['max_rel']:.2e}; floor "
        f"{r['floor_mean_rel']:.2e}, max {r['floor_max_rel']:.2e})"
        f"{'' if r['ok'] else ' FAIL'}" for k, r in rows.items())
