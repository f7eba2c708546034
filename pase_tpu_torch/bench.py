"""PASE+ pretraining throughput of the port: ``bench.py``'s step, on the card.

    python -m pase_tpu_torch.bench [--compute_dtype bfloat16|float32]

The port of ``bench.py``'s measurement: the full multi-task train step
(PASE+ encoder, the whole workers+ bank, in-step targets with ZNorm
statistics from 2 synthetic batches of 8, the distortion stack of
``bench.py`` on its synthetic assets, base policy, poly lr, Adam) at batch
32 x 32000 under the bf16 compute policy, as ``bench.py`` runs it. 3
warm-up steps, then 3 trials of 20 steps, each synchronized: the median
rate, and a warning on stderr when the trials spread by more than 8 %.

Prints ONE JSON line, {"metric", "value", "unit", "vs_baseline"}: value in
steps/s, the unit naming the card as ``nvidia-smi --query-gpu=name,
power.limit`` gives it, and the audio-seconds per second. ``vs_baseline``
is null: ``bench.py``'s baseline is the reference PyTorch implementation
timed from a reference checkout that this repository does not ship (where
it is missing ``bench.py`` prints 0.0); stderr says so.

Runs on the card unless ``--device cpu``; a test shrinks the run through
the module's constants (configs, batch, trial counts), which ``build``,
``measure`` and ``trials`` read when called. ``chip_smoke.py`` phase 8
drives them, so the protocol lives here.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pase_tpu_torch.precision import full_precision

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FE_CFG = os.path.join(ROOT, "cfg", "frontend", "PASE+.cfg")
NET_CFG = os.path.join(ROOT, "cfg", "workers", "workers+.cfg")
B, T, SR = 32, 32000, 16000
N_WARM, N_MEAS, N_TRIALS = 3, 20, 3
# trial spread (max/min - 1) above which another process was likely
# competing for the card or the host
CONTENTION_SPREAD = 0.08
NO_BASELINE = ("vs_baseline is null: bench.py's baseline is the reference "
               "PyTorch implementation run from a reference checkout, which "
               "this repository does not ship")


def bench_assets(t):
    """bench.py's synthetic assets and distortion config: 4 IRs of 8000
    taps (a direct path, two with one echo), 8 noise rows and 4 overlap
    rows of 2t samples from numpy.random.RandomState(0); reverb .5,
    overlap .1, noise .4, clip .2, chop .2."""
    from pase_tpu_torch.data.distortions import (DistortionAssets,
                                                 DistortionConfig)
    rng = np.random.RandomState(0)
    ir = np.zeros((4, 8000), np.float32)
    ir[:, 0] = 1.0
    ir[0, 1000] = 0.4
    ir[1, 2000] = 0.2
    assets = DistortionAssets(
        ir_bank=torch.from_numpy(ir),
        ir_pmax=torch.zeros(4, dtype=torch.int32),
        noise_bank=torch.from_numpy(rng.randn(8, 2 * t).astype(np.float32)
                                    * 0.1),
        overlap_bank=torch.from_numpy(rng.randn(4, 2 * t).astype(np.float32)
                                      * 0.1))
    cfg = DistortionConfig(reverb_p=0.5, overlap_p=0.1, noises_p=0.4,
                           clip_p=0.2, chop_p=0.2, bandrop_p=0.0,
                           downsample_p=0.0)
    return cfg, assets


def device_label(device):
    """'<name>, <power limit>' of the card from nvidia-smi, or 'cpu'."""
    if torch.device(device).type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build(device="cuda", compute_dtype="bfloat16", save_path=None):
    """(trainer, 4 raw batches on the device, the ZNorm statistics, the
    seconds they took) of bench.py's step."""
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    from pase_tpu_torch.data.pipeline import compute_stats
    from pase_tpu_torch.model import parse_workers_cfg
    from pase_tpu_torch.trainer import Trainer
    dcfg, assets = bench_assets(T)
    t0 = time.perf_counter()
    stats = compute_stats(SyntheticChunkBatcher(8, T, seed=11),
                          parse_workers_cfg(NET_CFG), max_batches=2,
                          device=device)
    stats_s = time.perf_counter() - t0
    cfg = dict(backprop_mode="base", hop=160, bpe=100, epoch=400,
               batch_size=B, chunk_size=T, log_freq=100,
               fe_lr=1e-3, min_lr=5e-4, lr_mode="poly",
               compute_dtype=compute_dtype,
               save_path=save_path or tempfile.mkdtemp(prefix="pase_bench_"))
    tr = Trainer(FE_CFG, NET_CFG, cfg, stats=stats, dist_cfg=dcfg,
                 dist_assets=assets, device=device)
    it = iter(SyntheticChunkBatcher(B, T, seed=0))
    raws = [tr.ready(next(it)) for _ in range(4)]
    return tr, raws, stats, stats_s


def trials(tr, raws, losses=None):
    """N_TRIALS trials of N_MEAS train steps, synchronized at both ends;
    the rates in steps/s, sorted. Each step's losses go to ``losses``."""
    rates = []
    for _ in range(N_TRIALS):
        t0 = time.perf_counter()
        for i in range(N_MEAS):
            out = tr.train_step(raws[i % len(raws)])
            if losses is not None:
                losses.append(out)
        _sync(tr.device)
        rates.append(N_MEAS / (time.perf_counter() - t0))
    return sorted(rates)


def measure(tr, raws, losses=None):
    """bench.py's protocol: N_WARM warm-up steps, then ``trials``."""
    for i in range(N_WARM):
        out = tr.train_step(raws[i % len(raws)])
        if losses is not None:
            losses.append(out)
    _sync(tr.device)
    return trials(tr, raws, losses)


def result_line(rates, label, compute_dtype):
    """bench.py's JSON line for the sorted trial rates."""
    value = rates[len(rates) // 2]
    audio = value * B * T / SR
    return {"metric": f"PASE+ self-sup train steps/sec (batch {B}, "
                      f"{T / SR:g}s chunks, full workers+ bank, "
                      f"on-device distortions+targets, {compute_dtype})",
            "value": round(value, 4),
            "unit": f"steps/sec (1 x {label}); audio-sec/sec="
                    f"{round(audio, 1)}",
            "vs_baseline": None}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m pase_tpu_torch.bench")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device "
                           "(torch.cuda.is_available() is False)")
    # no TF32: float32 means float32, bf16 is chosen by --compute_dtype
    full_precision()
    tr, raws, _, _ = build(args.device, args.compute_dtype)
    rates = measure(tr, raws)
    tr.logger.close()
    spread = rates[-1] / rates[0] - 1.0
    if spread > CONTENTION_SPREAD:
        print(f"WARNING: trial spread {spread:.1%} (rates "
              f"{[round(r, 2) for r in rates]} steps/s): another process "
              "is likely competing for the card or the host; re-run idle.",
              file=sys.stderr)
    print(NO_BASELINE, file=sys.stderr)
    line = result_line(rates, device_label(args.device), args.compute_dtype)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
