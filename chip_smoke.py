#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pase_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero:
  1. device  — a CUDA device (else exit 1), its nvidia-smi name and power
               limit, TF32 off for matmuls and cuDNN.
  2. build   — the QRNN kernel (pase_tpu_torch/csrc/qrnn_pool.cu), nvcc for
               sm_90a, from the sources of this checkout.
  3. kernel  — the kernel against its plain PyTorch version on the card at
               the main path's QRNN shapes: max|dh|, max|dc_T| <= 1e-5, a
               c0-seeded case, block-streamed == full bit for bit, and the
               median time of each.
  4. encoder — PASE+ at full width (cfg/frontend/PASE+.cfg), seeded
               weights: the (1,1,100000) -> (1,256,625) contract, a
               (8,1,160000) batch, the same batch on the CPU (plain path)
               within 2e-4 of its largest value, forward time.
  5. serve   — forward-chunk (the port's CLI entry point) over four wavs
               with the seeded weights saved as a native .npz.
  6. kernel-train — the training kernels qrnn_pool_fwd_train and
               qrnn_pool_bwd against the plain version's autograd at the
               train step's QRNN shapes (batch 32 and 8): zero-seeded,
               c0-seeded, nonzero dc_T, both; dy within 1e-5 of
               max(1, max|dy_plain|); median kernel times and bounds.
  7. train   — one PASE+ / workers+ train step at full width (batch
               2 x 16000) on the card against the same weights and batch
               on the CPU (plain path): per-worker losses within 1e-4
               relative; PReLU inputs of opposite sign on the two devices
               only within 1e-5 of their module's largest from 0; with the
               CPU's PReLUs on the card's side of that kink, the card's
               gradient within 1e-3 of the CPU's largest per parameter
               group, and per leaf within 1e-3 of the CPU leaf's largest
               (leaves above 1e-3 of their group's largest). Then the
               training CLI, ``python -m pase_tpu_torch.train
               --synthetic`` at batch 32 x 32000 for one epoch (100
               steps, a 10-batch eval, FE_e0.npz), and a torch.profiler
               split of three further steps.
Two main paths, each with the launch counts reset to 0 just before it and
read just after: serving (phases 4-5) must launch qrnn_pool_fwd once per
QRNN layer per encoder call; training (the CLI in phase 7) must launch
qrnn_pool_fwd_train and qrnn_pool_bwd once per QRNN layer per train step,
and qrnn_pool_fwd once per layer per eval step. The line before the last
is a JSON summary of the kernels; the last line is {"ok": true, "device":
{...}}.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PASEP_CFG = os.path.join(HERE, "cfg", "frontend", "PASE+.cfg")
WORKERSP_CFG = os.path.join(HERE, "cfg", "workers", "workers+.cfg")
KERNEL_ATOL = 1e-5
ENCODER_REL = 2e-4
TRAIN_LOSS_REL = 1e-4
TRAIN_GRAD_REL = 1e-3
# a PReLU input on opposite sides of 0 on card and CPU must lie this close
# to 0, relative to its module's largest input (float32 rounding)
FLIP_REL = 1e-5
# the H100 SXM's published peaks (NVIDIA data sheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per lane-step, tanh / exp / divide counted as one each
FWD_OPS, BWD_OPS = 14, 25
# (B, T, H) of the train step's QRNN at batch 32 and 8 (3 streams x B
# chunks of 32000 samples -> 200 frames, rnn_dim 512)
TRAIN_QRNN_SHAPES = [(96, 200, 512), (24, 200, 512)]
TRAIN_SHAPE = (96, 200, 512)
TRAIN_BATCH, TRAIN_CHUNK = 32, 32000
# (B, T, H) of the QRNN pooling: the four shapes of benchmarks/bench_qrnn.py
# and the serving batch (8 x 10 s windows at 100 frames/s)
QRNN_SHAPES = [(96, 200, 512), (24, 200, 512), (1, 10000, 512),
               (8, 4000, 512), (8, 1000, 512)]
SERVING_SHAPE = (8, 1000, 512)
WAV_SECONDS = [3.0, 7.3, 10.0, 12.5]
SR = 16000


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_device():
    import torch
    check(torch.cuda.is_available(),
          "no CUDA device: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s); {name}")
    print(smi.stdout.strip().splitlines()[0])
    return name


def phase_build():
    from pase_tpu_torch.ops import cuda_qrnn
    t0 = time.perf_counter()
    cuda_qrnn.build(verbose=True)
    print(f"[build] {os.path.relpath(cuda_qrnn.library_path(), HERE)} from "
          f"{os.path.relpath(cuda_qrnn.SOURCE, HERE)} in "
          f"{time.perf_counter() - t0:.2f} s")


def _kernel_ms(fn, batches=5, per_batch=10):
    """Median over batches of CUDA-event time per launch."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return statistics.median(times)


def _wall_ms(fn, device, reps=3):
    """Median host time of a synchronized call, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(nbytes, nops):
    """(least ms for the work on the card, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernel():
    """Kernel vs plain version at each QRNN shape; returns the summary."""
    import torch
    from pase_tpu_torch.ops import cuda_qrnn
    from pase_tpu_torch.ops import qrnn as plain
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, t, h in QRNN_SHAPES:
        y = torch.randn(b, t, 3 * h, device="cuda", generator=gen)
        c0 = torch.randn(b, h, device="cuda", generator=gen)
        errs = []
        for seed in (None, c0):
            hk, ck = cuda_qrnn.qrnn_pool(y, seed)
            hp, cp = plain.qrnn_pool(y, seed)
            torch.cuda.synchronize()
            errs += [(hk - hp).abs().max().item(),
                     (ck - cp).abs().max().item()]
        half = t // 2
        h_full, c_full = cuda_qrnn.qrnn_pool(y, c0)
        h1, c1 = cuda_qrnn.qrnn_pool(y[:, :half].contiguous(), c0)
        h2, c2 = cuda_qrnn.qrnn_pool(y[:, half:].contiguous(), c1)
        streamed = bool(torch.equal(torch.cat([h1, h2], 1), h_full)
                        and torch.equal(c2, c_full))
        ms = _kernel_ms(lambda: cuda_qrnn.qrnn_pool(y))
        plain_ms = _wall_ms(lambda: plain.qrnn_pool(y), "cuda")
        # y read once, h written once, c_T written once
        bound_ms, bound_by = bound(16 * b * t * h + 4 * b * h,
                                   FWD_OPS * b * t * h)
        err = max(errs)
        print(f"[kernel] qrnn_pool y[{b},{t},{3 * h}]: max|dh| {errs[0]:.3e} "
              f"max|dc_T| {errs[1]:.3e}; c0-seeded max|dh| {errs[2]:.3e} "
              f"max|dc_T| {errs[3]:.3e}; block-streamed == full: {streamed}; "
              f"kernel {ms:.4f} ms (CUDA events, median of 5x10), plain "
              f"{plain_ms:.2f} ms (synchronized, median of 3), bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        check(err <= KERNEL_ATOL,
              f"kernel vs plain at {(b, t, h)}: {err:.3e} > {KERNEL_ATOL}")
        check(streamed, f"block-streamed != full at {(b, t, h)}")
        rows.append({"shape": [b, t, h], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by})
        del y, c0, h_full, h1, h2
    torch.cuda.empty_cache()
    return rows


def phase_encoder(device, cfg=PASEP_CFG, batch=8, samples=160000, reps=5):
    """PASE+ forward on ``device`` vs the same weights on the CPU.
    Returns (encoder, number of encoder calls made on ``device``)."""
    import torch
    from pase_tpu_torch import wf_builder
    enc = wf_builder(cfg, device=device, seed=0)
    rng = np.random.RandomState(0)
    calls = 0
    y = enc((rng.randn(1, 1, 100000) * 0.1).astype(np.float32))
    calls += 1
    _sync(device)
    check(tuple(y.shape) == (1, enc.emb_dim, 100000 // 160),
          f"contract: {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), "contract output not finite")
    print(f"[encoder] contract (1,1,100000) -> {tuple(y.shape)}")

    x = (rng.randn(batch, 1, samples) * 0.1).astype(np.float32)
    y = enc(x)
    calls += 1
    _sync(device)
    check(tuple(y.shape) == (batch, enc.emb_dim, samples // 160),
          f"batch output {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), "batch output not finite")
    ms = _wall_ms(lambda: enc(x), device, reps=reps)
    calls += 1 + reps
    audio_s = batch * samples / SR
    print(f"[encoder] ({batch},1,{samples}) -> {tuple(y.shape)}: forward "
          f"{ms:.2f} ms (synchronized, median of {reps}), "
          f"{audio_s / (ms / 1e3):.1f} audio-s/s")

    cpu = wf_builder(cfg, device="cpu", seed=0)
    cpu.module.load_state_dict(enc.module.state_dict())
    t0 = time.perf_counter()
    y_cpu = cpu(x)
    cpu_s = time.perf_counter() - t0
    rel = ((y.cpu() - y_cpu).abs().max() / y_cpu.abs().max()).item()
    print(f"[encoder] {device} vs cpu (plain path, {cpu_s:.2f} s): "
          f"max|dy|/max|y_cpu| {rel:.3e} (bound {ENCODER_REL})")
    check(rel <= ENCODER_REL, f"{device} vs cpu: {rel:.3e} > {ENCODER_REL}")
    return enc, calls


def phase_serve(enc, device, cfg=PASEP_CFG, chunk=160000):
    """forward-chunk over four wavs; returns the number of encoder calls
    (one per window, plus one for the cross-check)."""
    from pase_tpu_torch import util_scripts
    from pase_tpu_torch.checkpoint import save_variables_npz
    from pase_tpu_torch.data.io import read_wav, write_wav
    tmp = tempfile.mkdtemp(prefix="pase_chip_smoke_")
    try:
        rng = np.random.RandomState(1)
        lengths = {}
        for i, sec in enumerate(WAV_SECONDS):
            n = int(round(sec * SR))
            write_wav(os.path.join(tmp, f"utt{i}.wav"),
                      (rng.randn(n) * 0.1).astype(np.float32))
            lengths[f"utt{i}"] = n
        with open(os.path.join(tmp, "list.txt"), "w") as f:
            f.write("".join(f"{k}.wav\n" for k in lengths))
        npz = save_variables_npz(os.path.join(tmp, "FE_seed0.npz"),
                                 enc.module.state_dict())
        t0 = time.perf_counter()
        util_scripts.main([
            "forward-chunk", "--device", device, "--fe_cfg", cfg,
            "--fe_ckpt", npz, "--wav_list", os.path.join(tmp, "list.txt"),
            "--files_root", tmp, "--out_dir", os.path.join(tmp, "out"),
            "--chunk_size", str(chunk)])
        _sync(device)
        dt = time.perf_counter() - t0
        windows = 0
        for k, n in lengths.items():
            out = np.load(os.path.join(tmp, "out", f"{k}.npy"))
            check(out.shape == (enc.emb_dim, n // 160),
                  f"{k}: {out.shape} != {(enc.emb_dim, n // 160)}")
            check(bool(np.isfinite(out).all()), f"{k}: not finite")
            windows += -(-n // chunk)
        # the first request again through the in-memory encoder: the npz
        # round trip and the windowing give the same frames
        wav, _ = read_wav(os.path.join(tmp, "utt0.wav"))
        ref = enc(np.pad(wav, (0, chunk - len(wav)))[None, None])[0]
        ref = ref[:, :len(wav) // 160].cpu().numpy()
        got = np.load(os.path.join(tmp, "out", "utt0.npy"))
        rel = float(np.abs(got - ref).max() / np.abs(ref).max())
        check(rel <= 1e-5, f"forward-chunk vs encoder: {rel:.3e}")
        audio_s = sum(lengths.values()) / SR
        print(f"[serve] forward-chunk served {len(lengths)} requests "
              f"({audio_s:.1f} s of audio, {windows} windows) in {dt:.3f} s "
              f"incl. encoder build + weight load: "
              f"{len(lengths) / dt:.2f} requests/s, "
              f"{audio_s / dt:.1f} audio-s/s; vs in-memory encoder "
              f"{rel:.3e}")
        return windows + 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_kernel_train():
    """qrnn_pool_fwd_train and qrnn_pool_bwd vs the plain version's
    autograd at the train step's QRNN shapes; returns one summary row per
    shape."""
    import torch
    from pase_tpu_torch.ops import cuda_qrnn
    from pase_tpu_torch.ops import qrnn as plain
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for b, t, h in TRAIN_QRNN_SHAPES:
        def rnd(*shape):
            return torch.randn(*shape, device="cuda", generator=gen)
        y, c0, dh, dct = rnd(b, t, 3 * h), rnd(b, h), rnd(b, t, h), rnd(b, h)
        fwd_err = dy_abs = dy_rel = dc0_err = 0.0
        for seed, dc_last in ((None, None), (c0, None), (None, dct),
                              (c0, dct)):
            hk, ck, ctk = cuda_qrnn.qrnn_pool_fwd_train(y, seed)
            hp, cp = plain.qrnn_pool_fwd_train(y, seed)
            dyk, dc0k = cuda_qrnn.qrnn_pool_bwd(y, ck, dh, dc_last, seed)
            yp = y.clone().requires_grad_()
            c0p = None if seed is None else seed.clone().requires_grad_()
            h_, ct_ = plain.qrnn_pool(yp, c0p)
            loss = torch.sum(h_ * dh)
            if dc_last is not None:
                loss = loss + torch.sum(ct_ * dc_last)
            grads = torch.autograd.grad(
                loss, [yp] + ([] if c0p is None else [c0p]))
            torch.cuda.synchronize()
            fwd_err = max(fwd_err, (hk - hp).abs().max().item(),
                          (ck - cp).abs().max().item(),
                          (ctk - cp[:, -1]).abs().max().item())
            err = (dyk - grads[0]).abs().max().item()
            dy_abs = max(dy_abs, err)
            dy_rel = max(dy_rel, err / max(1.0, grads[0].abs().max().item()))
            if seed is not None:
                dc0_err = max(dc0_err, (dc0k - grads[1]).abs().max().item())
        _, c, _ = cuda_qrnn.qrnn_pool_fwd_train(y)
        zeros = torch.zeros_like(dct)
        fwd_ms = _kernel_ms(lambda: cuda_qrnn.qrnn_pool_fwd_train(y))
        bwd_ms = _kernel_ms(lambda: cuda_qrnn.qrnn_pool_bwd(y, c, dh, zeros))
        fwd_plain = _wall_ms(lambda: plain.qrnn_pool_fwd_train(y), "cuda")
        bwd_plain = _wall_ms(lambda: plain.qrnn_pool_bwd(y, c, dh, zeros),
                             "cuda")
        lanes, steps = b * h, b * t * h
        # fwd_train: y read, h and c written, c_T written; bwd as on the
        # main path (no c0, autograd's zero dc_T): y, c, dh, dc_T read, dy
        # written
        fwd_bound, fwd_by = bound(20 * steps + 4 * lanes, FWD_OPS * steps)
        bwd_bound, bwd_by = bound(32 * steps + 4 * lanes, BWD_OPS * steps)
        print(f"[kernel-train] y[{b},{t},{3 * h}]: fwd_train max|dh|,|dc| "
              f"{fwd_err:.3e}; bwd max|dy - dy_plain| {dy_abs:.3e}, / max(1,"
              f" max|dy_plain|) {dy_rel:.3e}, max|dc0 - dc0_plain| "
              f"{dc0_err:.3e} (zero / c0 / dc_T / both); fwd_train "
              f"{fwd_ms:.4f} ms (bound {fwd_bound:.4f}, {fwd_by}), plain "
              f"{fwd_plain:.2f} ms; bwd {bwd_ms:.4f} ms (bound "
              f"{bwd_bound:.4f}, {bwd_by}), plain {bwd_plain:.2f} ms")
        check(fwd_err <= KERNEL_ATOL,
              f"fwd_train vs plain at {(b, t, h)}: {fwd_err:.3e}")
        check(dy_rel <= KERNEL_ATOL,
              f"bwd dy vs plain at {(b, t, h)}: {dy_rel:.3e}")
        check(dc0_err <= KERNEL_ATOL,
              f"bwd dc0 vs plain at {(b, t, h)}: {dc0_err:.3e}")
        rows.append({"shape": [b, t, h], "fwd_err": fwd_err,
                     "dy_abs": dy_abs, "dy_rel": dy_rel, "dc0_err": dc0_err,
                     "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
                     "fwd_plain_ms": fwd_plain, "bwd_plain_ms": bwd_plain,
                     "fwd_bound": (fwd_bound, fwd_by),
                     "bwd_bound": (bwd_bound, bwd_by)})
        del y, c0, dh, dct, c
    torch.cuda.empty_cache()
    return rows


def _grads(model):
    """{parameter name: its gradient as float64 on the CPU}."""
    import torch
    return {k: (p.grad.double().cpu() if p.grad is not None
                else torch.zeros(p.shape, dtype=torch.float64))
            for k, p in model.named_parameters()}


def phase_train_parity(tmp):
    """One full-width train step on the card vs the CPU plain path, same
    weights and batch. PReLU's derivative jumps at 0: an input that lies
    within rounding of 0 and that the two devices round to opposite sides
    moves the gradient by a whole output gradient there. So the step is
    also taken on the CPU with every PReLU on the card's side of the kink
    (grad_parity.prelu_signs), and the card's gradient is held to that
    one; the sign flips themselves must lie within rounding of 0."""
    import torch
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    from pase_tpu_torch.grad_parity import (group_errors, prelu_signs,
                                            sign_flips, worst_leaves)
    from pase_tpu_torch.trainer import Trainer
    cfg = dict(backprop_mode="base", hop=160, bpe=100, epoch=1, batch_size=2,
               chunk_size=16000, fe_lr=1e-4, min_lr=4e-4, lr_mode="step",
               save_path=tmp)
    gpu = Trainer(PASEP_CFG, WORKERSP_CFG, cfg, device="cuda")
    cpu = Trainer(PASEP_CFG, WORKERSP_CFG, cfg, device="cpu")
    signed = Trainer(PASEP_CFG, WORKERSP_CFG, cfg, device="cpu")
    cpu.model.load_state_dict(gpu.model.state_dict())
    signed.model.load_state_dict(gpu.model.state_dict())
    raw = next(iter(SyntheticChunkBatcher(2, 16000, seed=0)))
    x_gpu, x_cpu = {}, {}
    t0 = time.perf_counter()
    with prelu_signs(gpu.model, record=x_gpu):
        lg = gpu.train_step(raw)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    with prelu_signs(cpu.model, record=x_cpu):
        lc = cpu.train_step(raw)
    t_cpu = time.perf_counter() - t0
    with prelu_signs(signed.model,
                     force={k: x > 0 for k, x in x_gpu.items()}):
        signed.train_step(raw)
    loss_err = {k: abs(float(lg[k]) - float(lc[k])) / abs(float(lc[k]))
                for k in gpu.ordered_names}
    gg = _grads(gpu.model)
    natural = group_errors(gg, _grads(cpu.model))
    grad_err = group_errors(gg, _grads(signed.model))
    worst = worst_leaves(gg, _grads(signed.model), n=3)
    flips = sign_flips(x_gpu, x_cpu)
    far = max([r for _, r in flips.values()], default=0.0)
    print(f"[train] full-width step (PASE+, workers+, batch 2 x 16000): "
          f"card {t_gpu:.2f} s (first step), cpu {t_cpu:.2f} s; per-worker "
          f"|loss_gpu - loss_cpu| / |loss_cpu|: "
          + ", ".join(f"{k} {v:.2e}" for k, v in loss_err.items()))
    print(f"[train] PReLU inputs of opposite sign on card and cpu: "
          f"{sum(n for n, _ in flips.values())} in {len(flips)} PReLU(s), "
          f"the largest |x| {far:.2e} of its module's max (bound "
          f"{FLIP_REL}); max|g_gpu - g_cpu| / max|g_cpu| per group: "
          + ", ".join(f"{g} {v:.2e}" for g, v in natural.items())
          + "; with the cpu's PReLUs on the card's side: "
          + ", ".join(f"{g} {v:.2e}" for g, v in grad_err.items())
          + f" (bound {TRAIN_GRAD_REL}); worst leaves: " + "; ".join(
              f"{k} {a:.2e} of its max" for k, a, _, _ in worst)
          + f" (bound {TRAIN_GRAD_REL})")
    check(all(v <= TRAIN_LOSS_REL for v in loss_err.values()),
          f"card vs cpu losses beyond {TRAIN_LOSS_REL}: {loss_err}")
    check(far <= FLIP_REL, f"a PReLU input {far:.3e} of its module's max "
          f"from 0 has opposite signs on card and cpu: {flips}")
    check(all(v <= TRAIN_GRAD_REL for v in grad_err.values()),
          f"card vs cpu gradients beyond {TRAIN_GRAD_REL}: {grad_err}")
    check(all(a <= TRAIN_GRAD_REL for _, a, _, _ in worst),
          f"card vs cpu gradient leaves beyond {TRAIN_GRAD_REL} of their "
          f"max: {worst}")
    del gpu, cpu, signed
    torch.cuda.empty_cache()
    return max(loss_err.values()), grad_err


def phase_train_cli(tmp):
    """The training CLI at batch 32 x 32000 for one epoch; returns (the
    trainer, launch counts of the run, {perf scalars})."""
    import math
    import torch
    from pase_tpu_torch import train as train_cli
    from pase_tpu_torch.ops import cuda_qrnn
    torch.cuda.reset_peak_memory_stats()
    cuda_qrnn.reset_launches()                 # the training path starts
    t0 = time.perf_counter()
    tr = train_cli.main([
        "--synthetic", "--net_cfg", WORKERSP_CFG, "--fe_cfg", PASEP_CFG,
        "--batch_size", str(TRAIN_BATCH), "--chunk_size", str(TRAIN_CHUNK),
        "--epoch", "1", "--log_freq", "25", "--save_path", tmp])
    torch.cuda.synchronize()
    launches = dict(cuda_qrnn.LAUNCHES)        # ... and ends here
    wall = time.perf_counter() - t0
    recs = []
    with open(os.path.join(tmp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    perf = [r for r in recs if r["split"] == "perf"]
    check(len(perf) == 1, f"expected one perf line, got {len(perf)}")
    losses = [(r["split"], r["step"], k, v) for r in recs
              if r["split"] in ("train", "eval") for k, v in r.items()
              if k not in ("t", "split", "step")]
    check(any(s == "train" for s, *_ in losses), "no train losses logged")
    check(any(s == "eval" for s, *_ in losses), "no eval losses logged")
    bad = [x for x in losses if not math.isfinite(x[3])]
    check(not bad, f"non-finite logged losses: {bad[:5]}")
    layers = len(tr.model.frontend.rnn.layers)
    steps, evals = tr.bpe, tr.cfg["va_bpe"]
    expected = {"qrnn_pool_fwd_train": layers * steps,
                "qrnn_pool_bwd": layers * steps,
                "qrnn_pool_fwd": layers * evals}
    print(f"[launches] training path: {launches} (expected {expected}: "
          f"{layers} QRNN layer(s) x {steps} train steps, x {evals} eval "
          f"steps)")
    check(launches == expected, f"training launches {launches} != "
          f"{expected}")
    npz = os.path.join(tmp, "FE_e0.npz")
    check(os.path.isfile(npz), "FE_e0.npz was not written")
    from pase_tpu_torch import wf_builder
    enc = wf_builder(PASEP_CFG, device="cuda").load_pretrained(npz)
    for k, v in tr.model.frontend.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            check(torch.equal(enc.module.state_dict()[k], v),
                  f"FE_e0.npz differs from the trained encoder at {k}")
    y = enc(np.random.RandomState(2).randn(1, 1, 16000).astype(np.float32))
    check(bool(torch.isfinite(y).all()), "FE_e0.npz encoder output")
    p = perf[0]
    last = [r for r in recs if r["split"] == "train"][-1]
    ev = [r for r in recs if r["split"] == "eval"][-1]
    print(f"[train] python -m pase_tpu_torch.train --synthetic (PASE+, "
          f"workers+, batch {TRAIN_BATCH} x {TRAIN_CHUNK}, 1 epoch of "
          f"{steps} steps + {evals} eval batches): {wall:.1f} s in all; "
          f"{p['steps_per_sec']:.3f} steps/s, {p['audio_sec_per_sec']:.1f} "
          f"audio-s/s; step {last['step']} total {last['total']:.4f}, eval "
          f"total {ev['total']:.4f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; FE_e0.npz "
          f"loads into wf_builder")
    return tr, launches, p


def phase_profile(tr):
    """torch.profiler split of three train steps of the CLI's trainer."""
    from pase_tpu_torch.data.dataset import DeviceSyntheticBatcher
    from pase_tpu_torch.profiling import profile_train_steps
    batcher = DeviceSyntheticBatcher(tr.batch_size, tr.chunk_size, seed=7)
    prof = profile_train_steps(tr, [batcher.make_batch() for _ in range(5)])
    print(f"[profile] train step (batch {TRAIN_BATCH} x {TRAIN_CHUNK}): wall"
          f" {prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} ms,"
          f" idle share {prof['idle_share']:.3f}")
    for span, kinds in sorted(prof["split"].items()):
        tot = sum(kinds.values())
        print(f"[profile]   {span}: {tot:.2f} ms = " + ", ".join(
            f"{k} {v:.2f}" for k, v in sorted(kinds.items(),
                                              key=lambda kv: -kv[1])))
    return prof


def _row(name, source, replaces, launches, err, ms, plain_ms, bnd):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": None}


def main():
    if not os.path.isdir(os.path.join(HERE, "pase_tpu_torch")):
        print("FAIL: the pase_tpu_torch package is not beside chip_smoke.py",
              flush=True)
        return 1
    sys.path.insert(0, HERE)
    tmp = tempfile.mkdtemp(prefix="pase_chip_train_")
    try:
        name = phase_device()
        phase_build()
        rows = phase_kernel()
        train_rows = phase_kernel_train()
        from pase_tpu_torch.ops import cuda_qrnn
        cuda_qrnn.reset_launches()          # the serving path starts here
        enc, enc_calls = phase_encoder("cuda")
        serve_calls = phase_serve(enc, "cuda")
        serving_launches = dict(cuda_qrnn.LAUNCHES)   # ... and ends here
        layers = len(enc.module.rnn.layers)
        expected = {"qrnn_pool_fwd": layers * (enc_calls + serve_calls),
                    "qrnn_pool_fwd_train": 0, "qrnn_pool_bwd": 0}
        print(f"[launches] serving path: {serving_launches} (expected "
              f"{expected}: {layers} QRNN layer(s) x "
              f"{enc_calls + serve_calls} encoder calls)")
        check(serving_launches == expected,
              f"serving launches {serving_launches} != {expected}")
        del enc
        phase_train_parity(os.path.join(tmp, "parity"))
        tr, train_launches, _ = phase_train_cli(os.path.join(tmp, "cli"))
        phase_profile(tr)
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    import torch
    src = "pase_tpu_torch/csrc/qrnn_pool.cu"
    serving = next(r for r in rows if tuple(r["shape"]) == SERVING_SHAPE)
    train = next(r for r in train_rows
                 if tuple(r["shape"]) == TRAIN_SHAPE)
    print(json.dumps({"kernels": [
        _row("qrnn_pool_fwd", src, "pase_tpu/ops/pallas_qrnn.py:63",
             serving_launches["qrnn_pool_fwd"],
             max(r["max_abs_err"] for r in rows), serving["ms"],
             serving["plain_ms"], (serving["bound_ms"], serving["bound_by"])),
        _row("qrnn_pool_fwd_train", src, "pase_tpu/ops/pallas_qrnn.py:82",
             train_launches["qrnn_pool_fwd_train"],
             max(r["fwd_err"] for r in train_rows), train["fwd_ms"],
             train["fwd_plain_ms"], train["fwd_bound"]),
        _row("qrnn_pool_bwd", src, "pase_tpu/ops/pallas_qrnn.py:87",
             train_launches["qrnn_pool_bwd"],
             max(r["dy_abs"] for r in train_rows), train["bwd_ms"],
             train["bwd_plain_ms"], train["bwd_bound"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
