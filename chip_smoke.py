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
The kernel launch count is reset to 0 before phase 4 and read after phase
5: the main path must launch the kernel once per QRNN layer per encoder
call. The line before the last is a JSON summary of the kernels; the last
line is {"ok": true, "device": {...}}.
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
KERNEL_ATOL = 1e-5
ENCODER_REL = 2e-4
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
        err = max(errs)
        print(f"[kernel] qrnn_pool y[{b},{t},{3 * h}]: max|dh| {errs[0]:.3e} "
              f"max|dc_T| {errs[1]:.3e}; c0-seeded max|dh| {errs[2]:.3e} "
              f"max|dc_T| {errs[3]:.3e}; block-streamed == full: {streamed}; "
              f"kernel {ms:.4f} ms (CUDA events, median of 5x10), plain "
              f"{plain_ms:.2f} ms (synchronized, median of 3)")
        check(err <= KERNEL_ATOL,
              f"kernel vs plain at {(b, t, h)}: {err:.3e} > {KERNEL_ATOL}")
        check(streamed, f"block-streamed != full at {(b, t, h)}")
        rows.append({"shape": [b, t, h], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms})
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


def main():
    if not os.path.isdir(os.path.join(HERE, "pase_tpu_torch")):
        print("FAIL: the pase_tpu_torch package is not beside chip_smoke.py",
              flush=True)
        return 1
    sys.path.insert(0, HERE)
    try:
        name = phase_device()
        phase_build()
        rows = phase_kernel()
        from pase_tpu_torch.ops import cuda_qrnn
        cuda_qrnn.LAUNCHES = 0            # the main path starts here
        enc, enc_calls = phase_encoder("cuda")
        serve_calls = phase_serve(enc, "cuda")
        launches = cuda_qrnn.LAUNCHES
        layers = len(enc.module.rnn.layers)
        expected = layers * (enc_calls + serve_calls)
        print(f"[launches] qrnn_pool kernel: {launches} on the main path "
              f"(expected {layers} QRNN layer(s) x "
              f"{enc_calls + serve_calls} encoder calls = {expected})")
        check(launches > 0, "the main path never launched the QRNN kernel")
        check(launches == expected,
              f"kernel launches {launches} != {expected}")
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    import torch
    serving = next(r for r in rows if tuple(r["shape"]) == SERVING_SHAPE)
    print(json.dumps({"kernels": [{
        "name": "qrnn_pool_fwd", "route": "cuda",
        "source": "pase_tpu_torch/csrc/qrnn_pool.cu",
        "replaces": "pase_tpu/ops/pallas_qrnn.py:63",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": serving["ms"], "plain_ms": serving["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
