"""Where the device time of a training step goes.

``profile_train_steps`` runs a few ``Trainer.train_step`` calls under
``torch.profiler`` and splits the device kernels' time by the step's part
(the ``pase.*`` spans of ``trainer.py``) and by kernel kind, read from the
kernel's name:

  qrnn fwd_train / qrnn bwd / qrnn fwd — this package's CUDA kernels;
  conv fprop / conv dgrad / conv wgrad — cuDNN convolutions. In the
      forward span a dgrad kernel is a transposed convolution (the
      cchunk decoder), in the backward span an fprop kernel is the data
      gradient of one;
  matmul — cuBLAS GEMMs (the QRNN and head projections, the fused lps
      head-loss matmuls);
  fft — cuFFT (STFTs and the prosody autocorrelation of the targets);
  adam — the optimizer's multi-tensor kernels;
  reduction, elementwise — the rest.

A measurement helper: it needs a CUDA device and is used by
``chip_smoke.py``.
"""

import time

import torch

SPANS = ("pase.prepare", "pase.forward", "pase.losses", "pase.backward",
         "pase.optimizer")


def kernel_kind(name):
    n = name.lower()
    if "qrnn_pool_bwd" in n:
        return "qrnn bwd"
    if "qrnn_pool_fwd_kernel<true>" in n:
        return "qrnn fwd_train"
    if "qrnn_pool_fwd_kernel" in n:
        return "qrnn fwd"
    if "dgrad" in n:
        return "conv dgrad"
    if "wgrad" in n:
        return "conv wgrad"
    if "fprop" in n or "conv" in n or "cudnn" in n:
        return "conv fprop"
    if "fft" in n:
        return "fft"
    if "gemm" in n or "cublas" in n or "cutlass" in n:
        return "matmul"
    if "multi_tensor_apply" in n or "adam" in n:
        return "adam"
    if "reduce" in n:
        return "reduction"
    return "elementwise"


def _span_of(evt):
    """The ``pase.*`` span an op ran in. The autograd engine runs the
    backward's ops on its own thread, outside the ``pase.backward`` span;
    they sit under its ``evaluate_function`` frames."""
    while evt is not None:
        if evt.name in SPANS:
            return evt.name
        if evt.name.startswith("autograd::engine::evaluate_function"):
            return "pase.backward"
        evt = evt.cpu_parent
    return "other"


def profile_train_steps(trainer, batches, warmup=2):
    """Profile ``trainer.train_step`` over ``batches`` (a list; the first
    ``warmup`` run unprofiled). Returns a dict: wall ms per step (host
    clock, synchronized), device busy ms per step (sum of kernel times),
    the idle share, and {span: {kind: ms per step}}."""
    from torch.profiler import ProfilerActivity, profile
    for raw in batches[:warmup]:
        trainer.train_step(raw)
    measured = batches[warmup:]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for raw in measured:
            trainer.train_step(raw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / len(measured)
    split = {}
    busy = 0.0

    def add(span_name, kernel_name, us):
        nonlocal busy
        ms = us / 1e3 / len(measured)
        span = split.setdefault(span_name, {})
        kind = kernel_kind(kernel_name)
        span[kind] = span.get(kind, 0.0) + ms
        busy += ms

    for evt in prof.events():
        for k in evt.kernels:
            add(_span_of(evt), k.name, k.duration)
    return {"wall_ms": wall, "busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall), "split": split}
