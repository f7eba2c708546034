"""Where the device time of a training step goes.

``profile_train_steps`` runs a few ``Trainer.train_step`` calls under
``torch.profiler`` and splits the device kernels' time by the step's part
(the ``pase.*`` spans of ``trainer.py``) and by kernel kind, read from the
kernel's name:

  qrnn fwd_train / qrnn bwd / qrnn fwd / qrnn fwd chunked — this
      package's CUDA kernels (qrnn fwd: the serial serving forward, the
      seeded K1 of a streaming push);
  conv fprop / conv dgrad / conv wgrad — cuDNN convolutions. In the
      forward span a dgrad kernel is a transposed convolution (the
      cchunk decoder), in the backward span an fprop kernel is the data
      gradient of one;
  matmul — cuBLAS GEMMs (the QRNN and head projections, the fused lps
      head-loss matmuls);
  fft — cuFFT (STFTs and the prosody autocorrelation of the targets);
  adam — the optimizer's multi-tensor kernels;
  reduction, elementwise — the rest.

``module_span`` puts a module's calls in a span of their own (the VQ
quantizer's ``pase.quantizer`` inside ``pase.forward``); an op counts in
the innermost span. The GAN discriminator's work (its call on the fake
in the losses, and its own step) runs in ``pase.discriminator``.
``profile_calls`` splits any function's device time the same way (an
encoder forward: the quantizer beside the trunk, 'other'), and counts
the kernels each span launched.

A measurement helper: it needs a CUDA device and is used by
``chip_smoke.py``.
"""

import contextlib
import time

import torch
from torch.profiler import record_function

SPANS = ("pase.prepare", "pase.forward", "pase.losses", "pase.backward",
         "pase.optimizer", "pase.quantizer", "pase.discriminator")


@contextlib.contextmanager
def module_span(module, name):
    """Within the block, every call of ``module`` runs in a
    ``record_function(name)`` span (forward hooks: the module's code is
    not touched, so an exported program never sees the span)."""
    open_spans = []

    def enter(mod, args):
        span = record_function(name)
        span.__enter__()
        open_spans.append(span)

    def leave(mod, args, out):
        open_spans.pop().__exit__(None, None, None)

    hooks = [module.register_forward_pre_hook(enter),
             module.register_forward_hook(leave)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def kernel_kind(name):
    n = name.lower()
    if "qrnn_pool_bwd" in n:
        return "qrnn bwd"
    if "qrnn_pool_fwd_kernel<true>" in n:
        return "qrnn fwd_train"
    if "qrnn_pool_fwd_chunked" in n:
        return "qrnn fwd chunked"
    if "qrnn_pool_fwd_seg_kernel" in n or "qrnn_pool_fwd_kernel" in n:
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


def _span_of(evt, spans):
    """The ``pase.*`` span an op ran in. The autograd engine runs a
    backward's ops on its own thread, under its ``evaluate_function``
    frames: they belong to the innermost span of ``spans`` ((start us, end
    us, name) of every span) that was open when they started, the span
    the caller of ``backward`` waited in (``pase.backward``, or
    ``pase.discriminator`` for the GAN discriminator's own backward)."""
    start = evt.time_range.start
    while evt is not None:
        if evt.name in SPANS:
            return evt.name
        if evt.name.startswith("autograd::engine::evaluate_function"):
            open_ = [(e - s, name) for s, e, name in spans
                     if s <= start <= e]
            return min(open_)[1] if open_ else "pase.backward"
        evt = evt.cpu_parent
    return "other"


def profile_train_steps(trainer, batches, warmup=2):
    """Profile ``trainer.train_step`` over ``batches`` (a list; the first
    ``warmup`` run unprofiled). Returns a dict: wall ms per step (host
    clock, synchronized), device busy ms per step (sum of kernel times),
    the idle share, {span: {kind: ms per step}} and {span: kernels
    launched per step}."""
    return profile_calls([lambda raw=raw: trainer.train_step(raw)
                          for raw in batches], warmup)


def profile_calls(calls, warmup=1):
    """Profile a list of calls (the first ``warmup`` run unprofiled);
    the same dict as ``profile_train_steps``, per call."""
    from torch.profiler import ProfilerActivity, profile
    for fn in calls[:warmup]:
        fn()
    measured = calls[warmup:]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for fn in measured:
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / len(measured)
    split, launches = {}, {}
    busy = 0.0

    def add(span_name, kernel_name, us):
        nonlocal busy
        ms = us / 1e3 / len(measured)
        span = split.setdefault(span_name, {})
        kind = kernel_kind(kernel_name)
        span[kind] = span.get(kind, 0.0) + ms
        launches[span_name] = launches.get(span_name, 0) + 1 / len(measured)
        busy += ms

    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.name in SPANS]
    for evt in events:
        for k in evt.kernels:
            add(_span_of(evt, spans), k.name, k.duration)
    return {"wall_ms": wall, "busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall), "split": split,
            "launches": launches}
