"""Where the device time of a training step goes.

``profile_train_steps`` runs a few ``Trainer.train_step`` calls under
``torch.profiler`` and splits the device kernels' time by the step's part
(the ``pase.*`` spans of ``trainer.py``) and by kernel kind, read from the
kernel's name:

  qrnn fwd_train / qrnn bwd / qrnn fwd / qrnn fwd few / qrnn fwd eval /
      qrnn fwd split — this package's CUDA kernels
      (qrnn fwd: the serial serving forward, the seeded K1 of a streaming
      push; qrnn fwd few: the unseeded forward on few lanes of short T, a
      B = 1 extraction; qrnn fwd eval: the unseeded forward on many
      lanes, an eval batch; qrnn fwd split: the unseeded forward on few
      lanes of many steps, split in time across blocks);
  rnn — cuDNN's recurrent kernels (the BiRNN context layer, the GRU
      head's and WaveRNN's GRUs; the GEMMs cuDNN launches for them count
      as matmul) and ATen's fused cells (``generate``'s steps);
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
quantizer's ``pase.quantizer`` inside ``pase.forward``); a kernel counts
in the innermost span. The GAN discriminator's work (its call on the
fake in the losses, and its own step) runs in ``pase.discriminator``;
the MGD policy's per-worker gradients and min-norm weights in
``pase.mgda`` inside ``pase.losses``.
``profile_calls`` splits any function's device time the same way (an
encoder forward: the quantizer beside the trunk, 'other'), and counts
the kernels each span launched; with ``spans=False`` it records the
card alone, cheaply enough for a step of a million kernels, and splits
by kind only.

A measurement helper: it needs a CUDA device and is used by
``chip_smoke.py``.

``profile_train_step`` is ``util_scripts profile-step``'s timer (the JAX
package's ``profiling.profile_train_step``): the prepare alone and the
whole step in sustained loops, synchronized at both ends (on the card
with ``torch.cuda.synchronize``; it also runs on the CPU).
"""

import bisect
import contextlib
import re
import time

import torch
from torch.profiler import record_function

# cuDNN's recurrent kernels (elemWiseRNNcell, GRU_elementWise_bp1, ...)
# and ATen's fused GRU / LSTM cells, by case: a lowercase 'gru' is also
# in CUTLASS's convolution kernels ('...Congruous...')
_RECURRENT = re.compile(r"RNN|(?<![A-Za-z])(GRU|LSTM)_|(gru|lstm)_cell")
SPANS = ("pase.prepare", "pase.forward", "pase.losses", "pase.backward",
         "pase.optimizer", "pase.quantizer", "pase.discriminator",
         "pase.mgda")


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
    if "qrnn_pool_fwd_train_kernel" in n:
        return "qrnn fwd_train"
    if "qrnn_pool_fwd_eval_kernel" in n:
        return "qrnn fwd eval"
    if "qrnn_pool_fwd_split_kernel" in n:
        return "qrnn fwd split"
    if "qrnn_pool_fwd_few_kernel" in n:
        return "qrnn fwd few"
    if "qrnn_pool_fwd_seg_kernel" in n or "qrnn_pool_fwd_kernel" in n:
        return "qrnn fwd"
    if _RECURRENT.search(name):
        return "rnn"
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


class _Spans:
    """The ``pase.*`` span a kernel was launched in, from the launch's
    host thread and time. The autograd engine runs a backward's ops on its
    own thread, under its ``evaluate_function`` frames: a launch there
    belongs to the innermost span of any thread that was open at the time,
    the span the caller of ``backward`` waited in (``pase.backward``, or
    ``pase.discriminator`` for the GAN discriminator's own backward).
    Outside every span and frame: 'other'."""

    def __init__(self, cpu_events):
        self.spans, frames = [], {}
        for e in cpu_events:
            name = e.name()
            if name in SPANS and e.is_user_annotation():
                self.spans.append((e.start_ns(), e.end_ns(), name,
                                   e.start_thread_id()))
            elif name.startswith("autograd::engine::evaluate_function"):
                frames.setdefault(e.start_thread_id(), []).append(
                    (e.start_ns(), e.end_ns()))
        # per thread: the frames' starts in order and the latest end of
        # the frames begun so far (a time t lies in some frame iff the
        # latest end among those begun by t reaches t)
        self.frames = {}
        for thread, fr in frames.items():
            fr.sort()
            ends, top = [], 0
            for _, end in fr:
                top = max(top, end)
                ends.append(top)
            self.frames[thread] = ([a for a, _ in fr], ends)

    def _innermost(self, t, thread=None):
        open_ = [(s, name) for s, e, name, th in self.spans
                 if s <= t <= e and thread in (None, th)]
        return max(open_)[1] if open_ else None

    def of(self, thread, t):
        span = self._innermost(t, thread)
        if span is not None:
            return span
        starts, ends = self.frames.get(thread, ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and ends[i] >= t:
            return self._innermost(t) or "pase.backward"
        return "other"


def profile_train_steps(trainer, batches, warmup=2):
    """Profile ``trainer.train_step`` over ``batches`` (a list; the first
    ``warmup`` run unprofiled); ``profile_calls``' dict, per step."""
    return profile_calls([lambda raw=raw: trainer.train_step(raw)
                          for raw in batches], warmup)


def profile_calls(calls, warmup=1, spans=True):
    """Profile a list of calls (the first ``warmup`` run unprofiled).
    Returns a dict per call: ``wall_ms`` (host clock, synchronized);
    ``busy_ms``, the sum of the device activities' times (kernels,
    copies, memsets; each counted once); ``covered_ms``, the time at
    least one of them ran (below the sum where kernels of several streams
    overlap, as cuDNN's recurrences do); ``idle_share``, 1 - covered /
    wall; ``split``, {span: {kind: ms}}, which adds up to ``busy_ms``;
    ``launches``, {span: activities}. With ``spans`` False only the
    card's activity is recorded, and ``split`` and ``launches`` hold one
    span, 'all': cheap enough for a call of a million kernels.

    It reads the profiler's raw events. Each device activity counts once,
    in the span its launch ran in: the launch is the host's CUDA API call
    with the activity's correlation id. (torch's per-op events attach an
    activity to every host event that holds its op's id, and API calls'
    ids, another numbering, collide with ops': there cuDNN's recurrent
    kernels counted about 4 times.) A ``record_function`` span's image on
    the card (a user annotation over its kernels) is not an activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for fn in calls[:warmup]:
        fn()
    measured = calls[warmup:]
    n = len(measured)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]
                 + ([ProfilerActivity.CPU] if spans else [])) as prof:
        t0 = time.perf_counter()
        for fn in measured:
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    device, cpu, launch = [], [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append(e)
        elif spans:
            cpu.append(e)
            if e.linked_correlation_id() > 0:       # a CUDA API call
                launch[e.correlation_id()] = (e.start_thread_id(),
                                              e.start_ns())
    where = _Spans(cpu) if spans else None
    split, launches, intervals = {}, {}, []
    for e in device:
        span = "all"
        if where is not None:
            at = launch.get(e.correlation_id())
            span = "other" if at is None else where.of(*at)
        kinds = split.setdefault(span, {})
        kind = kernel_kind(e.name())
        kinds[kind] = kinds.get(kind, 0.0) + e.duration_ns() / 1e6 / n
        launches[span] = launches.get(span, 0) + 1 / n
        intervals.append((e.start_ns(), e.end_ns()))
    covered = _union(intervals) / 1e6 / n
    return {"wall_ms": wall,
            "busy_ms": sum(sum(k.values()) for k in split.values()),
            "covered_ms": covered,
            "idle_share": max(0.0, 1.0 - covered / wall), "split": split,
            "launches": launches}


def _union(intervals):
    """The length of the union of (start, end) intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def device_timeit(fn, device, n_warm=3, n_meas=20):
    """Mean wall ms per call of ``fn()`` over ``n_meas`` calls after
    ``n_warm``, the device synchronized before and after the loop."""
    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(n_warm):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(n_meas):
        fn()
    sync()
    return (time.perf_counter() - t0) / n_meas * 1e3


def profile_train_step(trainer, batch_size, chunk_size, seed=0, n_meas=20):
    """{prepare_ms, step_ms, model_opt_ms, steps_per_sec,
    audio_sec_per_sec} of ``trainer``'s step on the first batch of
    ``SyntheticChunkBatcher(batch_size, chunk_size, seed)``: the prepare
    (distortions, targets, ZNorm) timed alone under the step's compute
    dtype, the whole step in a sustained loop (its optimizer updates
    carried through), model + optimizer as their difference."""
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    from pase_tpu_torch.precision import compute_dtype
    raw = trainer.ready(next(iter(SyntheticChunkBatcher(
        batch_size, chunk_size, seed=seed))))
    gen = torch.Generator(device=trainer.device).manual_seed(seed)

    def prepare():
        with torch.no_grad(), compute_dtype(trainer.compute_dtype):
            return trainer.prepare(raw, gen)

    prepare_ms = device_timeit(prepare, trainer.device, n_meas=n_meas)
    step_ms = device_timeit(lambda: trainer.train_step(raw), trainer.device,
                            n_meas=n_meas)
    return {"prepare_ms": round(prepare_ms, 3),
            "step_ms": round(step_ms, 3),
            "model_opt_ms": round(step_ms - prepare_ms, 3),
            "steps_per_sec": round(1e3 / step_ms, 3),
            "audio_sec_per_sec": round(1e3 / step_ms * batch_size
                                       * chunk_size / 16000, 1)}
