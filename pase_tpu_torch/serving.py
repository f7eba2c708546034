"""Serving artifacts of the frozen encoder (``torch.export``).

The port of ``pase_tpu/serving.py``. An artifact is a directory that a
process serves with torch, numpy and the registered QRNN operator alone
(``import pase_tpu_torch.ops.cuda_qrnn``): no model code, no cfg.

* ``export_encoder`` writes one exported program per time bucket (default
  0.5 / 1 / 2 / 4 s at 16 kHz) with a symbolic batch, ``encoder_T{N}.pt2``.
  The programs take the weights as inputs, so they are stored once, in
  ``params.npz`` in the JAX package's variables layout
  (``checkpoint.save_variables``): a JAX-trained encoder's weights load
  unchanged. ``meta.json`` lists, per program input, its npz key and the
  axis permutation from the JAX layout (a conv kernel [K, Cin, Cout] is
  the weight [Cout, Cin, K]).
* ``ServingEncoder`` routes an utterance to the smallest bucket that holds
  it plus the trunk's receptive halo (zero-padded, frames trimmed), windows
  longer ones at the largest bucket, and batches same-bucket utterances:
  the frames of ``util_scripts forward-chunk --chunk_size <largest>``.
  The halo is WaveFe's; for the other families (``encoders.py``) it is
  null and every request takes the largest bucket, as in JAX. The hop
  is the module's own (``hop``: TDNN and ASPP 160, the ResNet 40).
* ``export_streaming_encoder`` / ``ServingStreamingEncoder``: the exact
  online encoder (``streaming.py``, WaveFe only: another family raises
  its TypeError) as three programs, prime, step and flush, with every
  FIFO and carry as explicit tensors (a flat list). The state out of
  prime must be a fixed point of step, else the chunk is too small and
  the export raises.

The QRNN pooling in the programs is the registered operator
``pase_tpu_torch::qrnn_pool_fwd``: its CUDA implementation takes the
route (``cuda_qrnn.forward_entry``) from each call's shapes, so one
exported bucket takes the chunked kernel at a small batch and the
one-thread-a-lane one above ``cuda_qrnn.CHUNKED_LANES`` lanes, and a
streaming program's seeded calls take the segmented one.

Devices: a program traced on one device names it in some of its nodes (a
zero carry, the SincConv's time axes), so an artifact serves the device it
was exported on, recorded in ``meta.json``. A loader asked for another
device moves the programs (``torch.export.passes.move_to_device_pass``).
Serving runs in float32 with TF32 off for matmuls and cuDNN, as
``forward-chunk`` does; the loaders set both.

Layout: ``out_dir/meta.json``, ``out_dir/params.npz``,
``out_dir/encoder_T{N}.pt2``; streaming: ``meta_streaming.json`` and
``streaming_{prime,step,flush}_C{chunk}.pt2``.
"""

import json
import os
import time

import numpy as np
import torch
from torch import nn
from torch.export import Dim, export
from torch.export.passes import move_to_device_pass
from torch.utils import _pytree as pytree

from pase_tpu_torch.checkpoint import (save_variables,
                                       state_dict_to_variables)
# registers torch.ops.pase_tpu_torch.qrnn_pool_fwd, which the programs call
from pase_tpu_torch.ops import cuda_qrnn  # noqa: F401
from pase_tpu_torch.precision import full_precision
from pase_tpu_torch.parallel.sp import time_shard_halo
from pase_tpu_torch.streaming import StreamingEncoder

FORMAT = "pase_tpu_torch.serving/1"
STREAMING_FORMAT = "pase_tpu_torch.serving.streaming/1"
# torch.export specializes a dimension of size 0 or 1, and on the card
# cuDNN's memory-format checks treat a batch of 1 apart: the programs take
# batches of 2 to 65535 (cuDNN's eval BatchNorm limit), and the loaders run
# a single utterance as a batch of 2 with a zero row
MIN_BATCH, MAX_BATCH = 2, 65535


def _batch_dim():
    return Dim("batch", min=MIN_BATCH, max=MAX_BATCH)


def _pad_rows(x, rows):
    """x [B, ...] with zero rows appended up to ``rows``."""
    if x.shape[0] >= rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + x.shape[1:])])

__all__ = ["export_encoder", "ServingEncoder", "export_streaming_encoder",
           "ServingStreamingEncoder", "time_shard_halo"]


def _input_table(module):
    """[(program input name, npz key, permutation or None)] of the encoder's
    weights, in program order: every state-dict entry but
    ``num_batches_tracked``, keyed by the JAX variables layout."""
    table = []
    for name, t in module.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        (key, _), = state_dict_to_variables({name: t}).items()
        perm = None
        if key.endswith("/kernel"):
            perm = [2, 1, 0] if t.dim() == 3 else [1, 0]
        table.append((name, key, perm))
    return table


def _save_params(module, out_dir, weights_dtype):
    """params.npz in the JAX variables layout; bf16 weights are stored as
    their float32 values (npz has no bf16; the round trip is exact)."""
    sd = {k: v for k, v in module.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    if weights_dtype is not None:
        wd = getattr(torch, weights_dtype)
        sd = {k: v.to(wd).float() if v.is_floating_point() else v
              for k, v in sd.items()}
    save_variables(os.path.join(out_dir, "params.npz"),
                   state_dict_to_variables(sd))


def load_params(export_dir, meta, device):
    """The program inputs {name: tensor on device} from params.npz,
    re-cast to the artifact's weights dtype. numpy and torch only."""
    wd = meta.get("weights_dtype")
    with np.load(os.path.join(export_dir, "params.npz")) as data:
        out = {}
        for name, key, perm in meta["inputs"]:
            arr = data[key]
            if perm is not None:
                arr = np.ascontiguousarray(np.transpose(arr, perm))
            t = torch.from_numpy(arr).to(device)
            if wd is not None and t.is_floating_point():
                t = t.to(getattr(torch, wd))
            out[name] = t
    return out


class _Bound(nn.Module):
    """``fn`` with its weights passed in: ``forward(params, *args)`` runs
    ``fn(*args)`` with ``params`` in place of fn's parameters and running
    statistics. fn is not a registered child, so an exported program holds
    none of its weights (only the small constants the call leaves in
    place: the SincConv's time axes)."""

    def __init__(self, fn, prefix="", upcast=False):
        super().__init__()
        self.__dict__["fn"] = fn
        self.prefix = prefix
        self.upcast = upcast

    def forward(self, params, *args):
        if self.upcast:
            params = {k: v.float() if v.is_floating_point() else v
                      for k, v in params.items()}
        params = {self.prefix + k: v for k, v in params.items()}
        return torch.func.functional_call(self.fn, params, args,
                                          strict=False)


def _example_params(module, table, weights_dtype):
    sd = module.state_dict()
    wd = None if weights_dtype is None else getattr(torch, weights_dtype)
    return {name: (sd[name].detach().to(wd) if wd is not None
                   and sd[name].is_floating_point() else sd[name].detach())
            for name, _, _ in table}


def _device_of(module):
    return next(module.parameters()).device


def _halo(module):
    """``time_shard_halo`` of a WaveFe trunk; None for another family
    (its receptive extent is not derived here), so that the loader routes
    every request to the largest bucket, which is exact."""
    from pase_tpu_torch.frontend import WaveFe
    return int(time_shard_halo(module)) if isinstance(module, WaveFe) \
        else None


def export_encoder(enc, out_dir, chunk_sizes=(8000, 16000, 32000, 64000),
                   weights_dtype=None):
    """Export an ``Encoder`` (``wf_builder``; eval) as a serving artifact,
    traced on the encoder's device, which the artifact then serves.

    Args:
      enc: ``pase_tpu_torch.frontend.Encoder`` (or an encoder module in
        eval: WaveFe or a family of ``encoders.py``).
      chunk_sizes: the static time buckets (samples, multiples of the
        module's ``hop``: 160 for PASE+ and TDNN, 40 for the ResNet);
        each becomes one program with a symbolic batch.
      weights_dtype: None, or e.g. "bfloat16": the program takes its
        weights in that type and computes in float32 (they are stored as
        float32 values and re-cast at load).
    Returns ``out_dir``.
    """
    module = getattr(enc, "module", enc)
    device = _device_of(module)
    full_precision()
    table = _input_table(module)
    hop = int(module.hop)
    os.makedirs(out_dir, exist_ok=True)
    _save_params(module, out_dir, weights_dtype)
    params = _example_params(module, table, weights_dtype)
    fwd = _Bound(module, upcast=weights_dtype is not None)
    batch = _batch_dim()
    buckets = sorted(int(t) for t in chunk_sizes)
    seconds = {}
    for T in buckets:
        if T % hop:
            raise ValueError(f"bucket {T} must be a multiple of the hop "
                             f"{hop}")
        wav = torch.zeros((MIN_BATCH, T), device=device)
        t0 = time.perf_counter()
        with torch.no_grad():
            prog = export(fwd, (params, wav), strict=False,
                          dynamic_shapes=({k: None for k in params},
                                          ({0: batch},)))
        torch.export.save(prog, os.path.join(out_dir, f"encoder_T{T}.pt2"))
        seconds[str(T)] = time.perf_counter() - t0
    meta = {
        "format": FORMAT,
        "buckets": buckets,
        "hop": hop,
        "halo": _halo(module),
        "emb_dim": int(module.output_dim),
        "sr": 16000,
        "device": device.type,
        "precision": "float32, TF32 off",
        "weights_dtype": weights_dtype,
        "torch_version": torch.__version__,
        "inputs": table,
        "export_seconds": seconds,
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


def _load_program(path, from_device, device):
    prog = torch.export.load(path)
    if torch.device(device).type != from_device:
        prog = move_to_device_pass(prog, torch.device(device))
    return prog.module()


class ServingEncoder:
    """Load an ``export_encoder`` artifact and encode audio of any length.

    ``encode(wav)`` takes [T] or [B, T] float32 and returns [emb, F] or
    [B, emb, F] at 100 Hz, the frames of ``forward-chunk`` with
    ``--chunk_size`` the largest bucket. ``device`` defaults to the one
    the artifact was exported on.
    """

    def __init__(self, export_dir, device=None):
        with open(os.path.join(export_dir, "meta.json")) as f:
            self.meta = json.load(f)
        if self.meta.get("format") != FORMAT:
            raise ValueError(f"not a pase_tpu_torch serving artifact: "
                             f"{export_dir}")
        full_precision()
        self.device = torch.device(device or self.meta["device"])
        self.params = load_params(export_dir, self.meta, self.device)
        self.buckets = list(self.meta["buckets"])
        self.hop = int(self.meta["hop"])
        self.halo = self.meta.get("halo")
        self._fns = {T: _load_program(
            os.path.join(export_dir, f"encoder_T{T}.pt2"),
            self.meta["device"], self.device) for T in self.buckets}

    def _call(self, bucket, stack):
        """[B, bucket] numpy -> [B, bucket // hop, emb] numpy."""
        x = torch.from_numpy(np.ascontiguousarray(stack)).to(self.device)
        with torch.no_grad():
            y = self._fns[bucket](self.params, _pad_rows(x, MIN_BATCH))
        return y[:len(stack)].cpu().numpy()

    def _bucket_for(self, T):
        """The smallest bucket whose zero-padded tail holds every kept
        frame's receptive field (so the frames equal those of the largest
        bucket); the largest bucket when none does."""
        need = T if T == self.buckets[-1] else T + (
            self.halo if self.halo is not None else self.buckets[-1])
        return next((b for b in self.buckets if b >= need),
                    self.buckets[-1])

    def _run(self, wav):
        """[B, T <= largest bucket] -> [B, T // hop, emb]."""
        T = wav.shape[1]
        bucket = self._bucket_for(T)
        if T > bucket:
            raise ValueError(f"window {T} exceeds the largest bucket "
                             f"{self.buckets[-1]}")
        if T < bucket:
            wav = np.pad(wav, ((0, 0), (0, bucket - T)))
        return self._call(bucket, wav)[:, :T // self.hop]

    def encode(self, wav):
        wav = np.asarray(wav, np.float32)
        squeeze = wav.ndim == 1
        if squeeze:
            wav = wav[None]
        if wav.ndim != 2 or wav.shape[1] < self.hop:
            raise ValueError(f"expected [T] or [B, T] with T >= "
                             f"{self.hop}, got {wav.shape}")
        big = self.buckets[-1]
        y = np.concatenate([self._run(wav[:, beg:beg + big])
                            for beg in range(0, wav.shape[1], big)], axis=1)
        y = np.transpose(y, (0, 2, 1))             # [B, emb, F]
        return y[0] if squeeze else y

    def encode_batch(self, wavs):
        """Encode a list of [T_i] wavs, batching the utterances of one
        bucket through one call (the symbolic batch). Each output equals
        ``encode(wav)``; wavs longer than the largest bucket take the
        windowed single path. Returns [emb, F_i] arrays in input order."""
        wavs = [np.asarray(w, np.float32) for w in wavs]
        outs = [None] * len(wavs)
        groups = {}
        for i, w in enumerate(wavs):
            if w.ndim != 1 or len(w) < self.hop:
                raise ValueError(f"wav {i}: expected [T >= {self.hop}]")
            if len(w) > self.buckets[-1]:
                outs[i] = self.encode(w)
            else:
                groups.setdefault(self._bucket_for(len(w)), []).append(i)
        for bucket, idxs in groups.items():
            y = self._call(bucket, np.stack(
                [np.pad(wavs[i], (0, bucket - len(wavs[i]))) for i in idxs]))
            for row, i in enumerate(idxs):
                outs[i] = np.transpose(y[row, :len(wavs[i]) // self.hop])
        return outs


# ---------------------------------------------------------------------------
# the streaming artifact
# ---------------------------------------------------------------------------

def _drop_started(st):
    """The state without the host-side 'started' flags: an exported state
    is post-prime, where every flag is True."""
    if isinstance(st, dict):
        return {k: _drop_started(v) for k, v in st.items()
                if k != "started"}
    if isinstance(st, list):
        return [_drop_started(v) for v in st]
    return st


class _StreamCall(nn.Module):
    """One call of the stream as a pure function of (state, wav): prime
    (a fresh stream, one push), step (restore, one push) or flush
    (restore, flush). The state is a flat list of tensors; ``spec`` is its
    structure (from a dry run). Returns (state, frames) or frames."""

    def __init__(self, fe, mode, spec=None):
        super().__init__()
        self.fe = fe
        self.mode = mode
        self.spec = spec

    def forward(self, *args):
        st = StreamingEncoder(self.fe)
        if self.mode != "prime":
            st.set_state(pytree.tree_unflatten(list(args[0]), self.spec))
        like = args[0][0] if self.mode == "flush" else args[-1]
        y = st.flush() if self.mode == "flush" else st.push(like)
        if y is None:
            y = like.new_zeros((like.shape[0], self.fe.output_dim, 0))
        if self.mode == "flush":
            return y
        leaves, spec = pytree.tree_flatten(_drop_started(st.get_state()))
        self.last_spec = spec
        return leaves, y


def _signature(leaves):
    return [None if t is None else (tuple(t.shape[1:]), t.dtype)
            for t in leaves]


def export_streaming_encoder(enc, out_dir, chunk=16000, weights_dtype=None):
    """Export the exact online encoder as prime / step / flush programs on
    the encoder's device, with the stream's state as an explicit flat list
    of tensors (batch first, symbolic):

      * ``prime(params, wav[b, chunk]) -> (state, frames)``: the first
        chunk, which makes the left pads and fills the FIFOs;
      * ``step(params, state, wav[b, chunk]) -> (state, frames)``: every
        later chunk;
      * ``flush(params, state) -> frames``: the right pads and the FIFOs'
        rest.

    ``chunk`` must be a multiple of the hop and large enough that one push
    reaches the steady state: a dry run on the device checks that the state
    out of prime is a fixed point of step (same structure and shapes) and
    that step emits frames, and raises otherwise. The batch must stay the
    same over a stream (the state carries it). Returns ``out_dir``.
    """
    module = getattr(enc, "module", enc)
    device = _device_of(module)
    full_precision()
    table = _input_table(module)
    hop = StreamingEncoder(module).hop
    if chunk % hop:
        raise ValueError(f"streaming chunk {chunk} must be a multiple of "
                         f"the hop {hop}")
    params = _example_params(module, table, weights_dtype)
    upcast = weights_dtype is not None

    def bound(mode, spec=None):
        return _Bound(_StreamCall(module, mode, spec), prefix="fe.",
                      upcast=upcast)

    # dry run: prime, then one step from prime's state
    wav = torch.zeros((MIN_BATCH, chunk), device=device)
    with torch.no_grad():
        prime = bound("prime")
        st0, y0 = prime(params, wav)
        spec = prime.fn.last_spec
        step = bound("step", spec)
        st1, y1 = step(params, st0, wav)
        spec1 = step.fn.last_spec
        y_flush = bound("flush", spec)(params, st1)
    if spec1 != spec or _signature(st0) != _signature(st1) \
            or None in _signature(st0) or y1.shape[2] == 0:
        raise ValueError(
            f"streaming chunk {chunk} is too small to reach the steady "
            "state in one push (a layer FIFO is still filling); use a "
            "larger chunk")

    os.makedirs(out_dir, exist_ok=True)
    _save_params(module, out_dir, weights_dtype)
    batch = _batch_dim()
    pshape = {k: None for k in params}
    sshape = [{0: batch} for _ in st0]
    seconds = {}
    with torch.no_grad():
        for name, fn, args, shapes in (
                ("prime", bound("prime"), (params, wav),
                 (pshape, ({0: batch},))),
                ("step", bound("step", spec), (params, st0, wav),
                 (pshape, (sshape, {0: batch}))),
                ("flush", bound("flush", spec), (params, st0),
                 (pshape, (sshape,)))):
            t0 = time.perf_counter()
            prog = export(fn, args, strict=False, dynamic_shapes=shapes)
            torch.export.save(prog, os.path.join(
                out_dir, f"streaming_{name}_C{chunk}.pt2"))
            seconds[name] = time.perf_counter() - t0
    meta = {
        "format": STREAMING_FORMAT,
        "chunk": int(chunk),
        "hop": hop,
        "emb_dim": int(module.output_dim),
        "sr": 16000,
        "device": device.type,
        "precision": "float32, TF32 off",
        "weights_dtype": weights_dtype,
        "torch_version": torch.__version__,
        "inputs": table,
        "state_tensors": len(st0),
        "prime_frames": int(y0.shape[2]),
        "step_frames": int(y1.shape[2]),
        "flush_frames": int(y_flush.shape[2]),
        "export_seconds": seconds,
    }
    with open(os.path.join(out_dir, "meta_streaming.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


class ServingStreamingEncoder:
    """Drive an ``export_streaming_encoder`` artifact: a stateful online
    encoder with no model code.

    ``push(wav)`` takes exactly ``chunk`` samples ([chunk] or [B, chunk];
    B stays the same over a stream) and returns the new frames as
    [B, emb, m] numpy; ``flush()`` returns the last frames and ends the
    stream; ``reset()`` starts a new one. The emissions of prime, the steps
    and flush are those of the in-process ``StreamingEncoder`` fed the same
    chunks.
    """

    def __init__(self, export_dir, device=None):
        with open(os.path.join(export_dir, "meta_streaming.json")) as f:
            self.meta = json.load(f)
        if self.meta.get("format") != STREAMING_FORMAT:
            raise ValueError(f"not a pase_tpu_torch streaming serving "
                             f"artifact: {export_dir}")
        full_precision()
        self.chunk = int(self.meta["chunk"])
        self.device = torch.device(device or self.meta["device"])
        self.params = load_params(export_dir, self.meta, self.device)
        self._fns = {name: _load_program(
            os.path.join(export_dir, f"streaming_{name}_C{self.chunk}.pt2"),
            self.meta["device"], self.device)
            for name in ("prime", "step", "flush")}
        self.reset()

    def reset(self):
        self._state = None
        self._done = False

    def push(self, wav):
        if self._done:
            raise RuntimeError("stream flushed; call reset() first")
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 1:
            wav = wav[None]
        if wav.ndim != 2 or wav.shape[1] != self.chunk:
            raise ValueError(f"push wants [B, {self.chunk}] or "
                             f"[{self.chunk}], got {wav.shape}")
        x = torch.from_numpy(np.ascontiguousarray(wav)).to(self.device)
        with torch.no_grad():
            if self._state is None:
                self._rows = len(wav)
                self._state, y = self._fns["prime"](
                    self.params, _pad_rows(x, MIN_BATCH))
            else:
                if len(wav) != self._rows:
                    raise ValueError(f"the stream's batch is {self._rows}, "
                                     f"got {len(wav)}")
                self._state, y = self._fns["step"](
                    self.params, self._state, _pad_rows(x, MIN_BATCH))
        return y[:self._rows].cpu().numpy()

    def flush(self):
        if self._state is None:
            raise RuntimeError("nothing pushed yet")
        self._done = True
        with torch.no_grad():
            y = self._fns["flush"](self.params, self._state)
        return y[:self._rows].cpu().numpy()
