"""Time-sharded (sequence-parallel) WaveFe encoder forward: the port of
``pase_tpu/parallel/sp.py``.

The PASE trunk is convolutions with a bounded receptive field plus one
first-order linear recurrence per QRNN layer, so a long utterance can be
encoded with its time axis split into D shards, each on a device of its
own (one controller over a list of devices, as the JAX package's mesh is
one controller; a device may repeat, so one card or the CPU can hold
every shard):

* shard s gets a window of E = T / D + 2 H samples (H =
  ``time_shard_halo``), placed with clamping so the first and last
  windows end at the utterance's edges (their reflect pads then are the
  offline encoder's); windows start on multiples of the stride product R,
  so the frame grids align; a single shard's window is the utterance;
* the trunk and the dense-skip taps run on the window, then the shard's
  T / (D R) kept frames are taken out;
* each QRNN layer's recurrence c_t = a_t c_{t-1} + b_t crosses the shards
  in two passes through the port's kernels: pass 1 gives the totals of
  each shard but the last, B_s the last state of the unseeded scan (K1,
  or K2's forward under a gradient) and A_s = prod_t a_t in float32; the
  exclusive prefix c_in of the shards' maps is composed on the first
  device; pass 2 is the scan seeded with c_in (K1's seeded route in
  eval, ``QRNNPool`` with c0 under a gradient, whose backward gives
  dc0). Shard 0's c_in is 0. A
  deeper layer's x_{t-1} at a shard's first frame is the previous shard's
  last kept frame;
* W, the dense skips, ``norm_out`` (eval BatchNorm), tanh and the VQ
  quantizer (eval, straight-through) are frame-local.

The result equals the offline forward up to float reassociation, and
``time_sharded_apply`` is differentiable (the parameters reach each
shard's device through differentiable copies). Refused, as in JAX: an
encoder that is not a WaveFe, a GRU / LSTM context layer, InstanceNorm
(per block or as norm_out: it normalizes over the whole utterance), even
resblock kwidths, T not a multiple of D R, and an utterance too short for
the windows.
"""

import torch
from torch.func import functional_call

from pase_tpu_torch.frontend import WaveFe, fuse_skip, pool_to
from pase_tpu_torch.nn import (BiRNN, FeResBlock, InstanceNorm1d,
                               qrnn_linear)
from pase_tpu_torch.ops import cuda_qrnn
from pase_tpu_torch.ops.qrnn import shift_right
from pase_tpu_torch.streaming import block_geometry

__all__ = ["encode_time_sharded", "time_sharded_apply", "time_shard_halo"]


def time_shard_halo(module):
    """The trunk's receptive extent in samples, rounded up to the stride
    product R, plus one R of slack for the asymmetric SAME pads: an
    FeBlock adds (kw - 1) * dilation at its input's rate; an FeResBlock
    decimates first, then adds (kw - 1) * (d1 + d2) at its output's rate
    (an even kwidth would grow the length: ValueError)."""
    ext, cum = 0, 1
    for blk in module.blocks:
        kw, st, dil, _ = block_geometry(blk)
        if isinstance(blk, FeResBlock):
            if kw % 2 == 0:
                raise ValueError("even resblock kwidths grow the sequence "
                                 "length; no time-sharded form")
            cum *= st
            ext += (kw - 1) * sum(dil) * cum
        else:
            ext += (kw - 1) * dil * cum
            cum *= st
    return ((ext + cum - 1) // cum + 1) * cum


def encode_time_sharded(encoder, wav, devices):
    """The encoder's forward with the time axis over ``devices`` (D of
    them), no gradient.

    encoder: an ``Encoder`` (``wf_builder``) or a WaveFe; wav: [B, T]
    (numpy or a tensor), T a multiple of D * R. Returns [B, T // R, emb]
    (NTC) on the first device, equal to the offline forward in eval
    mode."""
    module = getattr(encoder, "module", encoder)
    with torch.no_grad():
        return time_sharded_apply(module, wav, devices)


def _check(module, D, T):
    if not isinstance(module, WaveFe):
        raise TypeError("encode_time_sharded supports the WaveFe trunk "
                        f"(got {type(module).__name__})")
    if isinstance(module.rnn, BiRNN):
        raise NotImplementedError(
            f"time-sharded rnn_type={module.rnn.mode.lower()!r} not "
            "implemented")
    if isinstance(module.norm_out, InstanceNorm1d):
        raise NotImplementedError(
            "InstanceNorm norm_out normalizes over the whole utterance; "
            "no exact time-sharded form")
    for blk in module.blocks:
        norms = ((blk.norm1, blk.norm2) if isinstance(blk, FeResBlock)
                 else (blk.norm,))
        if any(isinstance(n, InstanceNorm1d) for n in norms):
            raise NotImplementedError(
                "per-block InstanceNorm normalizes over the whole time "
                "axis; no exact time-sharded form (bnorm/lnorm/snorm/wnorm "
                "are time-local and supported)")
    R = module.hop
    if T % (D * R):
        raise ValueError(f"T={T} must divide by D*R={D * R}")
    H = time_shard_halo(module)
    if D > 1 and T // D + 2 * H > T:
        raise ValueError(
            f"utterance too short to time-shard: need T >= T/D + 2*{H} "
            f"(got T={T}, D={D}); use the offline encoder")
    return R, H


def _qrnn_across(ys, devices):
    """Each shard's gated frames ys[s] [B, F, 3H] -> its hidden [B, F, H],
    the recurrence carried across the shards (pass 1, prefix, pass 2)."""
    hid = ys[0].shape[-1] // 3
    c_in = [ys[0].new_zeros((ys[0].shape[0], hid))]
    for y in ys[:-1]:                 # the last shard's totals feed nothing
        _, b_s = cuda_qrnn.qrnn_pool(y)
        a_s = torch.prod(1.0 - torch.sigmoid(y[..., hid:2 * hid]), dim=1)
        c_in.append(a_s.to(devices[0]) * c_in[-1] + b_s.to(devices[0]))
    return [cuda_qrnn.qrnn_pool(y, c.to(y.device).contiguous())[0]
            for y, c in zip(ys, c_in)]


def time_sharded_apply(module, wav, devices):
    """``encode_time_sharded`` as a differentiable function of the
    module's parameters (and of wav): [B, T] -> [B, T // R, emb] on
    ``devices[0]``. The module runs in eval mode (restored after)."""
    devices = [torch.device(d) for d in devices]
    D = len(devices)
    wav = torch.as_tensor(wav, dtype=torch.float32)
    T = wav.shape[1]
    R, H = _check(module, D, T)
    Tl = T // D
    E = T if D == 1 else Tl + 2 * H       # one shard: the whole utterance
    Fl, Fe = Tl // R, E // R
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    on_dev = {}

    def params(name, dev):
        """The tensors of submodule ``name`` on ``dev`` (a differentiable
        copy where the device differs), keyed within it."""
        if dev not in on_dev:
            on_dev[dev] = {k: v.to(dev) for k, v in tensors.items()}
        pre = name + "."
        return {k[len(pre):]: v for k, v in on_dev[dev].items()
                if k.startswith(pre)}

    def call(name, dev, *args):
        return functional_call(module.get_submodule(name),
                               params(name, dev), args)

    was_training = module.training
    module.eval()
    try:
        hs, taps, offs = [], [], []
        for s, dev in enumerate(devices):
            start = min(max(s * Tl - H, 0), T - E)
            h = wav[:, start:start + E].to(dev)[:, None, :]
            shard_taps = []
            for i in range(len(module.blocks)):
                h = call(f"blocks.{i}", dev, h)
                if i < len(module.denseskips):
                    shard_taps.append(h)
            hs.append(h)
            taps.append(shard_taps)
            offs.append((s * Tl - start) // R)

        def kept(x, s):
            return x[:, :, offs[s]:offs[s] + Fl]

        if module.rnn is not None:
            prev = None
            for li in range(len(module.rnn.layers)):
                ys = []
                for s, dev in enumerate(devices):
                    if li == 0:
                        # the first layer's x_{t-1} comes from the window
                        x = hs[s].transpose(1, 2)
                        src = torch.cat([x, shift_right(x, dim=1)], dim=-1)
                        src = src[:, offs[s]:offs[s] + Fl]
                    else:
                        x = hs[s]
                        first = (torch.zeros_like(x[:, :1]) if s == 0 else
                                 prev[s - 1][:, -1:].to(dev))
                        src = torch.cat([x, torch.cat([first, x[:, :-1]],
                                                      dim=1)], dim=-1)
                    lin = params(f"rnn.layers.{li}.linear", dev)
                    ys.append(qrnn_linear(src, lin["weight"],
                                          lin["bias"]).contiguous())
                hs = _qrnn_across(ys, devices)
                prev = hs
            hs = [h.transpose(1, 2) for h in hs]
        else:
            hs = [kept(h, s) for s, h in enumerate(hs)]
        out = []
        for s, dev in enumerate(devices):
            y = call("W", dev, hs[s])
            for i, tap in enumerate(taps[s]):
                proj = call(f"denseskips.{i}", dev, kept(pool_to(tap, Fe), s))
                y = fuse_skip(y, proj, module.densemerge)
            if module.norm_out is not None:
                y = call("norm_out", dev, y)
            if module.tanh_out:
                y = torch.tanh(y)
            y = y.transpose(1, 2)
            if module.quantizer is not None:
                y = call("quantizer", dev, y)
            out.append(y.to(devices[0]))
        return torch.cat(out, dim=1)
    finally:
        module.train(was_training)
