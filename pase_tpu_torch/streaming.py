"""Streaming (stateful, chunk-by-chunk) encoder inference, in PyTorch.

The port of ``pase_tpu/streaming.py``: the exact online form of the WaveFe
encoder. Feeding an utterance in chunks of any sizes gives the frames of
one offline forward of the whole utterance, with the trunk's right pads
(about 74 ms at 16 kHz for PASE+) as the only lookahead.

Per conv block (``_ConvStream``): the left reflect pad is made from the
stream's first frames once ``l + 1`` of them have arrived; a FIFO keeps the
``K_eff - stride`` frames of the next VALID window's overlap, and enough to
reflect the ``r`` right-pad frames at ``flush``. The blocks run without
their own pad (``FeBlock.forward(x, do_pad=False)``). Dense skips are
mean-pooled to the output rate by per-skip FIFOs (``_GroupStream``), then
projected, and a fuse synchronizer emits the frames that every skip and
the trunk have reached. The QRNN carries (x_{t-1}, c_t) per layer across
chunks (``_QRNNStream``); BatchNorm (eval statistics), LayerNorm (per
frame), PReLU, glu, ``W``, ``norm_out`` and tanh are stateless. A
spectral- or weight-normalized conv runs its eval-form kernel (SN's u is
not advanced in eval mode), the same kernel at every push.

The QRNN's first push is seeded with a zero carry. So every call of the
pooling is seeded and takes a serial kernel (``qrnn_pool_fwd_seg``, or
``qrnn_pool_fwd`` on ``cuda_qrnn.SEG_LANES`` lanes or more: the same
bits), whose block-streamed evaluation equals one full run bit for bit;
an unseeded first push on few lanes would take the chunked kernel, which
rounds otherwise. The offline encoder takes the chunked kernel there, so
streamed and offline frames differ at float32 rounding level (the JAX
contract is rtol 1e-3 / atol 2e-4, ``tests/test_streaming.py``).

The reference quirk of the JAX package holds here too: the offline
``fuse_skip`` takes its pooling factor from the realized ratio
``skip_len // y_len``. Where that ratio deviates from the stride product
(T=31991: 31991 // 200 = 159), the offline form pools groups of the
deviant size, which no online form can know in advance; the stream then
emits ``floor(T / 160)`` frames with the canonical factor.

The resblocks trunk streams per FeResBlock (``_ResBlockStream``): the
nearest decimation (a ``_GroupStream`` keeping the first frame of each
complete group), the two stride-1 convs as ``_ConvStream``s in
'constant' (zero) pad mode, the decimated identity (projected in
GEMM_FRAMES calls) in a FIFO, fused with the conv path's frames as both
arrive, then the eval norm2. A VQ quantizer takes each emitted frame's
nearest codebook row (the argmin and the gather, in GEMM_FRAMES calls)
last. InstanceNorm (in a block or as ``norm_out``, which every norm
type but bnorm takes) normalizes over the whole utterance and has no
exact stream, as in JAX; non-QRNN RNNs are not ported yet (ROADMAP.md,
queue 1: off-path model variants).

Usage::

    enc = wf_builder('cfg/frontend/PASE+.cfg')
    enc.load_pretrained('FE_e199.ckpt')
    stream = StreamingEncoder(enc)
    for chunk in chunks:              # [B, n] waveform pieces, any sizes
        y = stream.push(chunk)        # [B, emb, m] (m >= 0) or None
    y = stream.flush()                # remaining frames
"""

import numpy as np
import torch

from pase_tpu_torch.nn import (QRNN, ROADMAP_OFF_SLICE, FeResBlock,
                               InstanceNorm1d, SincConv, time_blocks)
from pase_tpu_torch.ops.pad import pad_1d, sinc_same_pad

# the output-rate GEMMs (the QRNN's linear, W, the skip projections) run in
# calls of this many frames (1.28 s), whatever a push brings
GEMM_FRAMES = 128


def _tcat(a, b):
    """Concatenate two optional [B, C, t] frame packets on time."""
    if a is None or a.shape[2] == 0:
        return b
    if b is None or b.shape[2] == 0:
        return a
    return torch.cat([a, b], dim=2)


class _ConvStream:
    """Streaming state of one pad -> conv block, exact offline semantics.
    Frames are [B, C, t]."""

    def __init__(self, apply_fn, kwidth, stride, dilation, pad, pad_mode):
        self.apply_fn = apply_fn
        self.stride = stride
        self.k_eff = (kwidth - 1) * dilation + 1
        self.l, self.r = pad
        # trailing frames kept: the next VALID window's overlap, and enough
        # signal to reflect the right pad at flush
        self.keep = max(self.k_eff - self.stride, self.r + 1)
        self.pad_mode = pad_mode
        self.buf = None
        self.started = False

    def _emit(self, final):
        if self.buf is None:
            return None
        ln = self.buf.shape[2]
        if final:
            n = (ln - self.k_eff) // self.stride + 1 if ln >= self.k_eff else 0
        else:
            n = max(0, (ln - self.keep) // self.stride)
        if n <= 0:
            return None
        y = self.apply_fn(self.buf[:, :, :(n - 1) * self.stride + self.k_eff])
        self.buf = self.buf[:, :, n * self.stride:]
        return y

    def push(self, x):
        """x: [B, C, t] new input frames -> [B, C', m] outputs or None."""
        if x is None or x.shape[2] == 0:
            return None
        self.buf = _tcat(self.buf, x)
        if not self.started:
            if self.l > 0 and self.buf.shape[2] < self.l + 1:
                return None          # not enough signal to reflect yet
            if self.l > 0:
                self.buf = pad_1d(self.buf, (self.l, 0), self.pad_mode)
            self.started = True
        return self._emit(final=False)

    def flush(self):
        if self.buf is None:
            return None
        if not self.started:
            # a stream shorter than the left pad: pad what arrived, as the
            # offline form does (reflect needs >= 2 frames)
            if self.l > 0:
                self.buf = pad_1d(self.buf, (self.l, 0), self.pad_mode)
            self.started = True
        if self.r > 0:
            self.buf = pad_1d(self.buf, (0, self.r), self.pad_mode)
        return self._emit(final=True)

    def get_state(self):
        return {"buf": self.buf, "started": self.started}

    def set_state(self, st):
        """Restore a snapshot; one without 'started' (an exported state) is
        post-prime by construction."""
        self.buf = st["buf"]
        self.started = bool(st.get("started", True))


class _GroupStream:
    """Reduces each complete group of ``factor`` frames to one frame:
    ``"mean"`` pools (``fuse_skip``'s pooling), ``"first"`` decimates
    (``nn.decimate``). Trailing frames that do not fill a group wait for
    the next push (and at the end are dropped, as the offline forms drop
    them)."""

    def __init__(self, factor, reduce="mean"):
        self.factor = factor
        self.reduce = reduce
        self.buf = None

    def push(self, x):
        if x is None or x.shape[2] == 0:
            return None
        if self.factor == 1:
            return x
        self.buf = _tcat(self.buf, x)
        n = self.buf.shape[2] // self.factor
        if n == 0:
            return None
        b, c, _ = self.buf.shape
        groups = self.buf[:, :, :n * self.factor].reshape(b, c, n,
                                                          self.factor)
        self.buf = self.buf[:, :, n * self.factor:]
        return groups.mean(dim=3) if self.reduce == "mean" else \
            groups[..., 0]

    def get_state(self):
        # factor 1 passes frames through and holds none: no state (an
        # exported state has no empty leaves)
        return {} if self.factor == 1 else {"buf": self.buf}

    def set_state(self, st):
        self.buf = st.get("buf")


class _ResBlockStream:
    """Streaming state of one FeResBlock, exact offline semantics: the
    decimation, the two zero-padded stride-1 convs (``stage1``,
    ``stage2``), the identity FIFO, and norm2 on the frames that both
    paths have reached."""

    def __init__(self, blk):
        self.blk = blk
        (p1, p2), (d1, d2) = blk.pads, blk.dilations
        self.decim = _GroupStream(blk.downsample, "first")
        self.conv1 = _ConvStream(blk.stage1, blk.kwidth, 1, d1, (p1, p1),
                                 "constant")
        self.conv2 = _ConvStream(blk.stage2, blk.kwidth, 1, d2, (p2, p2),
                                 "constant")
        self.id_fifo = None
        self.h_fifo = None

    def _ingest(self, x, flush):
        xd = self.decim.push(x)
        if xd is not None:
            # the 1x1 projection at a fixed call shape, as the output-rate
            # GEMMs
            ident = (xd if self.blk.resproj is None else time_blocks(
                self.blk.identity, xd, GEMM_FRAMES, dim=2))
            self.id_fifo = _tcat(self.id_fifo, ident)
        h1 = self.conv1.push(xd)
        if flush:
            h1 = _tcat(h1, self.conv1.flush())
        h2 = self.conv2.push(h1)
        if flush:
            h2 = _tcat(h2, self.conv2.flush())
        self.h_fifo = _tcat(self.h_fifo, h2)

    def _emit(self):
        if self.h_fifo is None or self.id_fifo is None:
            return None
        m = min(self.h_fifo.shape[2], self.id_fifo.shape[2])
        if m == 0:
            return None
        y = self.blk.finish(self.h_fifo[:, :, :m], self.id_fifo[:, :, :m])
        self.h_fifo = self.h_fifo[:, :, m:]
        self.id_fifo = self.id_fifo[:, :, m:]
        return y

    def push(self, x):
        if x is None or x.shape[2] == 0:
            return None
        self._ingest(x, flush=False)
        return self._emit()

    def flush(self):
        self._ingest(None, flush=True)
        return self._emit()

    def get_state(self):
        return {"decim": self.decim.get_state(),
                "conv1": self.conv1.get_state(),
                "conv2": self.conv2.get_state(),
                "id_fifo": self.id_fifo, "h_fifo": self.h_fifo}

    def set_state(self, st):
        self.decim.set_state(st["decim"])
        self.conv1.set_state(st["conv1"])
        self.conv2.set_state(st["conv2"])
        self.id_fifo = st["id_fifo"]
        self.h_fifo = st["h_fifo"]


class _QRNNStream:
    """Window-2 QRNN with (x_{t-1}, c) carried across chunks; the first
    push is seeded with zeros, so every pooling call is seeded."""

    def __init__(self, rnn):
        self.rnn = rnn
        n = len(rnn.layers)
        self.prev = [None] * n
        self.carry = [None] * n
        self.calls = 0          # pushes that reached the pooling

    def push(self, h):
        """h: [B, C, t] -> [B, H, t] or None."""
        if h is None or h.shape[2] == 0:
            return None
        h = h.transpose(1, 2)                        # NTC
        for i in range(len(self.rnn.layers)):
            prev, carry = self.prev[i], self.carry[i]
            if prev is None:
                prev = torch.zeros_like(h[:, :1])
                carry = h.new_zeros((h.shape[0],
                                     self.rnn.layers[i].linear.out_features
                                     // 3))
            h, self.prev[i], self.carry[i] = self.rnn.layer_step(
                i, h, prev, carry, GEMM_FRAMES)
        self.calls += 1
        return h.transpose(1, 2)

    def get_state(self):
        return {"prev": list(self.prev), "carry": list(self.carry)}

    def set_state(self, st):
        self.prev = list(st["prev"])
        self.carry = list(st["carry"])


def block_geometry(block):
    """(kwidth, stride, dilation, (left, right) pad) of an FeBlock; of an
    FeResBlock (kwidth, the decimation, its two dilations, each conv's
    symmetric zero pad)."""
    if isinstance(block, FeResBlock):
        return block.kwidth, block.downsample, block.dilations, block.pads
    conv = block.conv
    if isinstance(conv, SincConv):
        return (conv.kwidth, conv.stride, 1,
                sinc_same_pad(conv.kwidth, conv.stride))
    return conv.kernel_size[0], conv.stride[0], conv.dilation[0], block.pad


class StreamingEncoder:
    """Exact online form of a WaveFe encoder (see the module docstring).

    ``encoder`` is an ``Encoder`` (``wf_builder``) or a ``WaveFe`` in eval
    mode; its parameters are read at every call, so the stream follows
    them. The output-rate GEMMs (the QRNN's linear, ``W``, the skip
    projections) run in calls of GEMM_FRAMES frames (``nn.time_blocks``),
    so a frame's sums do not depend on how the stream was cut. Accepts chunks as [B, t], [B, 1, t] or [t] (numpy or torch);
    emits [B, emb, m] frame packets (the reference channel-first layout)
    or None when no new frame is computable yet. Call ``flush()`` once at
    the end of the stream.
    """

    def __init__(self, encoder):
        from pase_tpu_torch.frontend import WaveFe
        module = getattr(encoder, "module", encoder)
        if not isinstance(module, WaveFe):
            raise TypeError("StreamingEncoder supports the WaveFe trunk "
                            f"(got {type(module).__name__})")
        if module.training:
            raise ValueError("StreamingEncoder needs the encoder in eval "
                             "mode (BatchNorm's running statistics)")
        # what the JAX stream admits: affinorm FeBlocks without norm_out,
        # each push's frames normalized on their own (not the offline
        # result); refused: inorm, norm_out's InstanceNorm, and
        # InstanceNorm inside resblocks
        inorm = [isinstance(blk.norm, InstanceNorm1d)
                 and blk.norm.weight is None for blk in module.blocks
                 if not isinstance(blk, FeResBlock)]
        if any(inorm) or isinstance(module.norm_out, InstanceNorm1d):
            raise NotImplementedError(
                "InstanceNorm normalizes over the whole utterance and "
                "has no exact streaming form")
        if any(isinstance(n, InstanceNorm1d) for blk in module.blocks
               if isinstance(blk, FeResBlock)
               for n in (blk.norm1, blk.norm2)):
            raise NotImplementedError(
                "InstanceNorm inside resblocks normalizes over the whole "
                "utterance and has no exact streaming form")
        if module.rnn is not None and not isinstance(module.rnn, QRNN):
            raise NotImplementedError(
                f"streaming rnn {type(module.rnn).__name__}: only the QRNN "
                f"streams ({ROADMAP_OFF_SLICE})")
        self.module = module
        self.device = next(module.parameters()).device
        self.conv_streams = []
        strides = []
        for blk in module.blocks:
            kw, st, dil, pad = block_geometry(blk)
            strides.append(st)
            if isinstance(blk, FeResBlock):
                self.conv_streams.append(_ResBlockStream(blk))
                continue
            self.conv_streams.append(_ConvStream(
                lambda x, blk=blk: blk(x, do_pad=False), kw, st, dil, pad,
                blk.pad_mode))
        self.hop = int(np.prod(strides))
        nskips = len(module.denseskips)
        self.skip_pools = [_GroupStream(int(np.prod(strides[i + 1:])))
                           for i in range(nskips)]
        self.skip_fifos = [None] * nskips
        self.qrnn = None if module.rnn is None else _QRNNStream(module.rnn)
        self.y_fifo = None

    @property
    def qrnn_calls(self):
        """Pushes (and the flush) that reached the QRNN: each launches the
        pooling kernel once per QRNN layer."""
        return 0 if self.qrnn is None else self.qrnn.calls

    def _blocks(self, x, flush):
        """Frames through the conv trunk, feeding the skip taps."""
        h = x
        for i, cs in enumerate(self.conv_streams):
            y = cs.push(h)
            if flush:
                y = _tcat(y, cs.flush())
            if i < len(self.skip_pools):
                # pool, then project, as the offline WaveFe does
                pooled = self.skip_pools[i].push(y)
                tap = (None if pooled is None else time_blocks(
                    self.module.denseskips[i], pooled, GEMM_FRAMES, dim=2))
                self.skip_fifos[i] = _tcat(self.skip_fifos[i], tap)
            h = y
            if h is None and not flush:
                return None
        return h

    def _tail(self, h):
        """QRNN + W: frames at the output rate, not yet fused."""
        if h is None or h.shape[2] == 0:
            return None
        if self.qrnn is not None:
            h = self.qrnn.push(h)
        return time_blocks(self.module.W, h, GEMM_FRAMES, dim=2)

    def _fuse(self):
        """Emit the frames that the trunk and every skip have reached."""
        if self.y_fifo is None or self.y_fifo.shape[2] == 0:
            return None
        m = self.y_fifo.shape[2]
        for f in self.skip_fifos:
            m = 0 if f is None else min(m, f.shape[2])
        if m == 0:
            return None
        y = self.y_fifo[:, :, :m]
        self.y_fifo = self.y_fifo[:, :, m:]
        mod = self.module
        for i, f in enumerate(self.skip_fifos):
            y = (torch.cat([y, f[:, :, :m]], dim=1)
                 if mod.densemerge == "concat" else y + f[:, :, :m])
            self.skip_fifos[i] = f[:, :, m:]
        if mod.norm_out is not None:
            y = mod.norm_out(y)
        if mod.tanh_out:
            y = torch.tanh(y)
        if mod.quantizer is not None:
            y = time_blocks(mod.quantizer.quantize, y, GEMM_FRAMES, dim=2)
        return y

    def _step(self, wav, flush):
        with torch.no_grad():
            if wav is not None:
                wav = torch.as_tensor(wav, dtype=torch.float32,
                                      device=self.device)
                if wav.dim() == 1:
                    wav = wav[None]
                if wav.dim() == 2:
                    wav = wav[:, None, :]          # [B, 1, t]
            h = self._blocks(wav, flush)
            self.y_fifo = _tcat(self.y_fifo, self._tail(h))
            return self._fuse()

    def push(self, wav):
        """Feed new waveform samples; returns [B, emb, m] or None."""
        return self._step(wav, flush=False)

    def flush(self):
        """End of the stream; returns the remaining [B, emb, m] or None."""
        return self._step(None, flush=True)

    def get_state(self):
        """Every FIFO and carry (None where a stage holds nothing yet).
        With ``set_state`` the encoder is a pure step function, the basis
        of the exported streaming artifact (``serving.py``)."""
        return {
            "convs": [cs.get_state() for cs in self.conv_streams],
            "skip_pools": [p.get_state() for p in self.skip_pools],
            "skip_fifos": list(self.skip_fifos),
            "qrnn": None if self.qrnn is None else self.qrnn.get_state(),
            "y_fifo": self.y_fifo,
        }

    def set_state(self, st):
        """Restore a ``get_state`` snapshot."""
        for cs, s in zip(self.conv_streams, st["convs"]):
            cs.set_state(s)
        for p, s in zip(self.skip_pools, st["skip_pools"]):
            p.set_state(s)
        self.skip_fifos = list(st["skip_fifos"])
        if self.qrnn is not None:
            self.qrnn.set_state(st["qrnn"])
        self.y_fifo = st["y_fifo"]


def stream_frames(encoder, wav, chunk):
    """[B, emb, F]: ``wav`` ([B, T]) streamed in pieces of ``chunk``
    samples (the last one shorter), the emissions concatenated."""
    st = StreamingEncoder(encoder)
    outs = [st.push(wav[..., beg:beg + chunk])
            for beg in range(0, wav.shape[-1], chunk)] + [st.flush()]
    outs = [y for y in outs if y is not None]
    return torch.cat(outs, dim=2) if outs else None


__all__ = ["StreamingEncoder", "stream_frames"]
