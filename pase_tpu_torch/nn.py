"""Encoder building blocks (torch.nn), NCT layout.

The blocks of ``pase_tpu.nn`` that the PASE+ encoder reaches, with the
reference torch module and parameter names so that a state dict in the
reference layout loads with ``load_state_dict(strict=True)``:

* ``conv1d``      — VALID conv1d under the compute-dtype policy
                    (``precision.py``).
* ``Conv1D``      — torch Conv1d with the torch-default uniform init drawn
                    from a ``torch.Generator``, through ``conv1d``.
* ``SincConv``    — SincNet band-pass layer: filters synthesized every
                    forward, one plain conv1d on the reflect-padded input.
* ``FeBlock``     — pad(reflect) -> conv/sinc -> BatchNorm -> PReLU (init 0).
* ``FeResBlock``  — residual block of the resblocks trunk: nearest
                    decimation, two zero-padded stride-1 convs (dilations
                    1, 2) with BatchNorm / PReLU, plus the (1x1-projected)
                    identity, then BatchNorm.
* ``VQEMA``       — the VQ-VAE quantizer with EMA codebook updates; its
                    codebook and EMA state are buffers.
* ``BatchNorm1d`` / ``PReLU`` — torch's, with the policy's cast points.
* ``QRNN``        — window-2 quasi-recurrent layer: Linear over
                    [x_t, x_{t-1}], then the CUDA pooling kernels
                    (ops/cuda_qrnn.py; an autograd Function with the
                    backward kernel when training) on CUDA tensors, the
                    plain versions on CPU tensors.
* ``MLPBlock``    — worker-head block: 1x1 (/context) conv -> PReLU (init
                    0.25) -> dropout.
* ``Deconv1D`` / ``GDeconv1DBlock`` — transposed-conv upsampling block of
                    the waveform decoder: ConvTranspose1d -> (trim) ->
                    PReLU (init 0).

BatchNorm is torch's BatchNorm1d: in train mode it normalizes with the
biased batch variance and updates the running stats with the unbiased one
at momentum 0.1, as ``pase_tpu/nn.py`` BatchNorm1d does (which takes the
variance in one pass, E[x^2] - E[x]^2; torch in two: equal to rounding).

Under a bfloat16 compute policy (``precision.compute_dtype``) the blocks
mirror the JAX package's cast points: a conv casts a float32 x to bf16 and
its kernel to x's type, and its output stays bf16; a bias (float32) added
to it promotes the sum to float32, as JAX's type promotion does, so a
Conv1D with a bias hands on float32 and the SincConv, the bias-free skip
projections and the decoder's transposed convs (bias cast to bf16) hand
on bf16. BatchNorm takes its statistics of a bf16 x in float32 in one
pass and normalizes in bf16; PReLU casts its slope to x's type; the QRNN's
linear runs in bf16 and its output goes to the pooling kernels as
float32.

Parameters are created on the CPU and drawn from the generator passed in;
the owner moves the finished module to its device.
"""

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from pase_tpu_torch.ops import cuda_qrnn
from pase_tpu_torch.ops.pad import feblock_pad, pad_1d, sinc_same_pad
from pase_tpu_torch.ops.qrnn import shift_right
from pase_tpu_torch.ops.sinc import (build_sinc_filters, mel_init_hz,
                                     sinc_time_axes)
from pase_tpu_torch.precision import get_compute_dtype

ROADMAP_OFF_SLICE = "ROADMAP.md, queue 1: off-path model variants"


def _uniform_(tensor, bound, generator):
    with torch.no_grad():
        tensor.uniform_(-bound, bound, generator=generator)


def conv1d(x, weight, bias=None, stride=1, dilation=1):
    """VALID conv1d of [B, Cin, T] with weight [Cout, Cin, K] (+ bias).

    Under a compute dtype a float32 x is cast to it and the weight to x's
    type; the conv's output stays in that type (float32 sums inside) and
    the float32 bias, added after, promotes the sum to float32
    (``pase_tpu/nn.py`` conv1d and Conv1D)."""
    cd = get_compute_dtype()
    if cd is not None and x.dtype == torch.float32:
        x = x.to(cd)
    if x.dtype == weight.dtype:
        return F.conv1d(x, weight, bias, stride, dilation=dilation)
    y = _low_precision(F.conv1d, x, weight.to(x.dtype), None, stride,
                       dilation=dilation)
    return y if bias is None else y + bias[:, None]


def _low_precision(conv, x, w, *args, **kwargs):
    """conv(x, w, ...) of two low-precision tensors, output in their type.
    On the CPU it is taken of float32 copies (the same products, float32
    sums) and rounded once: torch's bf16 CPU conv is wrong at some
    strided shapes (stride 10, kernel 20 over 4819 samples)."""
    if x.device.type == "cpu":
        return conv(x.float(), w.float(), *args, **kwargs).to(x.dtype)
    return conv(x, w, *args, **kwargs)


class Conv1D(nn.Conv1d):
    """Conv1d (VALID) with torch-default uniform(+-1/sqrt(Cin*K)) init for
    weight and bias, drawn from ``generator``; runs ``conv1d``."""

    def __init__(self, in_channels, out_channels, kwidth, stride=1,
                 dilation=1, bias=True, generator=None):
        super().__init__(in_channels, out_channels, kwidth, stride=stride,
                         dilation=dilation, bias=bias)
        bound = 1.0 / math.sqrt(in_channels * kwidth)
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x):
        return conv1d(x, self.weight, self.bias, self.stride[0],
                      self.dilation[0])


class BatchNorm1d(nn.BatchNorm1d):
    """torch's BatchNorm1d for a float32 x. For a bf16 x (under the
    compute-dtype policy) the JAX package's: batch statistics in float32
    in one pass, var = E[x^2] - E[x]^2, the running stats updated in
    float32 with the unbiased variance, then (x - mean) * rsqrt(var + eps)
    and the affine in x's type, mean, inv, weight and bias cast to it."""

    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        if self.training:
            xf = x.float()
            mean = xf.mean(dim=(0, 2))
            var = torch.clamp((xf * xf).mean(dim=(0, 2)) - mean * mean,
                              min=0.0)
            n = x.shape[0] * x.shape[2]
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(
                    m * var * (n / max(n - 1, 1)))
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var

        def col(v):
            return v.to(x.dtype)[:, None]

        y = (x - col(mean)) * col(torch.rsqrt(var + self.eps))
        if self.affine:
            y = y * col(self.weight) + col(self.bias)
        return y


class PReLU(nn.PReLU):
    """torch's PReLU with its slope cast to x's type."""

    def forward(self, x):
        return F.prelu(x, self.weight.to(x.dtype))


class SincConv(nn.Module):
    """SincNet band-pass conv layer on a single-channel [B, 1, T] input."""

    def __init__(self, features, kwidth, stride=1, sample_rate=16000,
                 pad_mode="reflect", min_low_hz=50.0, min_band_hz=50.0):
        super().__init__()
        self.kwidth = kwidth + 1 if kwidth % 2 == 0 else kwidth
        self.stride = stride
        self.sample_rate = sample_rate
        self.pad_mode = pad_mode
        self.min_low_hz = min_low_hz
        self.min_band_hz = min_band_hz
        low, band = mel_init_hz(features, sample_rate, min_low_hz, min_band_hz)
        self.low_hz_ = nn.Parameter(torch.from_numpy(low))
        self.band_hz_ = nn.Parameter(torch.from_numpy(band))
        n_, window_ = sinc_time_axes(self.kwidth, sample_rate)
        # static synthesis axes: buffers (move with the module), not state
        self.register_buffer("n_", torch.from_numpy(n_), persistent=False)
        self.register_buffer("window_", torch.from_numpy(window_),
                             persistent=False)

    def filters(self):
        """The [C, K] filterbank of the current parameters."""
        return build_sinc_filters(self.low_hz_, self.band_hz_, self.n_,
                                  self.window_, self.sample_rate,
                                  self.min_low_hz, self.min_band_hz)

    def forward(self, x, do_pad=True):
        """SAME conv of the reflect-padded x; ``do_pad=False`` runs it VALID
        on frames whose context the caller supplies (the streaming
        encoder)."""
        if x.shape[1] != 1:
            raise ValueError("SincConv only supports one input channel")
        if do_pad:
            x = pad_1d(x, sinc_same_pad(self.kwidth, self.stride),
                       self.pad_mode)
        return conv1d(x, self.filters()[:, None, :], stride=self.stride)


class FeBlock(nn.Module):
    """pad -> conv/sinc -> BatchNorm -> activation, on [B, C, T]."""

    def __init__(self, in_channels, fmaps, kwidth, stride, dilation=1,
                 pad_mode="reflect", act=None, norm_type="bnorm",
                 sincnet=False, sr=16000, generator=None):
        super().__init__()
        if act not in (None, "prelu"):
            raise NotImplementedError(
                f"FeBlock act={act!r} (glu or a named activation) is not "
                f"ported yet: {ROADMAP_OFF_SLICE}")
        if norm_type not in ("bnorm", None):
            raise NotImplementedError(
                f"FeBlock norm_type={norm_type!r} is not ported yet "
                f"(snorm/wnorm/bsnorm/lnorm/inorm): {ROADMAP_OFF_SLICE}")
        self.pad_mode = pad_mode
        if sincnet:
            self.pad = (0, 0)       # SincConv pads itself (SAME)
            self.conv = SincConv(fmaps, kwidth, stride, sample_rate=sr,
                                 pad_mode=pad_mode)
        else:
            self.pad = feblock_pad(kwidth, stride, dilation)
            self.conv = Conv1D(in_channels, fmaps, kwidth, stride, dilation,
                               generator=generator)
        self.norm = BatchNorm1d(fmaps) if norm_type == "bnorm" else None
        self.act = PReLU(fmaps, init=0.0)

    def forward(self, x, do_pad=True):
        """``do_pad=False`` skips the SAME pad (the conv runs VALID), the
        JAX package's ``do_pad=False`` form: the streaming encoder supplies
        each block's left and right frames itself."""
        if isinstance(self.conv, SincConv):
            h = self.conv(x, do_pad=do_pad)
        else:
            h = self.conv(pad_1d(x, self.pad, self.pad_mode) if do_pad
                          else x)
        if self.norm is not None:
            h = self.norm(h)
        return self.act(h)


def decimate(x, factor):
    """Nearest-neighbour decimation of [B, C, T] by an integer factor
    (``F.interpolate(scale_factor=1/factor, mode='nearest')``): frames
    0, factor, 2 factor, ..., floor(T / factor) of them."""
    if factor == 1:
        return x
    return x[:, :, :x.shape[2] // factor * factor:factor]


class FeResBlock(nn.Module):
    """Two-conv residual block of the resblocks trunk, on [B, C, T]
    (``pase_tpu/nn.py`` FeResBlock): nearest decimation by ``downsample``
    first, then a symmetric zero pad of (kwidth // 2) * dilation, conv1,
    norm1, act1, the same pad, conv2, act2, plus the identity (the 1x1
    ``resproj`` where the widths differ), then norm2. Dilations (1, 2);
    PReLUs start at 0.

    The identity is decimated before its projection (the JAX block
    projects first: the same function, one order for the offline, the
    streamed and the exported paths). ``stage1``, ``stage2``,
    ``identity`` and ``finish`` are the block's parts, which the
    streaming encoder runs one by one."""

    def __init__(self, in_channels, fmaps, kwidth, downsample=1,
                 dilations=(1, 2), act=None, norm_type=None,
                 generator=None):
        super().__init__()
        if act not in (None, "prelu"):
            if act == "glu":
                raise TypeError("FeResBlock does not support glu (broken "
                                "in the reference as well)")
            raise NotImplementedError(
                f"FeResBlock act={act!r} is not ported yet: "
                f"{ROADMAP_OFF_SLICE}")
        if norm_type not in ("bnorm", None):
            raise NotImplementedError(
                f"FeResBlock norm_type={norm_type!r} is not ported yet "
                f"(snorm/wnorm/bsnorm/lnorm/inorm): {ROADMAP_OFF_SLICE}")
        if kwidth % 2 == 0:
            raise ValueError(
                f"FeResBlock kwidth={kwidth} (even) grows the conv's "
                "length past the identity's; the reference's residual add "
                "fails the same way: use odd kwidths with resblocks")
        self.kwidth = kwidth
        self.downsample = downsample
        self.dilations = tuple(dilations)
        d1, d2 = self.dilations
        self.pads = ((kwidth // 2) * d1, (kwidth // 2) * d2)
        self.conv1 = Conv1D(in_channels, fmaps, kwidth, dilation=d1,
                            generator=generator)
        self.conv2 = Conv1D(fmaps, fmaps, kwidth, dilation=d2,
                            generator=generator)
        self.resproj = (Conv1D(in_channels, fmaps, 1, generator=generator)
                        if in_channels != fmaps else None)
        bnorm = norm_type == "bnorm"
        self.norm1 = BatchNorm1d(fmaps) if bnorm else None
        self.norm2 = BatchNorm1d(fmaps) if bnorm else None
        self.act1 = PReLU(fmaps, init=0.0)
        self.act2 = PReLU(fmaps, init=0.0)

    def stage1(self, x):
        """conv1 -> norm1 -> act1 on frames padded by the caller."""
        h = self.conv1(x)
        if self.norm1 is not None:
            h = self.norm1(h)
        return self.act1(h)

    def stage2(self, h):
        """conv2 -> act2 on frames padded by the caller."""
        return self.act2(self.conv2(h))

    def identity(self, xd):
        """The decimated input, projected where the widths differ."""
        return xd if self.resproj is None else self.resproj(xd)

    def finish(self, h, ident):
        h = h + ident
        return h if self.norm2 is None else self.norm2(h)

    def forward(self, x):
        xd = decimate(x, self.downsample)
        p1, p2 = self.pads
        h = self.stage1(F.pad(xd, (p1, p1)))
        h = self.stage2(F.pad(h, (p2, p2)))
        return self.finish(h, self.identity(xd))


class _QRNNLayer(nn.Module):
    def __init__(self, input_size, hidden, generator=None):
        super().__init__()
        self.linear = nn.Linear(2 * input_size, 3 * hidden)
        bound = 1.0 / math.sqrt(2 * input_size)
        _uniform_(self.linear.weight, bound, generator)
        _uniform_(self.linear.bias, bound, generator)


class QRNN(nn.Module):
    """Window-2 QRNN stack, NTC in/out: per layer y = Linear([x_t, x_{t-1}])
    then pooling (ops/cuda_qrnn.py: the kernel on CUDA, plain on CPU).
    Under a compute dtype the linear runs in it (bias added in it) and y
    reaches the pooling as float32."""

    def __init__(self, input_size, hidden, layers=1, dropout=0.0,
                 generator=None):
        super().__init__()
        self.dropout = dropout
        self.layers = nn.ModuleList(
            [_QRNNLayer(input_size if i == 0 else hidden, hidden, generator)
             for i in range(layers)])

    @staticmethod
    def _linear(layer, src):
        cd = get_compute_dtype()
        lin = layer.linear
        if cd is None:
            return lin(src)
        return (F.linear(src.to(cd), lin.weight.to(cd))
                + lin.bias.to(cd)).float()

    def forward(self, x):
        h = x
        for i, layer in enumerate(self.layers):
            src = torch.cat([h, shift_right(h, dim=1)], dim=-1)
            y = self._linear(layer, src)
            h, _ = cuda_qrnn.qrnn_pool(y.contiguous())
            if self.dropout > 0 and i < len(self.layers) - 1:
                h = F.dropout(h, self.dropout, training=self.training)
        return h

    def layer_step(self, i, x, prev, c0, frames):
        """Layer i on a block of frames of a stream (eval): x [B, T, C], the
        frame before the block prev [B, 1, C] (zeros at the stream's start)
        and the carry c0 [B, H] -> (h [B, T, H], x's last frame, c_T). The
        same linear as ``forward``, in calls of ``frames`` frames
        (``time_blocks``), then ``cuda_qrnn.qrnn_pool(y, c0)``:
        seeded, so a block-streamed run equals one full run of the pooling
        bit for bit (pase_tpu/streaming.py ``_qrnn_layer``)."""
        src = torch.cat([x, torch.cat([prev, x[:, :-1]], dim=1)], dim=-1)
        layer = self.layers[i]
        y = time_blocks(lambda s: self._linear(layer, s), src, frames, dim=1)
        h, c_last = cuda_qrnn.qrnn_pool(y.contiguous(), c0)
        return h, x[:, -1:], c_last


def time_blocks(fn, x, frames, dim):
    """fn(x) for a framewise fn (each output frame reads its input frame
    alone: a linear, a 1x1 conv), taken in calls of exactly ``frames``
    frames along ``dim``, the last call's input zero-padded, and trimmed
    back. A GEMM library picks its kernel by the call's shape, and so its
    order of summation: with one shape for every call, a frame's value
    does not depend on how many frames came with it."""
    t = x.shape[dim]
    pad = (-t) % frames
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    return torch.cat([fn(x.narrow(dim, i, frames))
                      for i in range(0, t + pad, frames)],
                     dim=dim).narrow(dim, 0, t)


class MLPBlock(nn.Module):
    """Conv1d (kwidth ``context``, zero-padded to keep T) -> PReLU (init
    0.25) -> dropout, on [B, C, T]."""

    def __init__(self, in_channels, fmaps, context=1, dout=0.0,
                 generator=None):
        super().__init__()
        if context % 2 == 0:
            raise ValueError(f"MLPBlock context must be odd, got {context}")
        self.context = context
        self.W = Conv1D(in_channels, fmaps, context, generator=generator)
        self.act = PReLU(fmaps, init=0.25)
        self.dout = dout

    def forward(self, x):
        if self.context > 1:
            x = F.pad(x, (self.context // 2, self.context // 2))
        h = self.act(self.W(x))
        if self.dout > 0:
            h = F.dropout(h, self.dout, training=self.training)
        return h


class Deconv1D(nn.ConvTranspose1d):
    """ConvTranspose1d(stride, padding=pad): out = (L-1)*stride - 2*pad +
    kwidth. Weight [Cin, Cout, K] (the JAX kernel [K, Cout, Cin]
    transposed); uniform(+-1/sqrt(Cout*K)) init drawn from ``generator``.
    Under a compute dtype x and the weight run in it, and the bias is
    added in the output's type."""

    def __init__(self, in_channels, out_channels, kwidth, stride, pad,
                 generator=None):
        super().__init__(in_channels, out_channels, kwidth, stride=stride,
                         padding=pad)
        bound = 1.0 / math.sqrt(out_channels * kwidth)
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x):
        cd = get_compute_dtype()
        if cd is not None and x.dtype == torch.float32:
            x = x.to(cd)
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        y = _low_precision(F.conv_transpose1d, x, self.weight.to(x.dtype),
                           None, self.stride, self.padding)
        return y + self.bias.to(y.dtype)[:, None]


class GDeconv1DBlock(nn.Module):
    """Transposed-conv upsampling block on [B, C, T]: deconv -> trim one
    sample where stride and kwidth differ in parity -> norm -> PReLU."""

    def __init__(self, in_channels, fmaps, kwidth, stride=4, norm_type=None,
                 act=None, generator=None):
        super().__init__()
        if act not in (None, "prelu"):
            raise NotImplementedError(
                f"GDeconv1DBlock act={act!r} is not ported yet: "
                f"{ROADMAP_OFF_SLICE}")
        if norm_type not in ("bnorm", None):
            raise NotImplementedError(
                f"GDeconv1DBlock norm_type={norm_type!r} is not ported yet: "
                f"{ROADMAP_OFF_SLICE}")
        pad = max(0, (stride - kwidth) // -2)
        self.trim = (stride % 2) != (kwidth % 2)
        self.deconv = Deconv1D(in_channels, fmaps, kwidth, stride, pad,
                               generator=generator)
        self.norm = BatchNorm1d(fmaps) if norm_type == "bnorm" else None
        self.act = PReLU(fmaps, init=0.0)

    def forward(self, x):
        y = self.deconv(x)
        if self.trim:
            y = y[:, :, :-1]
        if self.norm is not None:
            y = self.norm(y)
        return self.act(y)


@contextlib.contextmanager
def _no_tf32():
    """Float32 matmuls without TF32 within the block (the flag is global;
    it is restored after)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class VQEMA(nn.Module):
    """VQ-VAE quantizer with EMA codebook updates (``pase_tpu/nn.py``
    VQEMA) on [B, T, D] frames.

    The codebook ``emb`` [K, D] and the EMA state ``ema_cluster_size``
    [K], ``ema_w`` [K, D] are buffers (the JAX package keeps them in
    ``batch_stats``): training updates them, gradients do not. A frame's
    code is the argmin of |x|^2 + |e|^2 - 2 x e^T, taken in float32
    without TF32. In training the EMA update runs first: the counts and
    the code sums through the one-hot matrix (a GEMM, deterministic on
    the card), Laplace smoothing (size + eps) / (n + K eps) n, and
    emb = ema_w / size; the output's codes are read from the updated
    codebook. The output passes x's gradient straight through (x + sg(q -
    x)); the commitment loss beta * mean((sg(q) - x)^2) and the code
    perplexity of the last call are kept in ``loss`` and ``perplexity``,
    its codes in ``codes``.

    ``pick``, when set, is called as pick(rows, dist, codes) -> codes: a
    parity harness forces a side's codes with it
    (``grad_parity.vq_codes``)."""

    def __init__(self, emb_K, emb_dim, beta=0.25, gamma=0.99, eps=1e-5,
                 generator=None):
        super().__init__()
        self.emb_K = emb_K
        self.beta = beta
        self.gamma = gamma
        self.eps = eps
        self.register_buffer("emb", torch.randn(emb_K, emb_dim,
                                                generator=generator))
        self.register_buffer("ema_cluster_size", torch.zeros(emb_K))
        self.register_buffer("ema_w", torch.randn(emb_K, emb_dim,
                                                  generator=generator))
        self.pick = None
        self.loss = self.perplexity = self.codes = None

    def distances(self, flat):
        """[N, K] squared distances of [N, D] rows to the codebook."""
        e = self.emb
        with _no_tf32():
            return (torch.sum(flat * flat, dim=1, keepdim=True)
                    + torch.sum(e * e, dim=1) - 2.0 * (flat @ e.t()))

    def nearest(self, flat):
        """The code of each [N, D] row, through ``pick`` when set."""
        dist = self.distances(flat)
        idx = torch.argmin(dist, dim=1)
        return idx if self.pick is None else self.pick(flat, dist, idx)

    def quantize(self, y):
        """The codebook rows nearest to the frames of y [B, D, t] (the
        streaming encoder's output form, no EMA, no straight-through):
        [B, D, t]."""
        b, d, t = y.shape
        flat = y.transpose(1, 2).reshape(-1, d)
        q = self.emb[self.nearest(flat)]
        return q.reshape(b, t, d).transpose(1, 2)

    def forward(self, x):
        b, t, d = x.shape
        flat = x.reshape(-1, d)
        with torch.no_grad():
            idx = self.nearest(flat)
            if self.training:
                enc = F.one_hot(idx, self.emb_K).to(flat.dtype)
                counts = enc.sum(dim=0)
                g = self.gamma
                size = self.ema_cluster_size * g + (1 - g) * counts
                n = size.sum()
                size = (size + self.eps) / (n + self.emb_K * self.eps) * n
                with _no_tf32():
                    dw = enc.t() @ flat
                new_w = self.ema_w * g + (1 - g) * dw
                self.ema_cluster_size.copy_(size)
                self.ema_w.copy_(new_w)
                self.emb.copy_(new_w / size[:, None])
            else:
                counts = torch.bincount(idx, minlength=self.emb_K).to(
                    flat.dtype)
            q = self.emb[idx].reshape(b, t, d)
            p = counts / flat.shape[0]
            self.perplexity = torch.exp(-torch.sum(p * torch.log(p + 1e-10)))
        self.codes = idx
        self.loss = self.beta * torch.mean(torch.square(q - x))
        return x + (q - x).detach()
