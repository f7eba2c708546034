"""Encoder building blocks (torch.nn), NCT layout.

The blocks of ``pase_tpu.nn`` that the PASE+ encoder reaches, with the
reference torch module and parameter names so that a state dict in the
reference layout loads with ``load_state_dict(strict=True)``:

* ``Conv1D``      — torch Conv1d with the torch-default uniform init drawn
                    from a ``torch.Generator``.
* ``SincConv``    — SincNet band-pass layer: filters synthesized every
                    forward, one plain conv1d on the reflect-padded input.
* ``FeBlock``     — pad(reflect) -> conv/sinc -> BatchNorm -> PReLU
                    (torch's own BatchNorm1d and PReLU, init 0).
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

Parameters are created on the CPU and drawn from the generator passed in;
the owner moves the finished module to its device.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from pase_tpu_torch.ops import cuda_qrnn
from pase_tpu_torch.ops.pad import feblock_pad, pad_1d, sinc_same_pad
from pase_tpu_torch.ops.qrnn import shift_right
from pase_tpu_torch.ops.sinc import (build_sinc_filters, mel_init_hz,
                                     sinc_time_axes)

ROADMAP_OFF_SLICE = "ROADMAP.md, queue 1: off-path model variants"


def _uniform_(tensor, bound, generator):
    with torch.no_grad():
        tensor.uniform_(-bound, bound, generator=generator)


class Conv1D(nn.Conv1d):
    """Conv1d (VALID) with torch-default uniform(+-1/sqrt(Cin*K)) init for
    weight and bias, drawn from ``generator``."""

    def __init__(self, in_channels, out_channels, kwidth, stride=1,
                 dilation=1, bias=True, generator=None):
        super().__init__(in_channels, out_channels, kwidth, stride=stride,
                         dilation=dilation, bias=bias)
        bound = 1.0 / math.sqrt(in_channels * kwidth)
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)


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

    def forward(self, x):
        if x.shape[1] != 1:
            raise ValueError("SincConv only supports one input channel")
        x = pad_1d(x, sinc_same_pad(self.kwidth, self.stride), self.pad_mode)
        return F.conv1d(x, self.filters()[:, None, :], stride=self.stride)


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
        self.norm = nn.BatchNorm1d(fmaps) if norm_type == "bnorm" else None
        self.act = nn.PReLU(fmaps, init=0.0)

    def forward(self, x):
        h = self.conv(pad_1d(x, self.pad, self.pad_mode))
        if self.norm is not None:
            h = self.norm(h)
        return self.act(h)


class _QRNNLayer(nn.Module):
    def __init__(self, input_size, hidden, generator=None):
        super().__init__()
        self.linear = nn.Linear(2 * input_size, 3 * hidden)
        bound = 1.0 / math.sqrt(2 * input_size)
        _uniform_(self.linear.weight, bound, generator)
        _uniform_(self.linear.bias, bound, generator)


class QRNN(nn.Module):
    """Window-2 QRNN stack, NTC in/out: per layer y = Linear([x_t, x_{t-1}])
    then pooling (ops/cuda_qrnn.py: the kernel on CUDA, plain on CPU)."""

    def __init__(self, input_size, hidden, layers=1, dropout=0.0,
                 generator=None):
        super().__init__()
        self.dropout = dropout
        self.layers = nn.ModuleList(
            [_QRNNLayer(input_size if i == 0 else hidden, hidden, generator)
             for i in range(layers)])

    def forward(self, x):
        h = x
        for i, layer in enumerate(self.layers):
            y = layer.linear(torch.cat([h, shift_right(h, dim=1)], dim=-1))
            h, _ = cuda_qrnn.qrnn_pool(y.contiguous())
            if self.dropout > 0 and i < len(self.layers) - 1:
                h = F.dropout(h, self.dropout, training=self.training)
        return h


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
        self.act = nn.PReLU(fmaps, init=0.25)
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
    transposed); uniform(+-1/sqrt(Cout*K)) init drawn from ``generator``."""

    def __init__(self, in_channels, out_channels, kwidth, stride, pad,
                 generator=None):
        super().__init__(in_channels, out_channels, kwidth, stride=stride,
                         padding=pad)
        bound = 1.0 / math.sqrt(out_channels * kwidth)
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)


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
        self.norm = nn.BatchNorm1d(fmaps) if norm_type == "bnorm" else None
        self.act = nn.PReLU(fmaps, init=0.0)

    def forward(self, x):
        y = self.deconv(x)
        if self.trim:
            y = y[:, :, :-1]
        if self.norm is not None:
            y = self.norm(y)
        return self.act(y)
