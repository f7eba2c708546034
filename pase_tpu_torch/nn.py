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
* ``SNConv1D`` / ``WNConv1D`` — the weight reparameterizations of a conv:
                    spectral norm (one power iteration a call, ``u`` a
                    buffer, updated in train mode) and weight norm
                    (w = g v / (|v| + 1e-12) per output channel).
* ``LayerNorm1d`` / ``InstanceNorm1d`` — over channels per frame; per
                    sample and channel over time (affine optional).
* ``split_norm`` / ``build_norm`` — a reference norm_type as (conv
                    reparameterization, post-conv norm layer).
* ``FeBlock``     — pad(reflect) -> conv/sinc -> norm -> PReLU (init 0),
                    glu, or an activation named as in jax.nn
                    (``NamedActivation``: relu, elu, gelu, ...).
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
* ``BiRNN``       — bidirectional LSTM / GRU context layer in torch's
                    nn.LSTM / nn.GRU layout (cuDNN on the card).
* ``FlaxRNN``     — a flax GRU / LSTM cell scanned over time, as torch's
                    GRU / LSTM with flax's absent biases fixed at zero;
                    ``flax_cell_to_torch`` / ``torch_cell_to_flax`` bridge
                    its parameters.
* ``MLPBlock``    — worker-head block: 1x1 (/context) conv -> PReLU (init
                    0.25) -> dropout; optionally a ``PatternedDropout``
                    on its input (dropin) and a context-tied conv.
* ``dropout``     — inverted dropout whose keep mask is drawn from an
                    explicit ``torch.Generator`` for the global batch
                    (``mesh.draw_rows``): the QRNN's and BiRNN's between
                    layers, the MLP block's; never torch's global
                    generator (a module without one raises).
* ``Deconv1D`` / ``GDeconv1DBlock`` — transposed-conv upsampling block of
                    the waveform decoder: ConvTranspose1d -> (trim) ->
                    norm -> PReLU (init 0), glu or a named activation.

BatchNorm is torch's BatchNorm1d: in train mode it normalizes with the
biased batch variance and updates the running stats with the unbiased one
at momentum 0.1, as ``pase_tpu/nn.py`` BatchNorm1d does (which takes the
variance in one pass, E[x^2] - E[x]^2; torch in two: equal to rounding).
Under a process group of more than one rank, BatchNorm and the VQ-EMA
quantizer take their batch statistics over the global batch of the data
group (``parallel/mesh.py``), as the JAX package's data-parallel step
does. Under --n_model the FeBlock, MLP-block, decoder-block, head-conv
and QRNN layers may compute column-parallel (``tp_column``:
``parallel/tp.py``'s ``enter`` / ``leave`` around them).

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
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pase_tpu_torch.ops import cuda_qrnn
from pase_tpu_torch.ops.pad import feblock_pad, pad_1d, sinc_same_pad
from pase_tpu_torch.ops.qrnn import shift_right
from pase_tpu_torch.ops.sinc import (build_sinc_filters, mel_init_hz,
                                     sinc_time_axes)
from pase_tpu_torch.parallel import mesh, tp
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
    weight and bias, drawn from ``generator``; runs ``conv1d``. A worker
    head's final conv may compute column-parallel (``tp_column``,
    ``parallel/tp.py``): its own output channels, gathered."""

    tp_column = None

    def __init__(self, in_channels, out_channels, kwidth, stride=1,
                 dilation=1, bias=True, generator=None):
        super().__init__(in_channels, out_channels, kwidth, stride=stride,
                         dilation=dilation, bias=bias)
        bound = 1.0 / math.sqrt(in_channels * kwidth)
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x):
        return tp.leave(self, conv1d(tp.enter(self, x), self.weight,
                                     self.bias, self.stride[0],
                                     self.dilation[0]))


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch normalization of [B, C, T] over the global batch of
    the data group (``mesh.data_group``: the world, or with --n_model the
    ranks that hold the same channels of other rows): the forward gathers
    each rank's count, mean and sum
    of squared deviations (one all_reduce) and combines them (Chan et
    al.'s pairwise update) into the global mean and biased variance, in
    float32; the backward all-reduces sum(dy) and sum(dy x_hat) (one
    all_reduce), which give each rank's rows their gradient through the
    global statistics. The weight and bias get this rank's sums: the
    trainer's gradient all-reduce adds the ranks'. Returns (y, mean, var),
    the last two not differentiable."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        xf = x.float()
        m_loc = xf.mean(dim=(0, 2))
        m2_loc = torch.square(xf - m_loc[:, None]).sum(dim=(0, 2))
        c = m_loc.shape[0]
        per = mesh.gather(torch.cat([
            m_loc.new_full((1,), float(x.shape[0] * x.shape[2])), m_loc,
            m2_loc]))
        ns, ms, m2s = per[:, :1], per[:, 1:c + 1], per[:, c + 1:]
        n = ns.sum()
        mean = (ns * ms).sum(dim=0) / n
        var = (m2s + ns * torch.square(ms - mean)).sum(dim=0) / n
        invstd = torch.rsqrt(var + eps)
        if x.dtype == torch.float32:
            y = (xf - mean[:, None]) * invstd[:, None]
            if weight is not None:
                y = y * weight[:, None] + bias[:, None]
        else:
            def col(v):
                return v.to(x.dtype)[:, None]

            y = (x - col(mean)) * col(invstd)
            if weight is not None:
                y = y * col(weight) + col(bias)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.n = float(n)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd = ctx.saved_tensors
        xhat = (x.float() - mean[:, None]) * invstd[:, None]
        dyf = dy.float()
        s_dy = dyf.sum(dim=(0, 2))
        s_dyx = (dyf * xhat).sum(dim=(0, 2))
        dw = db = None
        if weight is not None:
            dw, db = s_dyx.to(weight.dtype), s_dy.to(weight.dtype)
        sums = torch.cat([s_dy, s_dyx])
        mesh.all_reduce_([sums])
        g_dy, g_dyx = sums.split(s_dy.shape[0])
        scale = invstd if weight is None else weight.float() * invstd
        n = ctx.n
        dx = scale[:, None] * (dyf - g_dy[:, None] / n
                               - xhat * (g_dyx[:, None] / n))
        return dx.to(x.dtype), dw, db, None


class BatchNorm1d(nn.BatchNorm1d):
    """torch's BatchNorm1d for a float32 x. For a bf16 x (under the
    compute-dtype policy) the JAX package's: batch statistics in float32
    in one pass, var = E[x^2] - E[x]^2, the running stats updated in
    float32 with the unbiased variance, then (x - mean) * rsqrt(var + eps)
    and the affine in x's type, mean, inv, weight and bias cast to it.

    In train mode under a process group of more than one rank the
    statistics are those of the global batch (``_GlobalBatchNorm``), as
    the JAX package's jitted step on a batch-sharded array takes them;
    the running stats move by the global mean and unbiased variance."""

    def forward(self, x):
        if self.training and mesh.data_world() > 1:
            return self._global(x)
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

    def _global(self, x):
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias,
                                              self.eps)
        n = x.shape[0] * x.shape[2] * mesh.data_world()
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))
            self.num_batches_tracked.add_(1)
        return y


class PReLU(nn.PReLU):
    """torch's PReLU with its slope cast to x's type."""

    def forward(self, x):
        return F.prelu(x, self.weight.to(x.dtype))


class SincConv(nn.Module):
    """SincNet band-pass conv layer on a single-channel [B, 1, T] input.
    In a column-parallel ``FeBlock`` (``tp_column``) it synthesizes the
    filters of its own channels from its rows of the whole bands."""

    tp_column = None

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
        return build_sinc_filters(tp.own_part(self, self.low_hz_),
                                  tp.own_part(self, self.band_hz_), self.n_,
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


class SNConv1D(Conv1D):
    """Conv1d with spectral weight normalization (``pase_tpu/nn.py``
    SNConv1D): one power iteration per call on the [F, Cin*K] matrix W of
    the weight, with u [F] a buffer (``batch_stats/.../u`` in the JAX
    layout): v = W^T u / (|.| + 1e-12), u' = W v / (|.| + 1e-12),
    sigma = v . (W^T u'), and the conv runs weight / max(sigma, 1e-12).
    The gradient flows through v, u' and sigma; in train mode u becomes
    u' (detached). sigma does not depend on the order of W's columns, so
    the JAX kernel's [K*Cin, F] rows give the same sigma up to rounding.

    u is rebound to a new tensor, never written in place: autograd saved
    the old one for W^T u."""

    def __init__(self, in_channels, out_channels, kwidth, stride=1,
                 dilation=1, bias=True, generator=None):
        super().__init__(in_channels, out_channels, kwidth, stride,
                         dilation, bias=bias, generator=generator)
        self.register_buffer("u", torch.randn(out_channels,
                                              generator=generator))

    def normalized_weight(self):
        """weight / sigma of the current u; in train mode u advances."""
        w = self.weight.reshape(self.weight.shape[0], -1)
        v = w.t() @ self.u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u_new = w @ v
        u_new = u_new / (torch.linalg.vector_norm(u_new) + 1e-12)
        sigma = torch.dot(v, w.t() @ u_new)
        if self.training:
            self.u = u_new.detach()
        return self.weight / torch.clamp(sigma, min=1e-12)

    def forward(self, x):
        return conv1d(x, self.normalized_weight(), self.bias, self.stride[0],
                      self.dilation[0])


class WNConv1D(nn.Module):
    """Conv1d with weight normalization (``pase_tpu/nn.py`` WNConv1D):
    w = g v / (|v| + 1e-12), the norm per output channel over (Cin, K);
    v [F, Cin, K] draws the torch-default uniform init and g starts at |v|,
    so the initial function is the plain conv's. ``kernel_size``,
    ``stride`` and ``dilation`` are nn.Conv1d's tuples."""

    def __init__(self, in_channels, out_channels, kwidth, stride=1,
                 dilation=1, bias=True, generator=None):
        super().__init__()
        self.kernel_size, self.stride = (kwidth,), (stride,)
        self.dilation = (dilation,)
        bound = 1.0 / math.sqrt(in_channels * kwidth)
        self.v = nn.Parameter(torch.empty(out_channels, in_channels,
                                          kwidth))
        _uniform_(self.v, bound, generator)
        with torch.no_grad():
            g = torch.sqrt(torch.sum(self.v * self.v, dim=(1, 2)))
        self.g = nn.Parameter(g)
        self.bias = None
        if bias:
            self.bias = nn.Parameter(torch.empty(out_channels))
            _uniform_(self.bias, bound, generator)

    def normalized_weight(self):
        norm = torch.sqrt(torch.sum(self.v * self.v, dim=(1, 2),
                                    keepdim=True)) + 1e-12
        return self.v / norm * self.g[:, None, None]

    def forward(self, x):
        return conv1d(x, self.normalized_weight(), self.bias, self.stride[0],
                      self.dilation[0])


def _affine(y, weight, bias):
    return y * weight[:, None] + bias[:, None]


class LayerNorm1d(nn.Module):
    """LayerNorm over the channels of each frame of [B, C, T] (dim 1),
    biased variance, eps 1e-5, affine (``pase_tpu/nn.py`` LayerNorm1d,
    which is channel-last)."""

    def __init__(self, features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mean = x.mean(dim=1, keepdim=True)
        var = torch.square(x - mean).mean(dim=1, keepdim=True)
        return _affine((x - mean) * torch.rsqrt(var + self.eps),
                       self.weight, self.bias)


class InstanceNorm1d(nn.Module):
    """Per sample and channel over time, biased variance, eps 1e-5, no
    running statistics; affine parameters with ``affine`` (``inorm`` has
    none, ``affinorm`` has them)."""

    def __init__(self, features, affine=False, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = self.bias = None
        if affine:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mean = x.mean(dim=2, keepdim=True)
        var = torch.square(x - mean).mean(dim=2, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y if self.weight is None else _affine(y, self.weight,
                                                     self.bias)


def build_norm(norm_type, features):
    """The post-conv norm layer of a norm type (``pase_tpu/nn.py``
    build_norm): bnorm, lnorm, inorm, affinorm or None. A weight
    reparameterization ('snorm', 'wnorm', 'bsnorm') raises: callers split
    it off first with ``split_norm``."""
    if norm_type == "bnorm":
        return BatchNorm1d(features)
    if norm_type == "lnorm":
        return LayerNorm1d(features)
    if norm_type in ("inorm", "affinorm"):
        return InstanceNorm1d(features, affine=norm_type == "affinorm")
    if norm_type is None:
        return None
    raise TypeError(f"Unrecognized norm type: {norm_type}")


def split_norm(norm_type):
    """(conv reparameterization, post-conv norm type) of a reference
    norm_type: 'snorm' and 'wnorm' reparameterize the conv and add no norm
    layer, 'bsnorm' is spectral norm plus BatchNorm."""
    if norm_type in ("snorm", "wnorm"):
        return norm_type, None
    if norm_type == "bsnorm":
        return "snorm", "bnorm"
    return None, norm_type


_REPARAM_CONV = {None: Conv1D, "snorm": SNConv1D, "wnorm": WNConv1D}


def _over_channels(fn):
    """fn(x, dim) taken over the channels of [B, C, T] (the last axis of
    the JAX package's [B, T, C])."""
    return lambda x: fn(x, 1)


def _standardize(x, dim, eps=1e-5):
    """jax.nn.standardize: var = E[x^2] - E[x]^2 clipped at 0."""
    mean = x.mean(dim=dim, keepdim=True)
    var = torch.clamp((x * x).mean(dim=dim, keepdim=True) - mean * mean,
                      min=0.0)
    return (x - mean) * torch.rsqrt(var + eps)


def _log1mexp(x):
    return torch.where(x < math.log(2.0), torch.log(-torch.expm1(-x)),
                       torch.log1p(-torch.exp(-x)))


# the jax.nn activations a block can take by name, with jax.nn's
# definitions and defaults: gelu is the tanh approximation, leaky_relu's
# slope 0.01, elu / celu's alpha 1, softplus log(1 + e^x) with no
# threshold; softmax, log_softmax and standardize run over the channels.
# Where torch's function differs from jax.nn's at a kink only in its
# derivative (hard_tanh at +-1, leaky_relu at 0, sparse_sigmoid's clip),
# jax.nn's formula is written out
JAX_ACTIVATIONS = {
    "celu": F.celu,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "hard_sigmoid": F.hardsigmoid,
    "hard_silu": F.hardswish,
    "hard_swish": F.hardswish,
    "hard_tanh": lambda x: torch.where(
        x > 1.0, torch.ones_like(x),
        torch.where(x < -1.0, -torch.ones_like(x), x)),
    "identity": lambda x: x,
    "leaky_relu": lambda x: torch.where(x >= 0, x, 0.01 * x),
    "log1mexp": _log1mexp,
    "log_sigmoid": F.logsigmoid,
    "log_softmax": _over_channels(torch.log_softmax),
    "mish": F.mish,
    "relu": F.relu,
    "relu6": F.relu6,
    "selu": F.selu,
    "sigmoid": torch.sigmoid,
    "silu": F.silu,
    "soft_sign": F.softsign,
    "softmax": _over_channels(torch.softmax),
    "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "sparse_plus": lambda x: torch.where(
        x <= -1.0, torch.zeros_like(x),
        torch.where(x >= 1.0, x, (x + 1.0) ** 2 / 4)),
    "sparse_sigmoid": lambda x: 0.5 * torch.minimum(
        torch.maximum(x + 1.0, torch.zeros_like(x)),
        torch.full_like(x, 2.0)),
    "squareplus": lambda x: (x + torch.sqrt(x * x + 4)) / 2,
    "standardize": _over_channels(_standardize),
    "swish": F.silu,
    "tanh": torch.tanh,
}


class NamedActivation(nn.Module):
    """A parameter-free activation named as in ``jax.nn`` (the JAX
    blocks' ``getattr(jax.nn, act.lower())``), on [B, C, T]."""

    def __init__(self, name):
        super().__init__()
        key = name.lower()
        if key not in JAX_ACTIVATIONS:
            # jax.nn's other names (glu, one_hot, logsumexp, ...) change
            # the width or reduce the frames: no block output
            raise AttributeError(
                f"activation {name!r}: jax.nn has no activation {key!r} "
                f"that keeps a block's shape")
        self.name = key
        self.fn = JAX_ACTIVATIONS[key]

    def forward(self, x):
        return self.fn(x)

    def extra_repr(self):
        return self.name


def _activation(act, fmaps):
    """The PReLU (init 0) of a block, None for glu, else the jax.nn
    activation of that name (lower-cased, as the JAX blocks look it up);
    a name that is not one raises AttributeError, as JAX's getattr
    does."""
    if act in (None, "prelu"):
        return PReLU(fmaps, init=0.0)
    if act == "glu":
        return None
    return NamedActivation(act)


def _glu(h):
    z, g = torch.chunk(h, 2, dim=1)
    return z * torch.sigmoid(g)


class FeBlock(nn.Module):
    """pad -> conv/sinc -> norm -> activation, on [B, C, T]
    (``pase_tpu/nn.py`` FeBlock). ``norm_type`` is split by
    ``split_norm``: snorm / wnorm make the conv an ``SNConv1D`` /
    ``WNConv1D`` (bsnorm: SN plus BatchNorm), the rest is the norm layer
    after it. glu doubles the conv's channels and gates one half by the
    other; the sinc layer takes no reparameterization (TypeError, as in
    JAX). Under --n_model it may compute column-parallel (``tp_column``,
    ``parallel/tp.py``): its input copied in, its own channels out of the
    conv, norm and activation, then gathered."""

    tp_column = None

    def __init__(self, in_channels, fmaps, kwidth, stride, dilation=1,
                 pad_mode="reflect", act=None, norm_type="bnorm",
                 sincnet=False, sr=16000, generator=None):
        super().__init__()
        wfmaps = 2 * fmaps if act == "glu" else fmaps
        reparam, post_norm = split_norm(norm_type)
        self.pad_mode = pad_mode
        if sincnet:
            if reparam is not None:
                raise TypeError(
                    f"norm_type={norm_type!r} reparameterizes conv weights;"
                    " the sinc layer has no weight tensor")
            self.pad = (0, 0)       # SincConv pads itself (SAME)
            self.conv = SincConv(wfmaps, kwidth, stride, sample_rate=sr,
                                 pad_mode=pad_mode)
        else:
            self.pad = feblock_pad(kwidth, stride, dilation)
            self.conv = _REPARAM_CONV[reparam](
                in_channels, wfmaps, kwidth, stride, dilation,
                generator=generator)
        self.norm = build_norm(post_norm, wfmaps)
        self.act = _activation(act, fmaps)

    def forward(self, x, do_pad=True):
        """``do_pad=False`` skips the SAME pad (the conv runs VALID), the
        JAX package's ``do_pad=False`` form: the streaming encoder supplies
        each block's left and right frames itself."""
        x = tp.enter(self, x)
        if isinstance(self.conv, SincConv):
            h = self.conv(x, do_pad=do_pad)
        else:
            h = self.conv(pad_1d(x, self.pad, self.pad_mode) if do_pad
                          else x)
        if self.norm is not None:
            h = self.norm(h)
        return tp.leave(self, _glu(h) if self.act is None else self.act(h))


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
    PReLUs start at 0. The norm type splits as in ``FeBlock`` (conv1 and
    conv2 take the reparameterization, resproj stays plain); glu raises
    TypeError, as in JAX.

    The identity is decimated before its projection (the JAX block
    projects first: the same function, one order for the offline, the
    streamed and the exported paths). ``stage1``, ``stage2``,
    ``identity`` and ``finish`` are the block's parts, which the
    streaming encoder runs one by one."""

    def __init__(self, in_channels, fmaps, kwidth, downsample=1,
                 dilations=(1, 2), act=None, norm_type=None,
                 generator=None):
        super().__init__()
        if act == "glu":
            raise TypeError("FeResBlock does not support glu (broken "
                            "in the reference as well)")
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
        reparam, post_norm = split_norm(norm_type)
        conv = _REPARAM_CONV[reparam]
        self.conv1 = conv(in_channels, fmaps, kwidth, dilation=d1,
                          generator=generator)
        self.conv2 = conv(fmaps, fmaps, kwidth, dilation=d2,
                          generator=generator)
        self.resproj = (Conv1D(in_channels, fmaps, 1, generator=generator)
                        if in_channels != fmaps else None)
        self.norm1 = build_norm(post_norm, fmaps)
        self.norm2 = build_norm(post_norm, fmaps)
        self.act1 = _activation(act, fmaps)
        self.act2 = _activation(act, fmaps)

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


def dropout(x, p, generator, training=True, layer=None):
    """x [B, ...] with each value kept where a uniform draw is below
    1 - p and scaled by 1 / (1 - p), else 0, in train mode with p > 0
    (else x). The draw comes from ``generator`` for the global batch
    (``mesh.draw_rows``: row i of the global batch gets draw i whatever
    the number of processes) and, where x is a column-parallel ``layer``'s
    own channels (axis 1), for all its channels (``tp.channel_draw``);
    without a generator it raises: no mask is drawn from torch's global
    generator."""
    if p <= 0 or not training:
        return x
    if generator is None:
        raise ValueError(
            f"dropout {p} in train mode needs a torch.Generator (the "
            "module's dropout_generator; the Trainer sets it)")
    def draw(m):
        return tp.channel_draw(layer, lambda c: torch.rand(
            (m, c) + tuple(x.shape[2:]), generator=generator,
            device=x.device), x)

    keep = mesh.draw_rows(draw, x.shape[0]) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


class DropoutGenerators:
    """Mixin of an encoder: setting its ``dropout_generator`` sets it on
    every submodule that draws dropout masks (a ``QRNN``, ``BiRNN``, an
    ASPP block); the Trainer seeds the one generator per step."""

    _dropout_generator = None

    @property
    def dropout_generator(self):
        return self._dropout_generator

    @dropout_generator.setter
    def dropout_generator(self, generator):
        self._dropout_generator = generator
        for m in self.modules():
            if m is not self and hasattr(m, "dropout_generator"):
                m.dropout_generator = generator


def qrnn_linear(src, weight, bias):
    """A QRNN layer's linear over src [B, T, 2C] -> [B, T, 3H]; under a
    compute dtype in it (bias added in it), returned as float32."""
    cd = get_compute_dtype()
    if cd is None:
        return F.linear(src, weight, bias)
    return (F.linear(src.to(cd), weight.to(cd)) + bias.to(cd)).float()


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
    reaches the pooling as float32. Under --n_model a layer may run split
    by lanes (``tp_column``, ``parallel/tp.py``): its linear holds the z,
    f and o rows of its own lanes, the pooling runs on them, and h is
    gathered."""

    tp_column = None

    def __init__(self, input_size, hidden, layers=1, dropout=0.0,
                 generator=None):
        super().__init__()
        self.dropout = dropout
        self.dropout_generator = None   # the masks' between the layers
        self.layers = nn.ModuleList(
            [_QRNNLayer(input_size if i == 0 else hidden, hidden, generator)
             for i in range(layers)])

    @staticmethod
    def _linear(layer, src):
        return qrnn_linear(src, layer.linear.weight, layer.linear.bias)

    def forward(self, x):
        h = x
        for i, layer in enumerate(self.layers):
            src = tp.enter(self, torch.cat([h, shift_right(h, dim=1)],
                                           dim=-1))
            y = self._linear(layer, src)
            h, _ = cuda_qrnn.qrnn_pool(y.contiguous())
            h = tp.leave(self, h, dim=-1)
            if i < len(self.layers) - 1:
                h = dropout(h, self.dropout, self.dropout_generator,
                            self.training)
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


def lecun_normal_(weight, generator=None):
    """flax's default Dense kernel init: truncated normal (at 2 std) of
    variance 1 / fan_in (torch weight [out, in])."""
    std = math.sqrt(1.0 / weight.shape[1]) / .87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def flax_dense(n_in, n_out, generator=None, bias=True):
    """A Linear with flax's Dense init: lecun-normal weight, zero bias."""
    layer = nn.Linear(n_in, n_out, bias=bias)
    with torch.no_grad():
        lecun_normal_(layer.weight, generator)
        if bias:
            layer.bias.zero_()
    return layer


class BiRNN(nn.RNNBase):
    """Bidirectional multi-layer LSTM / GRU context block (``pase_tpu/nn.py``
    BiRNN, the reference's non-QRNN ``build_rnn_block``): NTC in, NTC out
    with 2 * hidden features (forward ++ backward), zero initial state,
    float32 whatever the compute policy (the input is cast).

    It is ``nn.LSTM`` / ``nn.GRU``'s base, ``nn.RNNBase``, in their mode
    (bidirectional, batch-first; one cuDNN call over all layers, the
    weights flattened into one buffer): parameters ``{weight,bias}_{ih,hh}_l{k}[_reverse]``
    ([G * H, in], gates i, f, g, o or r, z, n), both biases trained, as in
    JAX and torch; in training, dropout between layers (not after the
    last), its masks from ``dropout_generator`` (``dropout``): the layers
    then run one call each. Init is torch's uniform(+-1/sqrt(hidden)),
    drawn from ``generator``."""

    def __init__(self, input_size, hidden, layers=1, cell="lstm",
                 dropout=0.0, generator=None):
        if cell not in ("lstm", "gru"):
            raise TypeError(f"Unrecognized rnn type: {cell}")
        self._init_generator = generator   # read by reset_parameters
        super().__init__(cell.upper(), input_size, hidden,
                         num_layers=layers, batch_first=True,
                         dropout=dropout, bidirectional=True)
        del self._init_generator
        self.dropout_generator = None   # the masks' between the layers

    def reset_parameters(self):
        bound = 1.0 / math.sqrt(self.hidden_size)
        for p in self.parameters():
            _uniform_(p, bound, getattr(self, "_init_generator", None))

    def _run(self, h, weights, layers):
        zeros = h.new_zeros(2 * layers, h.shape[0], self.hidden_size)
        # cuDNN's 'train' mode keeps the reserve space a backward needs:
        # taken whenever autograd records, in eval too
        train = self.training or torch.is_grad_enabled()
        if self.mode == "LSTM":
            return torch.lstm(h, (zeros, zeros), weights, True, layers, 0.0,
                              train, True, True)[0]
        return torch.gru(h, zeros, weights, True, layers, 0.0, train, True,
                         True)[0]

    def forward(self, x):
        h = x.float()
        if not (self.training and self.dropout > 0 and self.num_layers > 1):
            return self._run(h, self._flat_weights, self.num_layers)
        # dropout between the layers: one call a layer, the mask from
        # dropout_generator between them (cuDNN's own dropout would draw
        # from its global state); a layer's weights are a slice of the
        # flat buffer, which cuDNN copies (its warning silenced)
        per = len(self._flat_weights) // self.num_layers
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "RNN module weights are not",
                                    UserWarning)
            for i in range(self.num_layers):
                if i:
                    h = dropout(h, self.dropout, self.dropout_generator)
                h = self._run(h, self._flat_weights[i * per:(i + 1) * per],
                              1)
        return h


# flax's cell Denses in torch's gate order: (input, hidden) names
FLAX_GATES = {"gru": (("ir", "hr"), ("iz", "hz"), ("in", "hn")),
              "lstm": (("ii", "hi"), ("if", "hf"), ("ig", "hg"),
                       ("io", "ho"))}


class FlaxRNN(nn.Module):
    """A flax ``nn.RNN`` of a ``GRUCell`` or ``LSTMCell`` (one direction,
    from h = 0, batch-first [B, T, in] -> [B, T, hidden]), run as torch's
    GRU / LSTM (cuDNN on the card).

    flax's GRU equals torch's with the hidden r and z biases at 0 (its
    'hr' and 'hz' Denses have no bias; 'hn''s sits inside the r product
    as torch's does); its LSTM equals torch's with no input bias (the
    'i*' Denses have none). Those absent biases are zeros made in
    ``weights``, not parameters, so an optimizer never moves them. The
    parameters: ``weight_ih`` [G * H, in], ``weight_hh`` [G * H, H] in
    torch's gate order, and ``bias_ih`` [3H] with ``bias_hn`` [H] (GRU)
    or ``bias_hh`` [4H] (LSTM). Init as flax's cells: lecun-normal input
    kernels, orthogonal recurrent ones (per gate), zero biases, drawn
    from ``generator``. Float32 whatever the compute policy (flax's
    cells without a dtype promote to their float32 parameters)."""

    def __init__(self, input_size, hidden, cell="gru", generator=None):
        super().__init__()
        if cell not in FLAX_GATES:
            raise ValueError(f"cell {cell!r}: gru or lstm")
        self.cell, self.hidden = cell, hidden
        gates = len(FLAX_GATES[cell])
        self.weight_ih = nn.Parameter(torch.empty(gates * hidden,
                                                  input_size))
        self.weight_hh = nn.Parameter(torch.empty(gates * hidden, hidden))
        with torch.no_grad():
            for g in range(gates):
                rows = slice(g * hidden, (g + 1) * hidden)
                lecun_normal_(self.weight_ih[rows], generator)
                nn.init.orthogonal_(self.weight_hh[rows],
                                    generator=generator)
        if cell == "gru":
            self.bias_ih = nn.Parameter(torch.zeros(3 * hidden))
            self.bias_hn = nn.Parameter(torch.zeros(hidden))
        else:
            self.bias_hh = nn.Parameter(torch.zeros(4 * hidden))

    def weights(self):
        """[w_ih, w_hh, b_ih, b_hh] in torch's layout, flax's absent
        biases as zeros."""
        if self.cell == "gru":
            b_hh = torch.cat([self.bias_hn.new_zeros(2 * self.hidden),
                              self.bias_hn])
            return [self.weight_ih, self.weight_hh, self.bias_ih, b_hh]
        return [self.weight_ih, self.weight_hh,
                torch.zeros_like(self.bias_hh), self.bias_hh]

    def forward(self, x):
        """One cuDNN (or CPU) call over batch-first x. cuDNN keeps the
        reserve space a backward needs only in its 'train' mode, taken
        whenever autograd records. The weights are separate tensors,
        which cuDNN copies into one buffer per call (a few MB; its
        warning about it is silenced)."""
        x = x.float()
        h0 = x.new_zeros(1, x.shape[0], self.hidden)
        train = torch.is_grad_enabled()
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "RNN module weights are not",
                                    UserWarning)
            if self.cell == "lstm":
                return torch.lstm(x, (h0, h0), self.weights(), True, 1,
                                  0.0, train, False, True)[0]
            return torch.gru(x, h0, self.weights(), True, 1, 0.0, train,
                             False, True)[0]

    def step(self, x, carry):
        """One time step: x [B, in] and the carry (h for a GRU, (h, c)
        for an LSTM) -> the new carry."""
        if self.cell == "gru":
            return torch.gru_cell(x.float(), carry, *self.weights())
        return torch.lstm_cell(x.float(), carry, *self.weights())

    def load_flax(self, tree):
        """Copy a flax cell's params ({'ir': {'kernel', 'bias'}, ...},
        numpy or jax arrays) into this module."""
        sd = flax_cell_to_torch(tree, self.cell)
        with torch.no_grad():
            for k, v in sd.items():
                getattr(self, k).copy_(v)
        return self


def flax_cell_to_torch(tree, cell):
    """A flax GRU / LSTM cell's params -> this port's ``FlaxRNN`` tensors
    (kernels [in, H] transposed and stacked in torch's gate order)."""
    gates = FLAX_GATES[cell]

    def kern(name):
        return np.asarray(tree[name]["kernel"], np.float32).T

    def bias(name):
        return np.asarray(tree[name]["bias"], np.float32)

    out = {"weight_ih": np.concatenate([kern(i) for i, _ in gates]),
           "weight_hh": np.concatenate([kern(h) for _, h in gates])}
    if cell == "gru":
        out["bias_ih"] = np.concatenate([bias(i) for i, _ in gates])
        out["bias_hn"] = bias("hn")
    else:
        out["bias_hh"] = np.concatenate([bias(h) for _, h in gates])
    return {k: torch.tensor(v) for k, v in out.items()}


def torch_cell_to_flax(sd):
    """The inverse: {'weight_ih', 'weight_hh', 'bias_ih' and 'bias_hn' |
    'bias_hh'} (numpy) -> {'<dense>/kernel' | '<dense>/bias': array}."""
    cell = "gru" if "bias_hn" in sd else "lstm"
    gates = FLAX_GATES[cell]
    h = sd["weight_hh"].shape[1]
    out = {}
    for g, (i_name, h_name) in enumerate(gates):
        rows = slice(g * h, (g + 1) * h)
        out[f"{i_name}/kernel"] = sd["weight_ih"][rows].T
        out[f"{h_name}/kernel"] = sd["weight_hh"][rows].T
        if cell == "gru":
            out[f"{i_name}/bias"] = sd["bias_ih"][rows]
        else:
            out[f"{h_name}/bias"] = sd["bias_hh"][rows]
    if cell == "gru":
        out["hn/bias"] = sd["bias_hn"]
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


class PatternedDropout(nn.Module):
    """Dropout restricted to a fixed channel subset for the whole run
    (``pase_tpu/nn.py`` PatternedDropout), on [B, C, T] in train mode:
    'fixed_rand' may drop only C - int(C ratio_fixed) channels, picked
    with ``np.random.RandomState(0)`` (the JAX package's channels);
    'fixed_given' every channel outside ``range_fixed`` "beg:end"; 'std'
    every channel (plain dropout). A droppable value is kept with
    probability 1 - p and scaled by 1 / (1 - p); ``drop_whole_channels``
    draws one keep per (sample, channel) instead of per (sample, channel,
    frame), except in 'std' mode, as in JAX. As in JAX, the channels are
    picked (and a 'fixed_rand' without ``ratio_fixed`` or an unknown mode
    refused) at the first train call with p > 0, into ``droppable``
    [C, 1] (1 = droppable).

    The keep draws come from ``dropout_generator`` (None: torch's global
    generator), or from ``keep`` when a harness injects it (a bool tensor
    of the draw's shape, [B, C, T] or [B, C, 1]); the last call's is kept
    in ``last_keep``."""

    def __init__(self, emb_size, p=0.5, dropout_mode="fixed_rand",
                 ratio_fixed=None, range_fixed=None,
                 drop_whole_channels=False):
        super().__init__()
        self.emb_size = emb_size
        self.p = p
        self.dropout_mode = dropout_mode
        self.ratio_fixed = ratio_fixed
        self.range_fixed = range_fixed
        self.drop_whole_channels = drop_whole_channels
        self.droppable = None
        self.dropout_generator = None
        self.keep = self.last_keep = None

    def _droppable(self, device):
        c = self.emb_size
        if self.dropout_mode == "fixed_rand":
            assert self.ratio_fixed is not None
            n_drop = int(c - c * self.ratio_fixed)
            sel = np.sort(np.random.RandomState(0).choice(
                c, size=n_drop, replace=False))
        elif self.dropout_mode == "fixed_given":
            beg, end = (int(v) for v in self.range_fixed.split(":")[:2])
            sel = np.setdiff1d(np.arange(c), np.arange(beg, end))
        else:
            raise ValueError(self.dropout_mode)
        chan = np.zeros((c,), np.float32)
        chan[sel] = 1.0
        return torch.from_numpy(chan)[:, None].to(device)

    def forward(self, x):
        if self.p <= 0 or not self.training:
            return x
        b, c, t = x.shape
        keep = self.keep
        if keep is None:
            whole = (self.drop_whole_channels
                     and self.dropout_mode != "std")
            shape = (b, c, 1) if whole else (b, c, t)
            keep = mesh.draw_rows(lambda m: torch.rand(
                (m,) + shape[1:], generator=self.dropout_generator,
                device=x.device), b) < 1.0 - self.p
        self.last_keep = keep
        if self.dropout_mode == "std":
            return torch.where(keep, x / (1.0 - self.p), 0.0).to(x.dtype)
        if self.droppable is None or self.droppable.device != x.device:
            self.droppable = self._droppable(x.device)
        scale = 1.0 / (1.0 - self.p)
        factor = torch.where(self.droppable > 0, keep.to(x.dtype) * scale,
                             1.0).to(x.dtype)
        return x * factor


class MLPBlock(nn.Module):
    """Conv1d (kwidth ``context``, zero-padded to keep T) -> PReLU (init
    0.25) -> dropout, on [B, C, T]. ``din`` > 0 puts a
    ``PatternedDropout`` (``dropin_mode``, ``ratio_fixed``,
    ``range_fixed``, ``drop_channels``) on the input in train mode;
    ``tie_context_weights`` replaces the context conv by a 1x1 conv and a
    mean over the ``context`` frames around each frame (the frames
    outside T not counted). Under --n_model it may compute
    column-parallel (``tp_column``, ``parallel/tp.py``)."""

    tp_column = None

    def __init__(self, in_channels, fmaps, context=1, dout=0.0,
                 generator=None, din=0.0, dropin_mode="std",
                 ratio_fixed=None, range_fixed=None, drop_channels=False,
                 tie_context_weights=False):
        super().__init__()
        if context % 2 == 0:
            raise ValueError(f"MLPBlock context must be odd, got {context}")
        self.context = context
        self.tie = tie_context_weights
        if din > 0:
            self.din = PatternedDropout(
                in_channels, din, dropin_mode, ratio_fixed, range_fixed,
                drop_channels)
        else:
            self.din = None
        self.W = Conv1D(in_channels, fmaps, 1 if self.tie else context,
                        generator=generator)
        self.act = PReLU(fmaps, init=0.25)
        self.dout = dout
        self.dropout_generator = None   # the dout masks'

    def forward(self, x):
        if self.din is not None:
            x = self.din(x)
        x = tp.enter(self, x)
        if self.tie:
            h = F.avg_pool1d(self.W(x), self.context, stride=1,
                             padding=self.context // 2,
                             count_include_pad=False)
        else:
            if self.context > 1:
                x = F.pad(x, (self.context // 2, self.context // 2))
            h = self.W(x)
        return tp.leave(self, dropout(self.act(h), self.dout,
                                      self.dropout_generator, self.training,
                                      self))


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
    sample where stride and kwidth differ in parity -> norm -> PReLU, or
    glu over doubled channels. The norm is ``build_norm``'s (bnorm, lnorm,
    inorm, affinorm); a weight reparameterization raises TypeError, as in
    JAX. Under --n_model it may compute column-parallel (``tp_column``,
    ``parallel/tp.py``)."""

    tp_column = None

    def __init__(self, in_channels, fmaps, kwidth, stride=4, norm_type=None,
                 act=None, generator=None):
        super().__init__()
        wfmaps = 2 * fmaps if act == "glu" else fmaps
        pad = max(0, (stride - kwidth) // -2)
        self.trim = (stride % 2) != (kwidth % 2)
        self.deconv = Deconv1D(in_channels, wfmaps, kwidth, stride, pad,
                               generator=generator)
        self.norm = build_norm(norm_type, wfmaps)
        self.act = _activation(act, fmaps)

    def forward(self, x):
        y = self.deconv(tp.enter(self, x))
        if self.trim:
            y = y[:, :, :-1]
        if self.norm is not None:
            y = self.norm(y)
        return tp.leave(self, _glu(y) if self.act is None else self.act(y))


@contextlib.contextmanager
def no_tf32():
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
    its codes in ``codes``. Under a process group of more than one rank
    the counts and code sums of a train call are the global batch's (one
    all_reduce), and so are the EMA update and the perplexity.

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
        with no_tf32():
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
        rows = flat.shape[0]
        with torch.no_grad():
            idx = self.nearest(flat)
            if self.training:
                enc = F.one_hot(idx, self.emb_K).to(flat.dtype)
                counts = enc.sum(dim=0)
                with no_tf32():
                    dw = enc.t() @ flat
                # the global batch's counts and sums under a process group
                mesh.all_reduce_([counts, dw])
                rows *= mesh.data_world()
                g = self.gamma
                size = self.ema_cluster_size * g + (1 - g) * counts
                n = size.sum()
                size = (size + self.eps) / (n + self.emb_K * self.eps) * n
                new_w = self.ema_w * g + (1 - g) * dw
                self.ema_cluster_size.copy_(size)
                self.ema_w.copy_(new_w)
                self.emb.copy_(new_w / size[:, None])
            else:
                counts = torch.bincount(idx, minlength=self.emb_K).to(
                    flat.dtype)
            q = self.emb[idx].reshape(b, t, d)
            p = counts / rows
            self.perplexity = torch.exp(-torch.sum(p * torch.log(p + 1e-10)))
        self.codes = idx
        self.loss = self.beta * torch.mean(torch.square(q - x))
        return x + (q - x).detach()
