"""WaveRNN vocoder worker (RAW / MOL modes) in PyTorch.

The port of ``pase_tpu/wavernn.py`` (fatchord's WaveRNN, as the reference
minion): an upsampling conditioning network brings PASE frames to the
sample rate, two flax-cell GRUs (``nn.FlaxRNN``: cuDNN on the card) run
over the samples, teacher-forced in training, and three Denses predict
2^bits mu-law classes (RAW) or a discretized mixture of 10 logistics
(MOL, 30 outputs).

* ``MelResNet``   — a k = 2 pad + 1 conv without bias, BatchNorm, relu,
                    ``res_blocks`` 1x1 conv-BN-relu-conv-BN residuals, a
                    1x1 ``conv_out`` with bias; the convs and BatchNorms
                    follow the compute-dtype policy as the JAX ones do.
* ``stretch_time`` / ``UpsampleNetwork`` — repeat along time; per scale
                    a stretch and a smoothing kernel ``up_{i}_kernel``
                    [k, 1, 1] (a trainable parameter, 1/k at init, shared
                    by every channel, a cross-correlation after zero
                    padding by the scale), trimmed by pad * prod(scales)
                    samples at both ends.
* ``WaveRNNMinion`` — the head; its Denses and GRUs run in float32 under
                    any policy (flax modules without a dtype promote to
                    their float32 parameters).
* ``encode_mu_law`` / ``decode_mu_law``, ``raw_loss``,
  ``discretized_mix_logistic_loss`` (PixelCNN++), ``sample_from_
  discretized_mix_logistic``, ``generate`` (the autoregressive loop, one
  GRU cell step a sample) and the numpy ``fold_with_overlap`` /
  ``xfade_and_unfold``.

Each relu is an ``nn.ReLU`` module of its own, so that a parity harness
can read and force its kink (``grad_parity.prelu_signs``).

Layout: the conditioning frames come in the port's head layout [B, D, F]
(NCT); the upsampled streams and everything after are batch-first
[B, T, C], as the GRUs read them. Every draw comes from the
``torch.Generator`` the caller passes.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pase_tpu_torch.nn import BatchNorm1d, Conv1D, FlaxRNN, flax_dense


class MelResNet(nn.Module):
    """1x1 residual conditioning trunk: [B, D, F] -> [B, res_out_dims,
    F - 2 pad]."""

    def __init__(self, in_dims, compute_dims=128, res_out_dims=128,
                 res_blocks=10, pad=2, generator=None):
        super().__init__()
        self.res_blocks = res_blocks
        self.conv_in = Conv1D(in_dims, compute_dims, 2 * pad + 1, bias=False,
                              generator=generator)
        self.bn_in = BatchNorm1d(compute_dims)
        self.act_in = nn.ReLU()
        for i in range(res_blocks):
            for j in (1, 2):
                self.add_module(f"res_{i}_conv{j}", Conv1D(
                    compute_dims, compute_dims, 1, bias=False,
                    generator=generator))
                self.add_module(f"res_{i}_bn{j}", BatchNorm1d(compute_dims))
            self.add_module(f"res_{i}_act", nn.ReLU())
        self.conv_out = Conv1D(compute_dims, res_out_dims, 1,
                               generator=generator)

    def forward(self, m):
        h = self.act_in(self.bn_in(self.conv_in(m)))
        for i in range(self.res_blocks):
            y = getattr(self, f"res_{i}_act")(getattr(self, f"res_{i}_bn1")(
                getattr(self, f"res_{i}_conv1")(h)))
            y = getattr(self, f"res_{i}_bn2")(
                getattr(self, f"res_{i}_conv2")(y))
            h = y + h
        return self.conv_out(h)


def stretch_time(x, scale, dim=-1):
    """Repeat every step of x ``scale`` times along ``dim`` (time)."""
    return torch.repeat_interleave(x, scale, dim=dim)


class UpsampleNetwork(nn.Module):
    """[B, D, F + 2 pad] frames -> (mels [B, F prod(scales), D], aux
    [B, F prod(scales), res_out_dims]), batch-first."""

    def __init__(self, in_dims, upsample_scales=(4, 4, 10), compute_dims=128,
                 res_blocks=10, res_out_dims=128, pad=2, generator=None):
        super().__init__()
        self.scales = tuple(upsample_scales)
        self.pad = pad
        self.resnet = MelResNet(in_dims, compute_dims, res_out_dims,
                                res_blocks, pad, generator=generator)
        for i, scale in enumerate(self.scales):
            k = 2 * scale + 1
            self.register_parameter(f"up_{i}_kernel", nn.Parameter(
                torch.full((k, 1, 1), 1.0 / k)))

    def forward(self, m):
        total = int(np.prod(self.scales))
        indent = self.pad * total
        aux = stretch_time(self.resnet(m), total)
        h = m
        for i, scale in enumerate(self.scales):
            h = stretch_time(h, scale)
            kern = getattr(self, f"up_{i}_kernel")
            b, d, t = h.shape
            hp = F.pad(h.reshape(b * d, 1, t), (scale, scale))
            h = F.conv1d(hp, kern.reshape(1, 1, -1)).reshape(b, d, t)
        if indent:
            h = h[:, :, indent:-indent]
        return h.transpose(1, 2), aux.transpose(1, 2)


class WaveRNNMinion(nn.Module):
    """Sample-level vocoder head. ``forward(x, mels)``: the previous
    samples x [B, T] and the edge-padded frames mels [B, D, T / prod(
    scales) + 2 pad] -> logits [B, T, n_classes]. The frames' width D is
    ``in_channels`` (the JAX module infers it; ``num_inputs`` and
    ``hop_length`` are accepted and unused, as there)."""

    def __init__(self, in_channels, num_inputs=256, rnn_dims=512,
                 fc_dims=512, bits=9, hop_length=160, mode="RAW", pad=2,
                 upsample_scales=(4, 4, 10), res_out_dims=128,
                 generator=None):
        super().__init__()
        self.mode, self.bits, self.rnn_dims = mode, bits, rnn_dims
        self.aux_dims = res_out_dims // 4
        self.n_classes = 2 ** bits if mode == "RAW" else 30
        d = self.aux_dims
        self.upsample = UpsampleNetwork(in_channels, upsample_scales,
                                        res_out_dims=res_out_dims, pad=pad,
                                        generator=generator)
        self.I = flax_dense(1 + in_channels + d, rnn_dims, generator)
        self.rnn1_cell = FlaxRNN(rnn_dims, rnn_dims, "gru", generator)
        self.rnn2_cell = FlaxRNN(rnn_dims + d, rnn_dims, "gru", generator)
        self.fc1 = flax_dense(rnn_dims + d, fc_dims, generator)
        self.fc2 = flax_dense(fc_dims + d, fc_dims, generator)
        self.fc3 = flax_dense(fc_dims, self.n_classes, generator)
        self.act1, self.act2 = nn.ReLU(), nn.ReLU()

    def conditioning(self, mels):
        """(mels_up [B, T, D], (a1, a2, a3, a4) each [B, T, aux_dims])."""
        mels_up, aux = self.upsample(mels)
        d = self.aux_dims
        return mels_up, tuple(aux[..., i * d:(i + 1) * d].float()
                              for i in range(4))

    def head(self, h, a3, a4):
        """fc1 -> relu -> fc2 -> relu -> fc3 on the second GRU's output."""
        h = self.act1(self.fc1(torch.cat([h, a3], dim=-1)))
        h = self.act2(self.fc2(torch.cat([h, a4], dim=-1)))
        return self.fc3(h)

    def forward(self, x, mels):
        mels_up, (a1, a2, a3, a4) = self.conditioning(mels)
        h = self.I(torch.cat([x[..., None].float(), mels_up.float(), a1],
                             dim=-1))
        h = self.rnn1_cell(h) + h
        h = self.rnn2_cell(torch.cat([h, a2], dim=-1)) + h
        return self.head(h, a3, a4)


# ---------------------------------------------------------------------------
# losses / codecs
# ---------------------------------------------------------------------------


def encode_mu_law(x, mu):
    """mu-law class of each sample of x in [-1, 1]: int64 in [0, mu)."""
    mu = mu - 1
    fx = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / math.log1p(mu)
    return torch.floor((fx + 1) / 2 * mu + 0.5).long()


def decode_mu_law(y, mu, from_labels=True):
    mu = mu - 1
    if from_labels:
        y = 2.0 * y / mu - 1.0
    return torch.sign(y) / mu * ((1 + mu) ** torch.abs(y) - 1)


def raw_loss(logits, target_wav, bits=9):
    """Cross entropy on mu-law classes (RAW mode). A target outside [-1,
    1] has no class: its term is NaN, as JAX's out-of-range gather
    fills."""
    labels = encode_mu_law(target_wav, 2 ** bits)
    n = logits.shape[-1]
    inside = (labels >= 0) & (labels < n)
    logp = F.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, labels.clamp(0, n - 1)[..., None])[..., 0]
    picked = torch.where(inside, picked, torch.full_like(picked, math.nan))
    return -picked.mean()


def discretized_mix_logistic_loss(logits, target, num_classes=65536):
    """MoL negative log-likelihood (PixelCNN++): log scales floored at
    -7, the CDF differences clamped at 1e-12, the edge classes below
    -0.999 and above 0.999."""
    nr_mix = logits.shape[-1] // 3
    logit_probs = logits[..., :nr_mix]
    means = logits[..., nr_mix:2 * nr_mix]
    log_scales = torch.clamp(logits[..., 2 * nr_mix:], min=-7.0)
    y = target[..., None]
    centered = y - means
    inv = torch.exp(-log_scales)
    plus = torch.sigmoid(inv * (centered + 1.0 / (num_classes - 1)))
    minus = torch.sigmoid(inv * (centered - 1.0 / (num_classes - 1)))
    cdf_delta = plus - minus
    mid = inv * centered
    log_pdf_mid = mid - log_scales - 2.0 * F.softplus(mid)
    log_cdf_plus = torch.log(torch.clamp(plus, min=1e-12))
    log_one_minus = torch.log(torch.clamp(1.0 - minus, min=1e-12))
    inner = torch.where(
        cdf_delta > 1e-5, torch.log(torch.clamp(cdf_delta, min=1e-12)),
        log_pdf_mid - math.log((num_classes - 1) / 2.0))
    log_probs = torch.where(y < -0.999, log_cdf_plus,
                            torch.where(y > 0.999, log_one_minus, inner))
    log_probs = log_probs + F.log_softmax(logit_probs, dim=-1)
    return -torch.logsumexp(log_probs, dim=-1).mean()


def categorical(logits, generator=None):
    """One class per row of logits [..., C], drawn by Gumbel-max from
    ``generator``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    return torch.argmax(logits + gumbel, dim=-1)


def sample_from_discretized_mix_logistic(logits, generator=None):
    """A sample in [-1, 1] per row of MoL logits [..., 30]: a component
    by its mixture logits, then its logistic's inverse CDF at u in
    [1e-5, 1 - 1e-5]."""
    nr_mix = logits.shape[-1] // 3
    comp = categorical(logits[..., :nr_mix], generator)[..., None]
    means = logits[..., nr_mix:2 * nr_mix].gather(-1, comp)[..., 0]
    log_scales = torch.clamp(
        logits[..., 2 * nr_mix:].gather(-1, comp)[..., 0], min=-7.0)
    u = torch.rand(means.shape, generator=generator, device=logits.device)
    u = 1e-5 + u * (1.0 - 2e-5)
    x = means + torch.exp(log_scales) * (torch.log(u) - torch.log1p(-u))
    return torch.clamp(x, -1.0, 1.0)


def generate(module, mels, generator=None, mode="RAW", bits=9,
             return_logits=False):
    """Autoregressive sampling, one sample at a time, from the frames mels
    [B, D, F + 2 pad]: the conditioning once (BatchNorm in eval), then per
    sample the Dense I, the two GRU cells (the trained weights, stepped),
    the head and a draw from ``generator``. RAW draws a class and feeds
    back 2 cls / (2^bits - 1) - 1, decoded by ``decode_mu_law`` at the
    end; MOL a sample of the mixture. Returns the waveform [B, T]; with
    ``return_logits`` (wav, the fed-back samples [B, T], the logits
    [B, T, n_classes])."""
    was_training = module.training
    module.eval()
    try:
        with torch.no_grad():
            mels_up, auxs = module.conditioning(mels)
            b, t, _ = mels_up.shape
            x = mels_up.new_zeros(b)
            h1 = mels_up.new_zeros(b, module.rnn_dims)
            h2 = mels_up.new_zeros(b, module.rnn_dims)
            samples, logits_t = [], []
            for i in range(t):
                a1, a2, a3, a4 = (a[:, i] for a in auxs)
                xi = module.I(torch.cat([x[:, None], mels_up[:, i].float(),
                                         a1], dim=-1))
                h1 = module.rnn1_cell.step(xi, h1)
                x1 = xi + h1
                h2 = module.rnn2_cell.step(torch.cat([x1, a2], dim=-1), h2)
                logits = module.head(x1 + h2, a3, a4)
                if mode == "RAW":
                    cls = categorical(logits, generator)
                    x = 2.0 * cls.float() / (2 ** bits - 1) - 1.0
                else:
                    x = sample_from_discretized_mix_logistic(logits,
                                                             generator)
                samples.append(x)
                if return_logits:
                    logits_t.append(logits)
    finally:
        module.train(was_training)
    fed = torch.stack(samples, dim=1)
    wav = decode_mu_law(fed, 2 ** bits, from_labels=False) \
        if mode == "RAW" else fed
    if return_logits:
        return wav, fed, torch.stack(logits_t, dim=1)
    return wav


def fold_with_overlap(x, target, overlap):
    """[T, D] -> [folds, target + 2 overlap, D] (numpy), zero-padded at
    the end, for batched generation."""
    total, feats = x.shape
    num_folds = (total - overlap) // (target + overlap)
    extended = num_folds * (overlap + target) + overlap
    remaining = total - extended
    if remaining != 0:
        num_folds += 1
        pad = target + 2 * overlap - remaining
        x = np.concatenate([x, np.zeros((pad, feats), x.dtype)])
    out = np.zeros((num_folds, target + 2 * overlap, feats), x.dtype)
    for i in range(num_folds):
        start = i * (target + overlap)
        out[i] = x[start:start + target + 2 * overlap]
    return out


def xfade_and_unfold(y, overlap):
    """[folds, T] -> [total] (numpy float64): the folds overlap-added
    with an equal-power crossfade (silence, then a sqrt ramp)."""
    num_folds, length = y.shape
    target = length - 2 * overlap
    total = num_folds * (target + overlap) + overlap
    silence_len = overlap // 2
    fade_len = overlap - silence_len
    t = np.linspace(-1, 1, fade_len, dtype=np.float64)
    fade_in = np.concatenate([np.zeros(silence_len), np.sqrt(0.5 * (1 + t))])
    fade_out = np.concatenate([np.sqrt(0.5 * (1 - t)), np.zeros(silence_len)])
    y = y.astype(np.float64).copy()
    y[:, :overlap] *= fade_in
    y[:, -overlap:] *= fade_out
    out = np.zeros(total)
    for i in range(num_folds):
        start = i * (target + overlap)
        out[start:start + length] += y[i]
    return out
