"""Adversarial (GAN) workers of the port: the discriminators and the GAN
objectives (``pase_tpu/adversarial.py``).

* ``WaveDiscriminator``: a strided waveform decimator of spectral-norm
  convs (reflect pad -> ``SNConv1D`` -> PReLU 0.25 per layer), the mean
  over time, a 1x1 ``SNConv1D`` ``out_fc``, and with a ``cond`` hidden the
  bilinear projection head ``proj_W`` on the two means.
* ``ZDiscriminator``: a frame-wise MLP (256, 256, PReLU 0.25, a linear
  logit) that judges encoder embeddings against a prior.
* ``gan_labels``, ``d_loss_fn``, ``g_loss_fn``: the L2 / LSGAN, BCE / GAN
  and Hinge objectives, with the JAX package's labels (LSGAN: real 1,
  fake -1, generator 0).

Layouts are the port's: waveforms [B, T] or [B, 1, T], hiddens [B, D, F].
Module and parameter names are the JAX ones (``dec_{i}``, ``act_{i}``,
``out_fc``, ``proj_W``; ``fc_{i}``, ``out``), so the weight bridge carries
``d_params`` / ``d_batch_stats`` (each SN conv's ``u``) both ways.
Parameters are drawn on the CPU from the generator passed in.
"""

import math

import torch
from torch import nn

from pase_tpu_torch.losses import bce_with_logits
from pase_tpu_torch.nn import PReLU, SNConv1D, _uniform_
from pase_tpu_torch.ops.pad import pad_1d

class Dense(nn.Linear):
    """flax Dense: the torch-default uniform(+-1/sqrt(in)) init for the
    weight and the bias, drawn from ``generator``."""

    def __init__(self, in_features, out_features, bias=True,
                 generator=None):
        super().__init__(in_features, out_features, bias=bias)
        bound = 1.0 / math.sqrt(in_features)
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)


class WaveDiscriminator(nn.Module):
    """Waveform discriminator: [B, T] or [B, 1, T] (with ``cond`` [B, D, F])
    -> [B, 1] logits. Each layer pads (kwidth // 2 - 1, kwidth // 2) where
    the stride is above 1 or the kwidth even, else kwidth // 2 a side,
    with reflection (JAX's rule); ``cond_dim`` builds the conditional
    head."""

    def __init__(self, fmaps=(128, 128, 256, 256, 512, 100),
                 strides=(10, 4, 4, 1, 1, 1), kwidths=(30, 30, 30, 3, 3, 3),
                 cond_dim=None, generator=None):
        super().__init__()
        self.pads = []
        cin = 1
        for i, (fm, kw, st) in enumerate(zip(fmaps, kwidths, strides)):
            self.pads.append((kw // 2 - 1, kw // 2) if st > 1 or kw % 2 == 0
                             else (kw // 2, kw // 2))
            setattr(self, f"dec_{i}", SNConv1D(cin, fm, kw, st,
                                               generator=generator))
            setattr(self, f"act_{i}", PReLU(fm, init=0.25))
            cin = fm
        self.depth = len(self.pads)
        self.proj_W = (Dense(cond_dim, cond_dim, bias=False,
                             generator=generator)
                       if cond_dim is not None else None)
        self.out_fc = SNConv1D(cin, 1, 1, generator=generator)

    def forward(self, x, cond=None):
        h = x[:, None, :] if x.dim() == 2 else x
        for i, pad in enumerate(self.pads):
            h = pad_1d(h, pad, "reflect")
            h = getattr(self, f"act_{i}")(getattr(self, f"dec_{i}")(h))
        hmean = h.mean(dim=2, keepdim=True)                   # [B, F, 1]
        y = self.out_fc(hmean)[:, :, 0]                       # [B, 1]
        if cond is None:
            return y
        if self.proj_W is None:
            raise ValueError("WaveDiscriminator built without cond_dim "
                             "got a cond")
        proj = self.proj_W(cond.mean(dim=2))                  # [B, D]
        return y + torch.sum(hmean[:, :, 0] * proj, dim=-1, keepdim=True)


class ZDiscriminator(nn.Module):
    """Latent discriminator: embeddings [B, D, F] -> [B, F, 1] logits,
    frame by frame: Dense -> PReLU (0.25) per hidden width, then a Dense
    to one logit (taken on the [B, C, F] layout, so each PReLU is a
    channel-first module as elsewhere in the port)."""

    def __init__(self, emb_dim, hidden=(256, 256), generator=None):
        super().__init__()
        self.depth = len(hidden)
        cin = emb_dim
        for i, hd in enumerate(hidden):
            setattr(self, f"fc_{i}", Dense(cin, hd, generator=generator))
            setattr(self, f"act_{i}", PReLU(hd, init=0.25))
            cin = hd
        self.out = Dense(cin, 1, generator=generator)

    @staticmethod
    def _frames(dense, x):
        return torch.matmul(dense.weight, x) + dense.bias[:, None]

    def forward(self, h):
        x = h
        for i in range(self.depth):
            x = getattr(self, f"act_{i}")(
                self._frames(getattr(self, f"fc_{i}"), x))
        return self._frames(self.out, x).transpose(1, 2)


def gan_labels(loss_type):
    """(real, fake, generator) target labels."""
    if loss_type in ("L2", "LSGAN"):
        return 1.0, -1.0, 0.0
    if loss_type in ("BCE", "GAN"):
        return 1.0, 0.0, 1.0
    raise ValueError(loss_type)


def d_loss_fn(d_real, d_fake, loss_type):
    """The discriminator's objective."""
    if loss_type == "Hinge":
        return (torch.mean(torch.relu(1.0 - d_real))
                + torch.mean(torch.relu(1.0 + d_fake)))
    rl, fk, _ = gan_labels(loss_type)
    if loss_type in ("L2", "LSGAN"):
        return (torch.mean(torch.square(d_real - rl))
                + torch.mean(torch.square(d_fake - fk)))
    return (bce_with_logits(d_real, torch.full_like(d_real, rl))
            + bce_with_logits(d_fake, torch.full_like(d_fake, fk)))


def g_loss_fn(d_on_fake, loss_type):
    """The generator's objective: D(fake) should look real."""
    if loss_type == "Hinge":
        return -torch.mean(d_on_fake)
    _, _, gl = gan_labels(loss_type)
    if loss_type in ("L2", "LSGAN"):
        return torch.mean(torch.square(d_on_fake - gl))
    return bce_with_logits(d_on_fake, torch.full_like(d_on_fake, gl))
