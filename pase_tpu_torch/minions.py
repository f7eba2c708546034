"""Worker ("minion") heads of the PASE worker bank, in PyTorch.

The heads of ``pase_tpu.minions`` that the workers+ bank reaches, in the
reference torch layout ([B, C, T], Conv1d heads) and with its parameter
names:

* ``MLPMinion``     — 1x1 (/context) conv MLP head with r-frame outputs;
                      ``return_linear=True`` hands the last hidden
                      activation and the final 1x1 conv's weight to a fused
                      head+loss (``losses.framed_mse_linear``).
* ``DecoderMinion`` — transposed-conv stack back to the waveform rate.
* ``make_mi_samples`` / ``make_mi_labels`` — LIM / GIM pair synthesis.
* ``scale_grad``    — identity forward, gradient times alpha backward.

GRU, SPC and Gap heads are later work (ROADMAP.md, queue 1: off-path
model variants).
"""

import torch
from torch import nn

from pase_tpu_torch.nn import Conv1D, GDeconv1DBlock, MLPBlock


class _ScaleGrad(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.alpha, None


def scale_grad(x, alpha=1.0):
    """Identity on x; its gradient is multiplied by ``alpha`` (a float or
    a 0-d tensor; the reference's ScaleGrad)."""
    return _ScaleGrad.apply(x, alpha)


class MLPMinion(nn.Module):
    """Conv-MLP head: [B, C, T] -> [B, num_outputs * r, T]."""

    def __init__(self, in_channels, num_outputs, hidden_size=256,
                 hidden_layers=2, context=1, dropout=0.0, dropout_time=0.0,
                 r=1, skip=True, generator=None, **unported):
        super().__init__()
        _refuse(unported, "MLPMinion")
        if dropout_time > 0 and context > 1:
            raise NotImplementedError(
                "MLPMinion dropout_time is not ported yet: ROADMAP.md, "
                "queue 1: off-path model variants")
        blocks = []
        cin, ctx = in_channels, context
        for _ in range(hidden_layers):
            blocks.append(MLPBlock(cin, hidden_size, context=ctx,
                                   dout=dropout, generator=generator))
            cin, ctx = hidden_size, 1
        self.blocks = nn.ModuleList(blocks)
        self.context = ctx
        self.W = Conv1D(cin, num_outputs * r, ctx, generator=generator)

    def forward(self, x, alpha=1.0, return_linear=False):
        h = scale_grad(x, alpha)
        for block in self.blocks:
            h = block(h)
        if return_linear:
            if self.context != 1:
                raise ValueError("return_linear requires a kwidth-1 final "
                                 "conv (context==1 or hidden_layers>=1)")
            return ("linear", h, self.W.weight, self.W.bias)
        pad = self.context // 2
        if pad:
            h = nn.functional.pad(h, (pad, pad))
        return self.W(h)


class DecoderMinion(nn.Module):
    """Waveform decoder head: [B, C, T] -> [B, num_outputs,
    T * prod(strides)]. workers+ ``cchunk``: fmaps (512, 256, 128), strides
    (4, 4, 10), kwidth 30, one hidden MLP block, L1 loss."""

    def __init__(self, in_channels, num_outputs,
                 fmaps=(256, 256, 128, 128, 128, 64, 64),
                 strides=(2, 2, 2, 2, 2, 5), kwidths=(2, 2, 2, 2, 2, 5),
                 hidden_size=256, hidden_layers=2, dropout=0.0,
                 dropout_time=0.0, norm_type=None, skip=False,
                 generator=None):
        super().__init__()
        if dropout_time > 0:
            raise NotImplementedError(
                "DecoderMinion dropout_time is not ported yet: ROADMAP.md, "
                "queue 1: off-path model variants")
        blocks = []
        cin = in_channels
        for fm, kw, st in zip(fmaps, kwidths, strides):
            blocks.append(GDeconv1DBlock(cin, fm, kw, st, norm_type=norm_type,
                                         generator=generator))
            cin = fm
        for _ in range(hidden_layers):
            blocks.append(MLPBlock(cin, hidden_size, dout=dropout,
                                   generator=generator))
            cin = hidden_size
        self.blocks = nn.ModuleList(blocks)
        self.W = Conv1D(cin, num_outputs, 1, generator=generator)

    def forward(self, x, alpha=1.0):
        h = scale_grad(x, alpha)
        for block in self.blocks:
            h = block(h)
        return self.W(h)


def _refuse(kwargs, who):
    """Raise for a head option the port does not build; accept the
    reference defaults."""
    defaults = {"tie_context_weights": False, "dropin": 0.0,
                "dropin_mode": "std", "ratio_fixed": None,
                "range_fixed": None, "drop_channels": False}
    for k, v in kwargs.items():
        if k not in defaults:
            raise TypeError(f"{who}: unexpected argument {k!r}")
        if v != defaults[k]:
            raise NotImplementedError(
                f"{who} {k}={v!r} is not ported yet: ROADMAP.md, queue 1: "
                "off-path model variants")


def make_mi_samples(h_chunk, h_ctxt, h_rand, augment=False):
    """LIM/GIM positive / negative pairs: channel concat on [B, C, T]."""
    pos = torch.cat([h_chunk, h_ctxt], dim=1)
    neg = torch.cat([h_chunk, h_rand], dim=1)
    if augment:
        pos = torch.cat([pos, torch.cat([h_ctxt, h_chunk], dim=1)], dim=0)
        neg = torch.cat([neg, torch.cat([h_ctxt, h_rand], dim=1)], dim=0)
    return pos, neg


def make_mi_labels(y):
    """Ones for the first half of the batch (positives), zeros for the
    second."""
    half = y.shape[0] // 2
    return torch.cat([torch.ones((half,) + tuple(y.shape[1:]),
                                 dtype=y.dtype, device=y.device),
                      torch.zeros((half,) + tuple(y.shape[1:]),
                                  dtype=y.dtype, device=y.device)], dim=0)
