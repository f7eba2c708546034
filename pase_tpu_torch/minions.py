"""Worker ("minion") heads of the PASE worker bank, in PyTorch.

The heads of ``pase_tpu.minions`` that the workers+ bank reaches, in the
reference torch layout ([B, C, T], Conv1d heads) and with its parameter
names:

* ``MLPMinion``     — 1x1 (/context) conv MLP head with r-frame outputs;
                      ``return_linear=True`` hands the last hidden
                      activation and the final 1x1 conv's weight to a fused
                      head+loss (``losses.framed_mse_linear``).
* ``DecoderMinion`` — transposed-conv stack back to the waveform rate.
* ``SPCMinion``     — sequence predictive coding: (current frame, future
                      window) against (current frame, past window), BCE.
* ``GapMinion``     — temporal gap regression: a frame pair per sample,
                      predicts |a - b| / (T - 1).
* ``GRUMinion``     — ``hidden_layers`` flax-cell GRUs over time (one
                      direction, from h = 0; ``nn.FlaxRNN``), then a 1x1
                      conv.
* ``make_mi_samples`` / ``make_mi_labels`` — LIM / GIM pair synthesis.
* ``scale_grad``    — identity forward, gradient times alpha backward.

The SPC and Gap frame indices are drawn on the tensor's device from the
``torch.Generator`` the caller passes (the trainer seeds one per step
from (seed, step)), or injected (``idx``) by a parity harness.
"""

import torch
from torch import nn

from pase_tpu_torch.nn import Conv1D, FlaxRNN, GDeconv1DBlock, MLPBlock


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


class GRUMinion(nn.Module):
    """GRU head: [B, C, T] -> [B, num_outputs, T]. ``hidden_layers`` flax
    GRU cells of ``hidden_size`` scanned over time (``gru_{i}``), then
    the 1x1 conv ``W``. ``dropout`` and ``skip`` are accepted and unused,
    as in JAX."""

    def __init__(self, in_channels, num_outputs, hidden_size=256,
                 hidden_layers=2, dropout=0.0, skip=True, generator=None):
        super().__init__()
        self.hidden_layers = hidden_layers
        cin = in_channels
        for i in range(hidden_layers):
            self.add_module(f"gru_{i}", FlaxRNN(cin, hidden_size, "gru",
                                                generator=generator))
            cin = hidden_size
        self.W = Conv1D(cin, num_outputs, 1, generator=generator)

    def forward(self, x, alpha=1.0):
        h = scale_grad(x, alpha).transpose(1, 2)
        for i in range(self.hidden_layers):
            h = getattr(self, f"gru_{i}")(h)
        return self.W(h.transpose(1, 2))


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


def _mlp_head(in_channels, num_outputs, hidden_size, hidden_layers,
              dropout, generator):
    blocks = []
    cin = in_channels
    for _ in range(hidden_layers):
        blocks.append(MLPBlock(cin, hidden_size, dout=dropout,
                               generator=generator))
        cin = hidden_size
    return nn.ModuleList(blocks), Conv1D(cin, num_outputs, 1,
                                         generator=generator)


def spc_draw(frames, ctxt_frames, seq_pad, generator=None, device=None):
    """One SPC draw per batch, [t, future_t, past_t] (int64 on
    ``device``): t in [m + 1, T - m) with m = seq_pad + ctxt_frames, the
    future window's start in [t + seq_pad, T - N), the past window's end
    in [N, t - seq_pad) (``pase_tpu/minions.py`` SPCMinion). Raises
    where T leaves no t to draw."""
    n = ctxt_frames
    m = seq_pad + n
    if frames - m <= m + 1:
        raise ValueError(
            f"SPC needs more than 2 * (seq_pad + ctxt_frames) + 1 = "
            f"{2 * m + 1} frames, got {frames}")
    t = torch.randint(m + 1, frames - m, (), generator=generator,
                      device=device)
    u2 = torch.rand((), generator=generator, device=device)
    u3 = torch.rand((), generator=generator, device=device)
    ft = t + seq_pad + (u2 * ((frames - n) - (t + seq_pad))).long()
    pt = n + (u3 * ((t - seq_pad) - n)).long()
    return torch.stack([t, ft, pt])


class SPCMinion(nn.Module):
    """Sequence predictive coding head: [B, C, T] -> [2B, num_outputs, 1]
    logits, positives (the current frame t with the future window [ft,
    ft + N)) first, negatives (t with the past window [pt - N, pt)) after.
    A window flattens as its [C, N] slice, row-major: the JAX head's NTC
    window transposed to (C, N). Input width C * (1 + N)."""

    def __init__(self, in_channels, num_outputs, hidden_size=256,
                 hidden_layers=2, ctxt_frames=5, seq_pad=16, dropout=0.0,
                 skip=True, generator=None):
        super().__init__()
        self.ctxt_frames = ctxt_frames
        self.seq_pad = seq_pad
        self.blocks, self.W = _mlp_head(in_channels, num_outputs,
                                        hidden_size, hidden_layers, dropout,
                                        generator)

    def forward(self, x, alpha=1.0, generator=None, idx=None):
        """``idx`` injects [t, future_t, past_t]; else ``spc_draw`` draws
        them from ``generator``."""
        x = scale_grad(x, alpha)
        b, c, t = x.shape
        n = self.ctxt_frames
        if idx is None:
            idx = spc_draw(t, n, self.seq_pad, generator, x.device)
        idx = torch.as_tensor(idx, device=x.device).long()
        window = torch.arange(n, device=x.device)
        cur = x.index_select(2, idx[0:1])[:, :, 0]
        fut = x.index_select(2, idx[1] + window).reshape(b, c * n)
        past = x.index_select(2, idx[2] - n + window).reshape(b, c * n)
        h = torch.cat([torch.cat([cur, fut], dim=1),
                       torch.cat([cur, past], dim=1)], dim=0)[:, :, None]
        for block in self.blocks:
            h = block(h)
        return self.W(h)


def gap_draw(batch, frames, generator=None, device=None):
    """[2, B] frame pairs (a, b), each uniform in [0, T) (int64)."""
    return torch.randint(0, frames, (2, batch), generator=generator,
                         device=device)


class GapMinion(nn.Module):
    """Temporal gap regression head: [B, C, T] -> ([B, num_outputs, 1]
    predictions, [B, 1, 1] labels |a - b| / (T - 1)) for one frame pair
    (a, b) per sample, the pair's frames concatenated on channels (input
    width 2 C)."""

    def __init__(self, in_channels, num_outputs, hidden_size=256,
                 hidden_layers=2, dropout=0.0, skip=True, generator=None):
        super().__init__()
        self.blocks, self.W = _mlp_head(in_channels, num_outputs,
                                        hidden_size, hidden_layers, dropout,
                                        generator)

    def forward(self, x, alpha=1.0, generator=None, idx=None):
        """``idx`` injects the [2, B] pairs; else ``gap_draw`` draws them
        from ``generator``."""
        x = scale_grad(x, alpha)
        b, c, t = x.shape
        if idx is None:
            idx = gap_draw(b, t, generator, x.device)
        idx = torch.as_tensor(idx, device=x.device).long()

        def frame(i):
            return x.gather(2, i[:, None, None].expand(b, c, 1))

        dists = (torch.abs(idx[0] - idx[1]) / (t - 1)).to(torch.float32)
        h = torch.cat([frame(idx[0]), frame(idx[1])], dim=1)
        for block in self.blocks:
            h = block(h)
        return self.W(h), dists.reshape(b, 1, 1)


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
