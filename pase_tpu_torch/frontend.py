"""The PASE waveform encoder ("frontend") in PyTorch.

``WaveFe`` is the encoder of ``pase_tpu.frontend``: SincNet first layer,
strided FeBlocks (stride product 160 -> 100 Hz frames at 16 kHz), optional
dense skips (mean-pooled to the output rate, then a bias-free 1x1
projection, summed or concatenated), optional window-2 QRNN context layer,
1x1 projection ``W`` to ``emb_dim``, optional affine-free BatchNorm output
normalization, optional tanh.

Internal layout is [B, C, T]; ``WaveFe`` returns [B, T', emb] like the JAX
module, and ``Encoder`` exposes the reference (B, 1, T) -> (B, emb, T')
contract ((1,1,100000) -> (1,256,625) for PASE+).
"""

import json

import numpy as np
import torch
from torch import nn

from pase_tpu_torch.nn import ROADMAP_OFF_SLICE, Conv1D, FeBlock, QRNN


def pool_to(skip, out_len):
    """Mean-pool a [B, C, T] skip down to out_len frames: factor = realized
    length ratio, trailing remainder dropped."""
    dfactor = skip.shape[2] // out_len
    if dfactor > 1:
        b, c, _ = skip.shape
        skip = skip[:, :, :out_len * dfactor]
        skip = skip.reshape(b, c, out_len, dfactor).mean(dim=3)
    return skip


def fuse_skip(y, skip, densemerge="sum"):
    """Fuse a (possibly higher-rate) [B, C, T] skip into y."""
    skip = pool_to(skip, y.shape[2])
    if densemerge == "concat":
        return torch.cat([y, skip], dim=1)
    if densemerge == "sum":
        return y + skip
    raise TypeError(f"Unknown densemerge: {densemerge}")


class WaveFe(nn.Module):
    """Convolutional front-end: waveform [B, T] -> features [B, T//160, emb].

    Constructor arguments mirror the reference JSON configs
    (cfg/frontend/*.cfg). Parameters are drawn from ``generator`` on the
    CPU; move the module to its device afterwards.
    """

    def __init__(self, num_inputs=1, sincnet=True,
                 kwidths=(251, 10, 5, 5, 5, 5, 5, 5),
                 strides=(1, 10, 2, 1, 2, 1, 2, 2),
                 dilations=(1, 1, 1, 1, 1, 1, 1, 1),
                 fmaps=(64, 64, 128, 128, 256, 256, 512, 512),
                 norm_type="bnorm", pad_mode="reflect", sr=16000,
                 emb_dim=256, rnn_dim=None, activation=None, rnn_pool=False,
                 rnn_layers=1, rnn_dropout=0.0, rnn_type="qrnn", vq_K=None,
                 norm_out=False, tanh_out=False, resblocks=False,
                 denseskips=False, densemerge="sum", generator=None):
        super().__init__()
        if resblocks:
            raise NotImplementedError(
                f"WaveFe resblocks are not ported yet: {ROADMAP_OFF_SLICE}")
        if vq_K is not None and vq_K > 0:
            raise NotImplementedError(
                f"WaveFe VQ (vq_K) is not ported yet: {ROADMAP_OFF_SLICE}")
        if rnn_pool and str(rnn_type).lower() != "qrnn":
            if str(rnn_type).lower() in ("lstm", "gru"):
                raise NotImplementedError(
                    f"WaveFe rnn_type={rnn_type!r} is not ported yet: "
                    f"{ROADMAP_OFF_SLICE}")
            raise TypeError(f"Unrecognized rnn type: {rnn_type}")
        if norm_out and norm_type != "bnorm":
            raise NotImplementedError(
                f"norm_out with norm_type={norm_type!r} is not ported yet: "
                f"{ROADMAP_OFF_SLICE}")
        if densemerge not in ("sum", "concat"):
            raise TypeError(f"Unknown densemerge: {densemerge}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.emb_dim = emb_dim
        self.densemerge = densemerge
        self.tanh_out = tanh_out
        nblocks = len(kwidths)
        self.output_dim = (emb_dim * nblocks
                           if denseskips and densemerge == "concat"
                           else emb_dim)
        blocks = []
        cin = num_inputs
        for i, (kw, st, dil, fm) in enumerate(zip(kwidths, strides,
                                                  dilations, fmaps)):
            blocks.append(FeBlock(cin, fm, kw, st, dil, pad_mode=pad_mode,
                                  act=activation, norm_type=norm_type,
                                  sincnet=sincnet and i == 0, sr=sr,
                                  generator=generator))
            cin = fm
        self.blocks = nn.ModuleList(blocks)
        self.rnn = None
        if rnn_pool:
            rnn_dim = rnn_dim if rnn_dim is not None else emb_dim
            self.rnn = QRNN(cin, rnn_dim, layers=rnn_layers,
                            dropout=rnn_dropout, generator=generator)
            cin = rnn_dim
        self.W = Conv1D(cin, emb_dim, 1, generator=generator)
        # a skip after every block but the last; the bias-free projection
        # is applied AFTER mean-pooling to the output rate (both linear, so
        # the same function at a fraction of the cost)
        self.denseskips = nn.ModuleList(
            [Conv1D(fm, emb_dim, 1, bias=False, generator=generator)
             for fm in fmaps[:nblocks - 1]] if denseskips else [])
        self.norm_out = (nn.BatchNorm1d(self.output_dim, affine=False)
                         if norm_out else None)

    def forward(self, wav):
        """wav: [B, T] or [B, 1, T] -> [B, T//prod(strides), output_dim]."""
        h = wav[:, None, :] if wav.dim() == 2 else wav
        dskips = []
        for i, block in enumerate(self.blocks):
            h = block(h)
            if i < len(self.denseskips):
                dskips.append(h)
        if self.rnn is not None:
            h = self.rnn(h.transpose(1, 2)).transpose(1, 2)
        y = self.W(h)
        for proj, dskip in zip(self.denseskips, dskips):
            y = fuse_skip(y, proj(pool_to(dskip, y.shape[2])),
                          self.densemerge)
        if self.norm_out is not None:
            y = self.norm_out(y)
        if self.tanh_out:
            y = torch.tanh(y)
        return y.transpose(1, 2)


def load_cfg(cfg):
    if isinstance(cfg, str):
        with open(cfg, "r") as f:
            cfg = json.load(f)
    return dict(cfg)


_WAVEFE_KEYS = {
    "num_inputs", "sincnet", "kwidths", "strides", "dilations", "fmaps",
    "norm_type", "pad_mode", "sr", "emb_dim", "rnn_dim", "activation",
    "rnn_pool", "rnn_layers", "rnn_dropout", "rnn_type", "vq_K",
    "norm_out", "tanh_out", "resblocks", "denseskips", "densemerge",
}
# other keys are ignored, as the JAX package's build_wavefe ignores them;
# among them the JAX-only evaluation switches qrnn_impl (which scan) and
# virtual_pads (an HBM-copy workaround), which do not change the function


def build_wavefe(cfg, generator=None):
    cfg = load_cfg(cfg)
    kwargs = {k: v for k, v in cfg.items() if k in _WAVEFE_KEYS}
    for seq_key in ("kwidths", "strides", "dilations", "fmaps"):
        if seq_key in kwargs:
            kwargs[seq_key] = tuple(kwargs[seq_key])
    return WaveFe(generator=generator, **kwargs)


def build_frontend_module(cfg, generator=None):
    """cfg -> encoder module (the 'name' dispatch of the reference
    wf_builder). Only WaveFe is ported so far."""
    cfg = load_cfg(cfg)
    name = cfg.get("name")
    if name in (None, "WaveFe"):
        return build_wavefe(cfg, generator)
    if name in ("tdnn", "asppRes", "Resnet50"):
        raise NotImplementedError(
            f"frontend {name!r} (pase_tpu/encoders.py) is not ported yet: "
            f"{ROADMAP_OFF_SLICE}")
    raise TypeError(f"Unrecognized frontend type: {name}")


def select_output(h, mode=None):
    """Eval-time output post-processing on (B, C, T)."""
    if mode == "avg_norm":
        return h - h.mean(dim=2, keepdim=True)
    if mode == "avg_concat":
        g = h.mean(dim=2, keepdim=True).expand_as(h)
        return torch.cat([h, g], dim=1)
    if mode == "avg_norm_concat":
        g = h.mean(dim=2, keepdim=True)
        return torch.cat([h - g, g.expand_as(h)], dim=1)
    return h


class Encoder:
    """Inference wrapper preserving the reference public API:

        fe = wf_builder('cfg/frontend/PASE+.cfg', device='cuda')
        fe.load_pretrained('FE_e199.ckpt', load_last=True)
        y = fe(x)          # x: (B, 1, T) or (B, T) -> (B, emb, T')

    Holds a WaveFe in eval mode on ``device`` (default: the card); its
    parameters are drawn from a ``torch.Generator`` seeded with ``seed``.
    Training goes through the WaveFe module itself, in train mode
    (``model.PASE``, ``trainer.Trainer``).
    """

    def __init__(self, cfg, device="cuda", seed=0):
        self.cfg = load_cfg(cfg)
        self.device = torch.device(device)
        generator = torch.Generator().manual_seed(seed)
        self.module = build_frontend_module(self.cfg, generator)
        self.module.eval().to(self.device)
        self.emb_dim = self.module.output_dim

    def load_pretrained(self, ckpt_path, load_last=True):
        """Load a native FE_e*.npz or a reference torch FE_e*.ckpt state
        dict; every key must match (strict)."""
        if not load_last:
            raise NotImplementedError(
                "partial (load_last=False) loads are not ported yet: "
                "ROADMAP.md, queue 1: checkpoint / resume")
        from pase_tpu_torch.checkpoint import load_frontend_ckpt
        load_frontend_ckpt(ckpt_path, self.module)
        return self

    def __call__(self, x, train=False, mode=None):
        if train:
            raise ValueError(
                "Encoder is the inference wrapper (train=False only); "
                "training goes through the module itself")
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                            dtype=torch.float32, device=self.device)
        squeeze_batch = False
        if x.dim() == 3:          # (B, 1, T) reference layout
            x = x[:, 0, :]
        elif x.dim() == 1:
            x = x[None]
            squeeze_batch = True
        with torch.no_grad():
            y = self.module(x).transpose(1, 2)        # (B, C, T')
            y = select_output(y, mode)
        return y[0] if squeeze_batch else y


def wf_builder(cfg, device="cuda", seed=0):
    """Frontend factory preserving the reference entrypoint. The encoder
    runs on the card unless ``device='cpu'`` asks for the CPU."""
    if cfg is None:
        raise ValueError("cfg cannot be None!")
    return Encoder(load_cfg(cfg), device, seed=seed)
