"""The alternative waveform encoders in PyTorch: TDNN (x-vector style),
ASPP-residual and a 1-D ResNet (the port of ``pase_tpu/encoders.py``).

Modules run on [B, C, T] and keep the JAX module and parameter names
(``tdnn.conv_0``, ``aspp_blocks_2.block1_aspp.aspp3``, ``layer3_1.proj``,
...), so the weight bridge of ``checkpoint.py`` maps them as it maps
WaveFe's. The three encoders take a waveform [B, T] or [B, 1, T] and
return [B, T', output_dim] like ``frontend.WaveFe``; ``hop`` is their
samples per frame (TDNNFe: the sinc stride, 160; ASPPResEncoder: the
sinc stride times the blocks' strides, 160 at its defaults;
ResnetEncoder: the sinc stride times ``conv_stride`` times the stage
strides, 5 x 1 x 2 x 2 x 2 = 40).

* ``StatisticalPooling`` — mean and unbiased std over time (the std over
  ``max(n - 1, 1)``: a single frame gives 0, not NaN).
* ``TDNN``        — five zero pad -> conv -> BatchNorm -> relu stages,
  then, by ``method``: ``unpooled`` (the frames), ``xvector`` (pooled,
  the first segment layer) or any other name (``cls``: both segment
  layers and a log-softmax over the outputs), as the JAX module reads it.
* ``TDNNFe``      — the sinc FeBlock, the unpooled TDNN, an optional
  context layer (``rnn_type`` qrnn: ``nn.QRNN`` of ``emb_dim``; lstm /
  gru: ``nn.BiRNN`` of ``emb_dim // 2`` each way), then the 1x1 ``W``.
* ``ASPPModule`` / ``ASPP`` — atrous branches plus a global-average
  branch, concatenated, a 1x1 projection, BatchNorm and relu, then in
  train mode dropout (0.5, the JAX module's rate, which its encoder never
  sets). The dropout masks come from ``dropout_generator`` (the trainer
  seeds one per step) or, without one, torch's global generator.
* ``ASPPResBlock`` / ``ASPPResEncoder`` — two ASPP + strided-conv stages
  summed; a SAME SincConv, the blocks, the ``concat`` levels mean-pooled
  onto the last level's frames (all-False: the trunk's output) and an
  optional QRNN of the output's width (``rnn_add`` adds it back).
* ``ResBlock1D`` / ``ResnetEncoder`` — sinc, a strided conv, residual
  stages with a 1x1 projection where the width or the stride changes,
  then a 1x1 ``head``.

Convs are ``nn.Conv1D`` and norms ``nn.BatchNorm1d``, so the compute-dtype
policy (``precision.py``) casts them as it casts WaveFe's. Every relu is
a module of its own (``act_0``, ``gap_act``, ...; no parameters), so a
parity harness can read and force its kink (``grad_parity.prelu_signs``).
Parameters are drawn from ``generator`` on the CPU; the owner moves the
module.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from pase_tpu_torch.nn import (BatchNorm1d, BiRNN, Conv1D,
                               DropoutGenerators, FeBlock, QRNN,
                               SincConv)
from pase_tpu_torch.parallel.mesh import draw_rows

# TDNN's stages: (fmaps, kwidth, dilation, zero pad each side)
TDNN_SPECS = ((512, 5, 1, 2), (512, 3, 2, 2), (512, 3, 3, 3),
              (512, 1, 1, 0), (1500, 1, 1, 0))

# the cfg keys each family takes (the JAX modules' fields); others are
# dropped, as the JAX dispatch drops them
TDNNFE_FIELDS = ("emb_dim", "kwidth", "stride", "fmaps", "sincnet",
                 "norm_type", "pad_mode", "sr", "rnn_pool", "rnn_layers",
                 "rnn_dropout", "rnn_type")
ASPP_RES_FIELDS = ("sinc_out", "hidden_dim", "kernel_sizes", "sinc_kernel",
                   "sinc_stride", "strides", "dilations", "fmaps", "concat",
                   "rnn_pool", "rnn_add")
RESNET_FIELDS = ("sinc_out", "hidden_dim", "sinc_kernel", "sinc_stride",
                 "conv_stride", "kernel_size", "stage_fmaps",
                 "stage_blocks", "stage_strides")


def _wav_nct(wav):
    return wav[:, None, :] if wav.dim() == 2 else wav


class _Encoder(DropoutGenerators, nn.Module):
    """What the trainer and the serving code read of any encoder: no VQ
    quantizer, so no commitment loss; one ``dropout_generator`` for its
    dropout masks."""

    quantizer = None
    vq_loss = None
    vq_perplexity = None


class StatisticalPooling(nn.Module):
    """[B, C, T] -> [B, 2C, 1]: the mean and the unbiased std over time."""

    def forward(self, x):
        mu = x.mean(dim=2, keepdim=True)
        n = x.shape[2]
        var = torch.square(x - mu).sum(dim=2, keepdim=True) / max(n - 1, 1)
        return torch.cat([mu, torch.sqrt(var)], dim=1)


class TDNN(nn.Module):
    """The x-vector TDNN trunk on [B, C, T], its widths TDNN_SPECS' (the
    JAX module's ``emb_dim`` field sets none of them and is left out)."""

    def __init__(self, in_channels, num_outputs=2, method="unpooled",
                 generator=None):
        super().__init__()
        self.method = method
        self.pads = [pad for _, _, _, pad in TDNN_SPECS]
        cin = in_channels
        for i, (fm, k, dil, _) in enumerate(TDNN_SPECS):
            self.add_module(f"conv_{i}", Conv1D(cin, fm, k, dilation=dil,
                                                generator=generator))
            self.add_module(f"bn_{i}", BatchNorm1d(fm))
            self.add_module(f"act_{i}", nn.ReLU())
            cin = fm
        self.output_dim = cin
        if method == "unpooled":
            return
        self.pool = StatisticalPooling()
        self.seg_0 = Conv1D(2 * cin, 512, 1, generator=generator)
        self.output_dim = 512
        if method == "xvector":
            return
        self.seg_bn_0 = BatchNorm1d(512)
        self.seg_act_0 = nn.ReLU()
        self.seg_1 = Conv1D(512, 512, 1, generator=generator)
        self.seg_bn_1 = BatchNorm1d(512)
        self.seg_act_1 = nn.ReLU()
        self.out = Conv1D(512, num_outputs, 1, generator=generator)
        self.output_dim = num_outputs

    def forward(self, x):
        h = x
        for i, pad in enumerate(self.pads):
            if pad:
                h = F.pad(h, (pad, pad))
            h = getattr(self, f"conv_{i}")(h)
            h = getattr(self, f"act_{i}")(getattr(self, f"bn_{i}")(h))
        if self.method == "unpooled":
            return h
        h = self.seg_0(self.pool(h))
        if self.method == "xvector":
            return h
        h = self.seg_act_0(self.seg_bn_0(h))
        h = self.seg_act_1(self.seg_bn_1(self.seg_1(h)))
        return torch.log_softmax(self.out(h), dim=1)


class TDNNFe(_Encoder):
    """TDNN front-end: sinc FeBlock -> unpooled TDNN -> optional context
    layer -> 1x1 W. [B, T] or [B, 1, T] -> [B, T // stride, emb_dim]."""

    def __init__(self, emb_dim=256, kwidth=641, stride=160, fmaps=128,
                 sincnet=True, norm_type="bnorm", pad_mode="reflect",
                 sr=16000, rnn_pool=False, rnn_layers=1, rnn_dropout=0.0,
                 rnn_type="qrnn", generator=None):
        super().__init__()
        rnn_type = str(rnn_type).lower()
        if rnn_pool and rnn_type not in ("qrnn", "lstm", "gru"):
            raise TypeError(f"Unrecognized rnn type: {rnn_type}")
        self.emb_dim = self.output_dim = emb_dim
        self.hop = stride if sincnet else 1
        self.feblock = None
        cin = 1
        if sincnet:
            self.feblock = FeBlock(1, fmaps, kwidth, stride,
                                   pad_mode=pad_mode, norm_type=norm_type,
                                   sincnet=True, sr=sr, generator=generator)
            cin = fmaps
        self.tdnn = TDNN(cin, method="unpooled", generator=generator)
        cin = self.tdnn.output_dim
        self.rnn = None
        if rnn_pool and rnn_type == "qrnn":
            # the reference's bidirectional QRNN doubles back to emb_dim
            self.rnn = QRNN(cin, emb_dim, layers=rnn_layers,
                            dropout=rnn_dropout, generator=generator)
            cin = emb_dim
        elif rnn_pool:
            self.rnn = BiRNN(cin, emb_dim // 2, layers=rnn_layers,
                             cell=rnn_type, dropout=rnn_dropout,
                             generator=generator)
            cin = 2 * (emb_dim // 2)
        self.W = Conv1D(cin, emb_dim, 1, generator=generator)

    def forward(self, wav):
        h = _wav_nct(wav)
        if self.feblock is not None:
            h = self.feblock(h)
        h = self.tdnn(h)
        if self.rnn is not None:
            h = self.rnn(h.transpose(1, 2)).transpose(1, 2)
        return self.W(h).transpose(1, 2)


class ASPPModule(nn.Module):
    """Atrous branch: zero pad -> dilated bias-free conv -> BatchNorm ->
    relu."""

    def __init__(self, in_channels, fmaps, kwidth, dilation, padding,
                 generator=None):
        super().__init__()
        self.padding = padding
        self.atrous_conv = Conv1D(in_channels, fmaps, kwidth,
                                  dilation=dilation, bias=False,
                                  generator=generator)
        self.bn = BatchNorm1d(fmaps)
        self.act = nn.ReLU()

    def forward(self, x):
        if self.padding:
            x = F.pad(x, (self.padding, self.padding))
        return self.act(self.bn(self.atrous_conv(x)))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling over time: four dilation branches
    and a global-average branch (mean over time, 1x1 conv, BatchNorm on
    [B, C, 1], relu, broadcast), concatenated, 1x1 projection, BatchNorm,
    relu, and in train mode dropout with masks from
    ``dropout_generator``."""

    def __init__(self, in_channels, emb_dim, dilations=(1, 6, 12, 18),
                 fmaps=48, dropout=0.5, generator=None):
        super().__init__()
        d = dilations
        self.aspp1 = ASPPModule(in_channels, fmaps, 1, d[0], 0, generator)
        self.aspp2 = ASPPModule(in_channels, fmaps, 3, d[1], d[1], generator)
        self.aspp3 = ASPPModule(in_channels, fmaps, 3, d[2], d[2], generator)
        self.aspp4 = ASPPModule(in_channels, fmaps, 3, d[3], d[3], generator)
        self.gap_conv = Conv1D(in_channels, fmaps, 1, bias=False,
                               generator=generator)
        self.gap_bn = BatchNorm1d(fmaps)
        self.gap_act = nn.ReLU()
        self.conv1 = Conv1D(5 * fmaps, emb_dim, 1, bias=False,
                            generator=generator)
        self.bn1 = BatchNorm1d(emb_dim)
        self.act1 = nn.ReLU()
        self.dropout = dropout
        self.dropout_generator = None     # the masks' (None: torch's global)

    def forward(self, x):
        branches = [self.aspp1(x), self.aspp2(x), self.aspp3(x),
                    self.aspp4(x)]
        g = self.gap_act(self.gap_bn(self.gap_conv(
            x.mean(dim=2, keepdim=True))))
        h = torch.cat(branches + [g.expand_as(branches[0])], dim=1)
        h = self.act1(self.bn1(self.conv1(h)))
        if self.dropout > 0 and self.training:
            keep = 1.0 - self.dropout
            mask = draw_rows(lambda m: torch.rand(
                (m,) + h.shape[1:], generator=self.dropout_generator,
                device=h.device), h.shape[0]) < keep
            h = torch.where(mask, h / keep, torch.zeros_like(h))
        return h


class ASPPResBlock(nn.Module):
    """Two stages (ASPP, zero pad kwidth // 2, bias-free conv, BatchNorm,
    relu), the first at ``stride``, summed."""

    def __init__(self, in_channels, out_channel, kwidth, stride,
                 dilations=(1, 6, 12, 18), fmaps=48, generator=None):
        super().__init__()
        self.pad = kwidth // 2
        cin = in_channels
        for name, st in (("block1", stride), ("block2", 1)):
            self.add_module(f"{name}_aspp", ASPP(cin, out_channel, dilations,
                                                 fmaps, generator=generator))
            self.add_module(f"{name}_conv", Conv1D(
                out_channel, out_channel, kwidth, st, bias=False,
                generator=generator))
            self.add_module(f"{name}_bn", BatchNorm1d(out_channel))
            self.add_module(f"{name}_act", nn.ReLU())
            cin = out_channel

    def _stage(self, h, name):
        h = getattr(self, f"{name}_aspp")(h)
        h = getattr(self, f"{name}_conv")(F.pad(h, (self.pad, self.pad)))
        return getattr(self, f"{name}_act")(getattr(self, f"{name}_bn")(h))

    def forward(self, x):
        out1 = self._stage(x, "block1")
        return out1 + self._stage(out1, "block2")


class ASPPResEncoder(_Encoder):
    """Sinc layer (SAME, reflect) + ASPP residual stack, the ``concat``
    levels pooled onto the last one's frames, optional QRNN pooling.
    [B, T] or [B, 1, T] -> [B, T // hop, output_dim]."""

    def __init__(self, sinc_out=64, hidden_dim=256,
                 kernel_sizes=(11, 11, 11, 11), sinc_kernel=251,
                 sinc_stride=1, strides=(10, 4, 2, 2),
                 dilations=(1, 6, 12, 18), fmaps=(48, 48, 48, 48),
                 concat=(False, False, False, True), rnn_pool=False,
                 rnn_add=False, generator=None):
        super().__init__()
        self.concat = tuple(bool(c) for c in concat)
        self.rnn_add = rnn_add
        self.hop = sinc_stride * math.prod(strides[:len(kernel_sizes)])
        self.output_dim = hidden_dim * max(sum(self.concat), 1)
        self.sinc = SincConv(sinc_out, sinc_kernel, sinc_stride)
        cin = sinc_out
        self.num_blocks = len(kernel_sizes)
        for i, k in enumerate(kernel_sizes):
            self.add_module(f"aspp_blocks_{i}", ASPPResBlock(
                cin, hidden_dim, k, strides[i], dilations, fmaps[i],
                generator=generator))
            cin = hidden_dim
        self.rnn = (QRNN(self.output_dim, self.output_dim,
                         generator=generator) if rnn_pool else None)

    def forward(self, wav):
        h = self.sinc(_wav_nct(wav))
        outs = []
        for i in range(self.num_blocks):
            h = getattr(self, f"aspp_blocks_{i}")(h)
            if self.concat[i]:
                outs.append(h)
        if not outs:
            # an all-False concat: the trunk's output (the last level)
            outs = [h]
        if len(outs) > 1:
            tlen = outs[-1].shape[2]
            pooled = []
            for o in outs:
                dfac = o.shape[2] // tlen
                o = o[:, :, :tlen * dfac]
                pooled.append(o.reshape(o.shape[0], o.shape[1], tlen,
                                        dfac).mean(dim=3))
            out = torch.cat(pooled, dim=1)
        else:
            out = outs[0]
        out = out.transpose(1, 2)
        if self.rnn is not None:
            rnn_out = self.rnn(out)
            out = out + rnn_out if self.rnn_add else rnn_out
        return out


class ResBlock1D(nn.Module):
    """Two zero-padded k=3 bias-free convs with BatchNorm, the first at
    ``stride``, plus the identity (a 1x1 strided projection with BatchNorm
    where the width or the stride changes), then relu."""

    def __init__(self, in_channels, fmaps, stride=1, generator=None):
        super().__init__()
        self.conv1 = Conv1D(in_channels, fmaps, 3, stride, bias=False,
                            generator=generator)
        self.bn1 = BatchNorm1d(fmaps)
        self.act1 = nn.ReLU()
        self.conv2 = Conv1D(fmaps, fmaps, 3, bias=False, generator=generator)
        self.bn2 = BatchNorm1d(fmaps)
        self.act2 = nn.ReLU()
        self.proj = self.proj_bn = None
        if in_channels != fmaps or stride != 1:
            self.proj = Conv1D(in_channels, fmaps, 1, stride, bias=False,
                               generator=generator)
            self.proj_bn = BatchNorm1d(fmaps)

    def forward(self, x):
        h = self.act1(self.bn1(self.conv1(F.pad(x, (1, 1)))))
        h = self.bn2(self.conv2(F.pad(h, (1, 1))))
        if self.proj is not None:
            x = self.proj_bn(self.proj(x))
        return self.act2(h + x)


class ResnetEncoder(_Encoder):
    """ResNet over the sinc-gram: SAME SincConv, a strided conv (64
    maps), residual stages, a 1x1 head. [B, T] or [B, 1, T] ->
    [B, T // hop, hidden_dim]."""

    def __init__(self, sinc_out=64, hidden_dim=256, sinc_kernel=251,
                 sinc_stride=1, conv_stride=5, kernel_size=21,
                 stage_fmaps=(64, 128, 256, 512), stage_blocks=(3, 4, 6, 3),
                 stage_strides=(1, 2, 2, 2), generator=None):
        super().__init__()
        self.output_dim = hidden_dim
        self.rnn = None
        stages = list(zip(stage_fmaps, stage_blocks, stage_strides))
        self.hop = sinc_stride * conv_stride * math.prod(
            st for _, _, st in stages)
        self.sinc = SincConv(sinc_out, sinc_kernel, sinc_stride)
        self.pad = kernel_size // 2
        self.conv1 = Conv1D(sinc_out, 64, kernel_size, conv_stride,
                            bias=False, generator=generator)
        self.bn1 = BatchNorm1d(64)
        self.act1 = nn.ReLU()
        cin = 64
        self.layer_names = []
        for si, (fm, nb, st) in enumerate(stages):
            for bi in range(nb):
                name = f"layer{si + 1}_{bi}"
                self.add_module(name, ResBlock1D(
                    cin, fm, st if bi == 0 else 1, generator=generator))
                self.layer_names.append(name)
                cin = fm
        self.head = Conv1D(cin, hidden_dim, 1, generator=generator)

    def forward(self, wav):
        h = self.sinc(_wav_nct(wav))
        h = self.act1(self.bn1(self.conv1(F.pad(h, (self.pad, self.pad)))))
        for name in self.layer_names:
            h = getattr(self, name)(h)
        return self.head(h).transpose(1, 2)


_FAMILIES = {"tdnn": (TDNNFe, TDNNFE_FIELDS),
             "asppRes": (ASPPResEncoder, ASPP_RES_FIELDS),
             "Resnet50": (ResnetEncoder, RESNET_FIELDS)}


def build_encoder(name, cfg, generator=None):
    """The encoder of a cfg's ``name`` (tdnn, asppRes or Resnet50) from
    the cfg's keys that are its fields (lists become tuples); None for
    another name."""
    if name not in _FAMILIES:
        return None
    cls, fields = _FAMILIES[name]
    kwargs = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in cfg.items() if k in fields}
    return cls(generator=generator, **kwargs)
