"""Spectrum decoders: the spectrogram decoder and the autoregressive
spectrum LM.

The port of ``pase_tpu/decoders.py`` (the reference's
pase/models/decoders.py:9-105, dead code there: nothing imports it,
ported for completeness). The layout is the JAX package's: frames in and
out as [B, T, C] (NTC), the convolutions inside on [B, C, T]. Module and
parameter names follow the JAX trees, so ``checkpoint.
variables_to_state_dict`` of a JAX decoder's variables loads strictly:

* ``GConv1DBlock`` (``conv``, ``act``, ``norm``): reflect pad, conv, the
  activation, then the norm (the reference applies the activation BEFORE
  the norm here, unlike FeBlock).
* ``SpectrogramDecoder`` (``dec_{i}``, ``out``): per stage a
  ``GDeconv1DBlock`` (stride > 1) or a ``GConv1DBlock`` (stride 1), then
  a 1x1 conv to nfft // 2 + 1 bins.
* ``SpectrumLM`` (``step.l{i}``, ``step.out_fc``): a closed-loop rollout
  of flax ``OptimizedLSTMCell`` / ``GRUCell`` layers (``nn.FlaxRNN``'s
  gate layout, one ``step`` a frame) and a Dense head: step t's input is
  step t-1's output, except at step 0 (the seed frame) and at the
  teacher-forcing frames ``dec_cps``. The dropout between layers draws
  from ``dropout_generator``, the random-normal initial state from the
  ``generator`` passed in.
"""

import torch
from torch import nn

from pase_tpu_torch.nn import (Conv1D, FlaxRNN, GDeconv1DBlock,
                               NamedActivation, PReLU, build_norm, dropout,
                               flax_dense)
from pase_tpu_torch.ops.pad import pad_1d


class GConv1DBlock(nn.Module):
    """[B, Cin, T] -> [B, fmaps, T // stride]: reflect pad (k//2 - 1,
    k//2) when strided or even, else (k//2, k//2), conv, the activation
    (PReLU with init 0, glu over doubled channels, or a jax.nn name),
    then ``build_norm``'s norm (modules.py:376-405)."""

    def __init__(self, in_channels, fmaps, kwidth, stride=1, norm_type=None,
                 act="prelu", generator=None):
        super().__init__()
        self.kwidth, self.stride, self.act_name = kwidth, stride, act
        wfmaps = 2 * fmaps if act == "glu" else fmaps
        self.conv = Conv1D(in_channels, wfmaps, kwidth, stride,
                           generator=generator)
        if act is None or act == "prelu":
            self.act = PReLU(fmaps, init=0.0)
        elif act != "glu":
            self.act = NamedActivation(act)
        self.norm = build_norm(norm_type, fmaps)

    def forward(self, x):
        k = self.kwidth
        pad = ((k // 2 - 1, k // 2) if self.stride > 1 or k % 2 == 0
               else (k // 2, k // 2))
        y = self.conv(pad_1d(x, pad, mode="reflect"))
        if self.act_name == "glu":
            z, g = torch.chunk(y, 2, dim=1)
            y = z * torch.sigmoid(g)
        else:
            y = self.act(y)
        return y if self.norm is None else self.norm(y)


class SpectrogramDecoder(nn.Module):
    """Frame embeddings [B, T, in_channels] -> spectra [B, T', nfft // 2 +
    1] (decoders.py:73-99): per stage a GDeconv1DBlock (stride > 1, T
    times the stride) or a GConv1DBlock (stride 1), then a 1x1 conv."""

    def __init__(self, in_channels, nfft=1024, strides=(1, 1, 1),
                 kwidths=(3, 3, 3), fmaps=(256, 256, 256), norm_type=None,
                 generator=None):
        super().__init__()
        self.num_stages = len(kwidths)
        cin = in_channels
        for i, (kw, st, fm) in enumerate(zip(kwidths, strides, fmaps),
                                         start=1):
            block = (GDeconv1DBlock(cin, fm, kw, st, norm_type=norm_type,
                                    generator=generator) if st > 1 else
                     GConv1DBlock(cin, fm, kw, 1, norm_type=norm_type,
                                  generator=generator))
            self.add_module(f"dec_{i}", block)
            cin = fm
        self.out = Conv1D(cin, nfft // 2 + 1, 1, generator=generator)

    def forward(self, x):
        h = x.transpose(1, 2)
        for i in range(1, self.num_stages + 1):
            h = getattr(self, f"dec_{i}")(h)
        return self.out(h).transpose(1, 2)


class _LMStep(nn.Module):
    """One closed-loop step's layers: ``l{i}`` (FlaxRNN cells) and the
    Dense head ``out_fc``."""

    def __init__(self, rnn_size, rnn_layers, out_dim, cell, generator=None):
        super().__init__()
        for i in range(rnn_layers):
            self.add_module(f"l{i}", FlaxRNN(out_dim if i == 0 else rnn_size,
                                             rnn_size, cell, generator))
        self.out_fc = flax_dense(rnn_size, out_dim, generator)


class SpectrumLM(nn.Module):
    """Autoregressive RNN over spectrum frames (decoders.py:9-71): the
    seed frame x [B, F] is rolled out closed-loop for ``dec_steps``, each
    step's output the next step's input, with teacher-forcing frames
    ``dec_cps`` ({step: [B, F] or [B, 1, F]}) injected at their steps.
    Returns ([B, dec_steps, F] frames, the final state: per layer (c, h)
    for an LSTM, h for a GRU, as flax's carries).

    ``rnn_type`` LSTM or GRU (anything else raises ValueError, as in
    JAX); the reference's bidirectional flag is not taken (its own
    forward would crash, and a bidirectional closed loop is
    ill-defined). The cells run in float32."""

    def __init__(self, rnn_size, rnn_layers, out_dim, dropout=0.0,
                 rnn_type="LSTM", generator=None):
        super().__init__()
        if rnn_type not in ("LSTM", "GRU"):
            raise ValueError(f"rnn_type must be LSTM or GRU, got "
                             f"{rnn_type}")
        self.rnn_size, self.rnn_layers = rnn_size, rnn_layers
        self.out_dim, self.dropout, self.rnn_type = out_dim, dropout, rnn_type
        self.dropout_generator = None   # the masks' between the layers
        self.step = _LMStep(rnn_size, rnn_layers, out_dim, rnn_type.lower(),
                            generator)

    def init_state(self, batch, generator, device=None):
        """Random-normal initial state (init_hidden, decoders.py:62-71:
        randn, not zeros) from ``generator``: per layer h, then for an
        LSTM c, returned as flax's carry ((c, h) or h)."""
        def one():
            h = torch.randn(batch, self.rnn_size, generator=generator,
                            device=device)
            if self.rnn_type == "LSTM":
                return (torch.randn(batch, self.rnn_size,
                                    generator=generator, device=device), h)
            return h
        return tuple(one() for _ in range(self.rnn_layers))

    def forward(self, x, dec_steps, state=None, dec_cps=None,
                generator=None):
        b, f = x.shape
        if f != self.out_dim:
            raise ValueError(f"seed frame {tuple(x.shape)}: {self.out_dim} "
                             "features expected")
        if state is None:
            if generator is None:
                raise ValueError("SpectrumLM without a state needs a "
                                 "torch.Generator for its initial state")
            state = self.init_state(b, generator, x.device)
        forced = {0: x}
        for t, frame in (dec_cps or {}).items():
            frame = torch.as_tensor(frame, device=x.device)
            forced[int(t)] = (frame[:, 0] if frame.dim() == 3
                              else frame).to(x.dtype)
        states = list(state)
        prev = x.new_zeros(b, f)
        frames = []
        for t in range(dec_steps):
            h = forced.get(t, prev)
            for i in range(self.rnn_layers):
                cell = getattr(self.step, f"l{i}")
                if self.rnn_type == "LSTM":
                    c0, h0 = states[i]
                    h1, c1 = cell.step(h, (h0.float(), c0.float()))
                    states[i], h = (c1, h1), h1
                else:
                    h = cell.step(h, states[i].float())
                    states[i] = h
                if i < self.rnn_layers - 1:
                    # torch nn.LSTM's dropout: between layers only
                    h = dropout(h, self.dropout, self.dropout_generator,
                                self.training)
            prev = self.step.out_fc(h).to(x.dtype)
            frames.append(prev)
        return torch.stack(frames, dim=1), tuple(states)
