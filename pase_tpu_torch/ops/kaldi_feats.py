"""Kaldi-style MFCC / PLP worker targets in PyTorch (on the card in the step).

The port of ``pase_tpu/ops/kaldi_feats.py``: the compute-mfcc-feats /
compute-plp-feats pipelines reimplemented on tensors, with the reference's
KaldiMFCC flags (--use-energy=false --snip-edges=false, frames of 25 ms
every 10 ms, no dither).

MFCC: DC removal -> preemphasis 0.97 -> povey window -> power spectrum
-> HTK mel filterbank -> log -> DCT-II (ortho) -> cepstral lifter 22.
PLP: the same mel bank for the bark bins (the JAX package's documented
approximation), equal loudness and intensity^(1/3) compression -> IDFT
autocorrelation -> Levinson-Durbin -> cepstral recursion -> lifter.

The host-side constants (the povey window, the lifter, PLP's
equal-loudness curve and IDFT matrix) are built as the JAX package builds
them: in float64, cast to float32, and the IDFT scaled in place in
float32. FFTs, the mel bank and the DCT are plain tensor ops there as
here.
"""

import functools

import numpy as np
import torch

from pase_tpu_torch.ops.features import (_const, add_deltas, dct_matrix,
                                         mel_filterbank)
from pase_tpu_torch.ops.signal import frame_signal, levinson


@functools.lru_cache(maxsize=4)
def povey_window(n):
    return ((0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1)))
            ** 0.85).astype(np.float32)


@functools.lru_cache(maxsize=4)
def lifter(num_ceps, q=22.0):
    i = np.arange(num_ceps)
    return (1.0 + 0.5 * q * np.sin(np.pi * i / q)).astype(np.float32)


@functools.lru_cache(maxsize=4)
def equal_loudness(sr, num_mel_bins):
    """The equal-loudness weights at the HTK-mel-spaced centre
    frequencies of the filterbank's bins (float64 -> float32)."""
    def mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    edges = np.linspace(mel(20.0), mel(sr / 2.0 - 400.0), num_mel_bins + 2)
    w2 = hz(edges[1:-1]) ** 2
    eql = (w2 / (w2 + 1.6e5)) ** 2 * ((w2 + 1.44e6) / (w2 + 9.61e6))
    return eql.astype(np.float32)


@functools.lru_cache(maxsize=4)
def idft_matrix(lpc_order, m):
    """[lpc_order + 1, m] cosine IDFT of the edge-duplicated bins to the
    autocorrelation: cast to float32 first, then scaled in float32."""
    k = np.arange(lpc_order + 1)[:, None]
    n = np.arange(m)[None, :]
    idft = np.cos(np.pi * k * n / (m - 1)).astype(np.float32)
    idft[:, 1:-1] *= 2.0
    idft /= (2.0 * (m - 1))
    return idft


def reflect_pad(wav, left, right):
    """``numpy.pad(..., mode='reflect')`` of [B, T] along time, pads of any
    length (reflected again past an edge, as numpy and JAX do), where
    ``F.pad`` refuses a pad as long as the signal."""
    t = wav.shape[-1]
    idx = torch.arange(-left, t + right, device=wav.device)
    if t == 1:
        return wav[:, torch.zeros_like(idx)]
    period = 2 * (t - 1)
    idx = torch.remainder(idx, period)
    idx = torch.where(idx >= t, period - idx, idx)
    return wav[:, idx]


def kaldi_frames(wav, win, hop):
    """snip-edges=false framing: T // hop frames of ``win`` samples, frame
    t starting at t hop - (win - hop) // 2 of the signal reflected at both
    ends."""
    x = reflect_pad(wav, (win - hop) // 2, win)
    return frame_signal(x, win, hop, n_frames=wav.shape[-1] // hop)


def preemphasized_windowed(frames, window, preemph=0.97):
    frames = frames - frames.mean(dim=-1, keepdim=True)       # remove DC
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    return (frames - preemph * prev) * window


def _power_spectrum(wav, hop, win):
    frames = preemphasized_windowed(kaldi_frames(wav, win, hop),
                                    _const(povey_window, win, like=wav))
    n_fft = int(2 ** np.ceil(np.log2(win)))
    return torch.fft.rfft(frames, n=n_fft).abs() ** 2, n_fft


def kaldi_mfcc(wav, hop=160, win=400, sr=16000, num_mel_bins=40,
               num_ceps=13, der_order=2, cepstral_lifter=22.0, **_):
    """[B, T] -> [B, T // hop, num_ceps * (1 + der_order)]."""
    spec, n_fft = _power_spectrum(wav, hop, win)
    fb = _const(mel_filterbank, sr, n_fft, num_mel_bins, 20.0,
                sr / 2.0 - 400.0, True, None, like=wav)
    mels = torch.einsum("mf,btf->btm", fb, spec)
    logm = torch.log(torch.clamp(mels, min=float(np.finfo(np.float32).eps)))
    cc = torch.einsum("om,btm->bto",
                      _const(dct_matrix, num_ceps, num_mel_bins, like=wav),
                      logm)
    if cepstral_lifter > 0:
        cc = cc * _const(lifter, num_ceps, cepstral_lifter, like=wav)
    return add_deltas(cc, der_order)


def kaldi_plp(wav, hop=160, win=400, sr=16000, num_mel_bins=20,
              num_ceps=20, lpc_order=20, der_order=0,
              cepstral_lifter=22.0, **_):
    """[B, T] -> [B, T // hop, num_ceps * (1 + der_order)] perceptual
    linear prediction cepstra."""
    spec, n_fft = _power_spectrum(wav, hop, win)
    fb = _const(mel_filterbank, sr, n_fft, num_mel_bins, 20.0,
                sr / 2.0 - 400.0, True, None, like=wav)
    bins = torch.einsum("mf,btf->btm", fb, spec)
    bins = bins * _const(equal_loudness, sr, num_mel_bins, like=wav)
    bins = torch.pow(torch.clamp(bins, min=1e-10), 1.0 / 3.0)
    # the edge bins duplicated (as Kaldi does), then IDFT -> autocorrelation
    ext = torch.cat([bins[..., :1], bins, bins[..., -1:]], dim=-1)
    r = torch.einsum("km,btm->btk",
                     _const(idft_matrix, lpc_order, num_mel_bins + 2,
                            like=wav), ext)
    r = torch.cat([r[..., :1] + 1e-10, r[..., 1:]], dim=-1)
    a, e = levinson(r, lpc_order)
    # the cepstra of the LPC polynomial (c0 = ln(gain^2)); each term is
    # the Python float times a, then times the cepstrum, as in JAX
    ceps = [torch.log(torch.clamp(e, min=1e-10))]
    for n in range(1, num_ceps):
        acc = -a[..., n] if n <= lpc_order else 0.0
        for k in range(1, n):
            if n - k <= lpc_order:
                acc = acc - (1.0 - k / n) * a[..., n - k] * ceps[k]
        ceps.append(acc)
    cc = torch.stack(ceps, dim=-1)
    if cepstral_lifter > 0:
        cc = cc * _const(lifter, num_ceps, cepstral_lifter, like=wav)
    return add_deltas(cc, der_order)
