"""Batched signal primitives of the port: framing, windowed means and the
STFT magnitude, on [B, T] waveforms (or [B, T, C] feature maps).

The STFT goes through ``torch.stft`` (cuFFT on the card). The JAX package
evaluates small DFTs as matmuls only because the TPU has no FFT unit
(``pase_tpu/ops/signal.py`` ``_dft_mats``); that rewrite is not copied.
"""

import torch
import torch.nn.functional as F


def frame_signal(x, frame_len, hop, n_frames=None, pad_end=False):
    """Frame [B, T] -> [B, n_frames, frame_len], frames starting at t*hop.

    Without ``n_frames`` it is the number of complete frames, or with
    ``pad_end`` the number that covers the signal (zero-padded at the
    end)."""
    t = x.shape[-1]
    if n_frames is None:
        if pad_end:
            n_frames = -(-max(t - frame_len, 0) // hop) + 1
        else:
            n_frames = (t - frame_len) // hop + 1
    need = (n_frames - 1) * hop + frame_len
    if need > t:
        x = F.pad(x, (0, need - t))
    return x[..., :need].unfold(-1, frame_len, hop)


def framed_box_mean_ntc(x, win, hop, n_frames):
    """Mean over sliding windows along axis 1 of [B, T, C]:
    out[:, t] = mean(x[:, t*hop : t*hop + win]) for t < n_frames,
    zero-padded past the end, without the [B, F, win, C] frame tensor:
    per-hop bin sums, a cumulative sum over bins, and a partial-head bin
    when win % hop != 0."""
    if win < hop:
        raise ValueError("framed_box_mean_ntc requires win >= hop")
    b, t, c = x.shape
    nbins_full = win // hop
    rem = win - nbins_full * hop
    need = (n_frames - 1) * hop + win
    nbins = -(-need // hop)
    if nbins * hop > t:
        x = F.pad(x, (0, 0, 0, nbins * hop - t))
    xb = x[:, :nbins * hop].reshape(b, nbins, hop, c)
    bins = xb.sum(dim=2)                                     # [B, nbins, C]
    cs = torch.cat([x.new_zeros((b, 1, c)), bins.cumsum(dim=1)], dim=1)
    idx = torch.arange(n_frames, device=x.device)
    out = cs[:, idx + nbins_full] - cs[:, idx]
    if rem:
        out = out + xb[:, :, :rem].sum(dim=2)[:, idx + nbins_full]
    return out / win


def stft_mag(wav, n_fft, hop, win, window=None, n_frames=None):
    """Centered (reflect-padded) STFT magnitude [B, n_frames, n_fft//2 + 1]
    of [B, T].

    Frame t covers the ``win`` samples centered at t*hop (``window``, a
    [win] tensor, or rectangular), zero-padded to ``n_fft``: torch.stft's
    convention. torch.stft gives T//hop + 1 frames; the JAX package keeps
    T//hop, the default here."""
    if n_frames is None:
        n_frames = wav.shape[-1] // hop
    if window is None:
        window = torch.ones(win, dtype=wav.dtype, device=wav.device)
    spec = torch.stft(wav, n_fft, hop_length=hop, win_length=win,
                      window=window.to(wav.device, wav.dtype), center=True,
                      pad_mode="reflect", return_complex=True)
    return spec.abs().transpose(1, 2)[:, :n_frames]
