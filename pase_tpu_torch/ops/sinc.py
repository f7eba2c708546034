"""SincNet parametric band-pass filterbank construction (SincNet,
arXiv:1808.00158): mel-spaced (low, band) Hz parameters and per-forward
filter synthesis from half-window symmetry. Same math as
``pase_tpu.ops.sinc``; the numpy helpers are restated here so the port
never imports the JAX package.
"""

import numpy as np
import torch


def to_mel(hz):
    return 2595.0 * np.log10(1.0 + hz / 700.0)


def to_hz(mel):
    return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)


def mel_init_hz(out_channels, sample_rate=16000, min_low_hz=50, min_band_hz=50):
    """Initial (low_hz, band_hz) filter parameters, mel-spaced.

    low_hz=30 .. sr/2-(min_low+min_band), out_channels+1 mel points;
    low = hz[:-1], band = diff(hz). Returns float32 arrays of shape [C, 1].
    """
    low_hz = 30.0
    high_hz = sample_rate / 2.0 - (min_low_hz + min_band_hz)
    mel = np.linspace(to_mel(low_hz), to_mel(high_hz), out_channels + 1)
    hz = to_hz(mel)
    low = hz[:-1].reshape(-1, 1).astype(np.float32)
    band = np.diff(hz).reshape(-1, 1).astype(np.float32)
    return low, band


def sinc_time_axes(kernel_size, sample_rate=16000):
    """Static (n_, window_) halves used by the filter synthesis.

    n_:      [1, (K-1)//2] = 2*pi*arange(-(K-1)/2, 0)/sr
    window_: [(K)//2]      half Hamming window
    """
    if kernel_size % 2 == 0:
        kernel_size += 1
    n = (kernel_size - 1) / 2.0
    n_ = 2.0 * np.pi * np.arange(-n, 0.0) / sample_rate
    n_lin = np.linspace(0, (kernel_size / 2) - 1, int(kernel_size / 2))
    window = 0.54 - 0.46 * np.cos(2.0 * np.pi * n_lin / kernel_size)
    return (n_.reshape(1, -1).astype(np.float32),
            window.astype(np.float32))


def build_sinc_filters(low_hz_, band_hz_, n_, window_, sample_rate=16000,
                       min_low_hz=50.0, min_band_hz=50.0):
    """Synthesize the filterbank from the (low, band) parameters.

    low_hz_, band_hz_: [C, 1]; n_: [1, K/2]; window_: [K/2] tensors on one
    device. Returns [C, K] filters (K odd).
    """
    low = min_low_hz + torch.abs(low_hz_)                        # [C,1]
    # clip as max then min, not torch.clamp: at the init the last filter's
    # high edge lands exactly on sr/2, where maximum/minimum split the
    # gradient in half, as jnp.clip does (torch.clamp passes all of it)
    high = low + min_band_hz + torch.abs(band_hz_)
    high = torch.minimum(torch.maximum(high, high.new_tensor(min_low_hz)),
                         high.new_tensor(sample_rate / 2.0))     # [C,1]
    band = (high - low)[:, 0]                                    # [C]

    f_t_low = low @ n_                                           # [C, K/2]
    f_t_high = high @ n_
    bp_left = ((torch.sin(f_t_high) - torch.sin(f_t_low)) / (n_ / 2.0)) \
        * window_
    bp_center = 2.0 * band.reshape(-1, 1)                        # [C,1]
    bp_right = torch.flip(bp_left, dims=(1,))
    band_pass = torch.cat([bp_left, bp_center, bp_right], dim=1)
    return band_pass / (2.0 * band[:, None])
