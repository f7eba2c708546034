"""Worker-target feature extraction in PyTorch (on the card in the step).

The port of ``pase_tpu/ops/features.py`` for the workers+ bank: each
extractor maps ``wav [B, T] -> [B, T//hop, dim]`` (NTC).

* ``lps``       — log power spectrum, rectangular ``win`` window in n_fft.
* ``mfcc``      — librosa mfcc: hann, mel power, per-sample top_db, DCT.
* ``fbanks``    — python_speech_features logfbank, deltas on the psf frame
                  count, then replicate-padded.
* ``gammatone`` — causal 512-tap FIR bank (one plain conv1d), windowed RMS.
* ``prosody``   — [interp log F0, uv, energy, zcr]; the F0 tracker's
                  autocorrelation goes through ``torch.fft``.

All add librosa deltas ([x, d1, d2]) through exact [T, T] Savitzky-Golay
operators. The host-side constant matrices (mel, psf, DCT, gammatone
bank) are numpy copies of the JAX package's, built once per shape.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from pase_tpu_torch.ops.signal import (frame_signal, framed_box_mean_ntc,
                                       stft_mag)

# ---------------------------------------------------------------------------
# deltas (librosa.feature.delta parity)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _delta_matrix(n_frames, order, width=9):
    """Exact [T, T] operator equal to librosa.feature.delta(eye(T))."""
    from scipy.signal import savgol_filter
    eye = np.eye(n_frames, dtype=np.float64)
    d = savgol_filter(eye, width, polyorder=order, deriv=order, axis=0,
                      mode="interp")
    return d.astype(np.float32)


_DEVICE_CONSTS = {}


def _const(make, *args, like):
    """The host-built constant ``make(*args)`` as a tensor on ``like``'s
    device and dtype, uploaded once: a copy from pageable host memory
    would stall the host on every step."""
    key = (make.__name__, args, like.device, like.dtype)
    if key not in _DEVICE_CONSTS:
        _DEVICE_CONSTS[key] = torch.as_tensor(make(*args), dtype=like.dtype,
                                              device=like.device)
    return _DEVICE_CONSTS[key]


def add_deltas(feats, der_order=2):
    """[B, T, D] -> [B, T, D*(1+der_order)], concat order [x, d1, d2]."""
    if der_order <= 0:
        return feats
    t = feats.shape[1]
    outs = [feats]
    for n in range(1, der_order + 1):
        dmat = _const(_delta_matrix, t, n, like=feats)
        outs.append(torch.einsum("st,btd->bsd", dmat, feats))
    return torch.cat(outs, dim=-1)


# ---------------------------------------------------------------------------
# mel / dct helpers (host-side constants)
# ---------------------------------------------------------------------------


def hz_to_mel(f, htk=False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(
        np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)


def mel_to_hz(m, htk=False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


@functools.lru_cache(maxsize=32)
def mel_filterbank(sr, n_fft, n_mels, fmin=0.0, fmax=None, htk=False,
                   norm="slaney"):
    """[n_mels, n_fft//2+1] triangular filterbank (librosa.filters.mel)."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = n_fft // 2 + 1
    fftfreqs = np.linspace(0, sr / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk),
                          n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)
    weights = np.zeros((n_mels, n_bins))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def dct_matrix(n_out, n_in):
    """Orthonormal DCT-II matrix [n_out, n_in] (scipy.fft.dct norm='ortho')."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    mat = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in)) * np.sqrt(2.0 / n_in)
    mat[0] *= 1.0 / np.sqrt(2.0)
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=8)
def hann_window(n):
    """Periodic Hann (scipy get_window('hann', n, fftbins=True))."""
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(
        np.float32)


@functools.lru_cache(maxsize=8)
def psf_mel_filterbank(rate, n_fft, n_filters):
    """python_speech_features.get_filterbanks: HTK mel points, triangles on
    floor-quantized FFT bin indices."""
    def hz2mel(hz):
        return 2595.0 * np.log10(1.0 + hz / 700.0)

    def mel2hz(mel):
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)

    melpts = np.linspace(hz2mel(0.0), hz2mel(rate / 2.0), n_filters + 2)
    bins = np.floor((n_fft + 1) * mel2hz(melpts) / rate)
    fb = np.zeros((n_filters, n_fft // 2 + 1), np.float32)
    for j in range(n_filters):
        for i in range(int(bins[j]), int(bins[j + 1])):
            fb[j, i] = (i - bins[j]) / (bins[j + 1] - bins[j])
        for i in range(int(bins[j + 1]), int(bins[j + 2])):
            fb[j, i] = (bins[j + 2] - i) / (bins[j + 2] - bins[j + 1])
    return fb


def _replicate_to(feat, expected):
    """Pad [B, F, D] to ``expected`` frames with its last frame, or cut."""
    have = feat.shape[1]
    if have < expected:
        return torch.cat([feat, feat[:, -1:].expand(
            -1, expected - have, -1)], dim=1)
    return feat[:, :expected]


# ---------------------------------------------------------------------------
# extractors
# ---------------------------------------------------------------------------


def lps(wav, n_fft=2048, hop=160, win=400, der_order=2, **_):
    """Log power spectrum: rectangular length-``win`` window, centered
    reflect pad, 10*log10(mag^2 + 1e-19), + deltas."""
    mag = stft_mag(wav, n_fft, hop, win, n_frames=wav.shape[-1] // hop)
    return add_deltas(10.0 * torch.log10(mag * mag + 10e-20), der_order)


def mfcc(wav, hop=160, order=13, sr=16000, win=400, der_order=2,
         n_mels=128, htk=False, **_):
    """librosa mfcc: n_fft = win, hann window, centered reflect pad, power
    mel spectrogram (slaney), power_to_db with top_db = 80 per sample,
    ortho DCT-II."""
    n_fft = win
    mag = stft_mag(wav, n_fft, hop, n_fft,
                   window=_const(hann_window, n_fft, like=wav),
                   n_frames=wav.shape[-1] // hop)
    fb = _const(mel_filterbank, sr, n_fft, n_mels, 0.0, sr / 2.0, htk,
                "slaney", like=wav)
    mels = torch.einsum("mf,btf->btm", fb, mag * mag)
    db = 10.0 * torch.log10(torch.clamp(mels, min=1e-10))
    db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - 80.0)
    cc = torch.einsum("om,btm->bto",
                      _const(dct_matrix, order, n_mels, like=wav), db)
    return add_deltas(cc, der_order)


def fbanks(wav, n_filters=40, n_fft=512, hop=160, win=400, rate=16000,
           der_order=2, preemph=0.97, **_):
    """python_speech_features logfbank: preemphasis, rectangular frames
    from 0 (zero pad at the end), power / n_fft, psf mel triangles, log
    with an eps floor; deltas on the psf frame count, then replicate-pad
    to T//hop frames."""
    t = wav.shape[-1]
    if preemph:
        wav = torch.cat([wav[..., :1], wav[..., 1:] - preemph * wav[..., :-1]],
                        dim=-1)
    psf_frames = 1 if t <= win else 1 + -(-(t - win) // hop)
    frames = frame_signal(wav, win, hop, n_frames=psf_frames, pad_end=True)
    mag = torch.fft.rfft(frames, n=n_fft, dim=-1).abs()
    power = mag * mag / n_fft
    fb = _const(psf_mel_filterbank, rate, n_fft, n_filters, like=wav)
    feat = torch.einsum("mf,btf->btm", fb, power)
    feat = torch.log(torch.clamp(feat, min=float(np.finfo(np.float32).eps)))
    return _replicate_to(add_deltas(feat, der_order), t // hop)


def erb_centre_freqs(fs, n_channels, f_min):
    """ERB-spaced centre frequencies, descending from fs/2."""
    ear_q, min_bw = 9.26449, 24.7
    i = np.arange(1, n_channels + 1)
    hi, lo = fs / 2.0, f_min
    return -(ear_q * min_bw) + np.exp(
        i * (-np.log(hi + ear_q * min_bw) + np.log(lo + ear_q * min_bw))
        / n_channels) * (hi + ear_q * min_bw)


@functools.lru_cache(maxsize=8)
def gammatone_fir_bank(fs, n_channels, f_min, n_taps=512):
    """[n_channels, n_taps] FIR truncation of the 4th-order gammatone
    impulse response, peak gain normalized to 1."""
    cf = erb_centre_freqs(fs, n_channels, f_min)
    t = np.arange(n_taps) / fs
    b = 1.019 * 24.7 * (4.37 * cf / 1000.0 + 1.0)
    ir = (t[None, :] ** 3) * np.exp(-2 * np.pi * b[:, None] * t[None, :]) \
        * np.cos(2 * np.pi * cf[:, None] * t[None, :])
    peak = np.abs(np.fft.rfft(ir, n=4 * n_taps, axis=1)).max(axis=1,
                                                             keepdims=True)
    return (ir / np.maximum(peak, 1e-12)).astype(np.float32)


def gammatone(wav, f_min=500, n_channels=40, hop=160, win=400, rate=16000,
              der_order=2, **_):
    """gtgram-style log gammatone energies: causal FIR bank -> windowed
    RMS of the power -> log(+1e-10) -> deltas on the gtgram frame count,
    then replicate-pad to T//hop frames."""
    t = wav.shape[-1]
    bank = _const(gammatone_fir_bank, rate, n_channels, float(f_min),
                  like=wav)
    # conv1d is a cross-correlation: flip the responses for a causal FIR
    xp = F.pad(wav, (bank.shape[1] - 1, 0))[:, None, :]
    filtered = F.conv1d(xp, bank.flip(-1)[:, None, :])        # [B, C, T]
    power = (filtered * filtered).transpose(1, 2)             # [B, T, C]
    ncols = (t - win) // hop + 1
    y = torch.sqrt(framed_box_mean_ntc(power, win, hop, ncols))
    y = add_deltas(torch.log(y + 1e-10), der_order)
    return _replicate_to(y, t // hop)


def _autocorr_f0(wav, sr, hop, n_frames, f0_min, f0_max, frame_len=1024,
                 voicing_thresh=0.35):
    """Normalized-autocorrelation F0 with a voicing decision: centered
    frames, hann window, ACF by Wiener-Khinchin through ``torch.fft``, peak
    lag in [sr/f0_max, sr/f0_min], voiced iff the peak > threshold and the
    frame has energy. Returns (f0 [B, F], uv [B, F])."""
    half = frame_len // 2
    x = F.pad(wav[:, None, :], (half, half), mode="reflect")[:, 0]
    frames = frame_signal(x, frame_len, hop, n_frames=n_frames)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    fw = frames * _const(hann_window, frame_len, like=wav)
    nfft = 2 * frame_len
    lag_min = int(np.floor(sr / f0_max))
    lag_max = min(int(np.ceil(sr / f0_min)), frame_len - 1)
    spec = torch.fft.rfft(fw, n=nfft, dim=-1)
    power = spec.real * spec.real + spec.imag * spec.imag
    acf = torch.fft.irfft(power, n=nfft, dim=-1)[..., :lag_max + 1]
    nacf = acf / torch.clamp(acf[..., :1], min=1e-10)
    window = nacf[..., lag_min:lag_max + 1]
    peak, best = window.max(dim=-1)
    f0 = sr / (best + lag_min).to(wav.dtype)
    voiced = (peak > voicing_thresh) & (acf[..., 0] / frame_len > 1e-7)
    return torch.where(voiced, f0, torch.zeros_like(f0)), voiced.to(wav.dtype)


def _interpolate_unvoiced(lf0, uv):
    """Linear interpolation of log F0 across unvoiced gaps with edge hold
    (ahoproc_tools interpolation semantics)."""
    b, f = lf0.shape
    idx = torch.arange(f, device=lf0.device)[None, :].expand(b, f)
    prev = torch.where(uv > 0, idx, torch.full_like(idx, -1))
    prev = torch.cummax(prev, dim=1).values
    nxt = torch.where(uv > 0, idx, torch.full_like(idx, f + 1))
    nxt = torch.cummin(nxt.flip(1), dim=1).values.flip(1)
    v_prev = torch.gather(lf0, 1, prev.clamp(0, f - 1))
    v_next = torch.gather(lf0, 1, nxt.clamp(0, f - 1))
    has_prev, has_next = prev >= 0, nxt < f + 1
    wgt = (idx - prev).to(lf0.dtype) / torch.clamp(nxt - prev, min=1).to(
        lf0.dtype)
    interp = v_prev * (1 - wgt) + v_next * wgt
    out = torch.where(has_prev & has_next, interp,
                      torch.where(has_prev, v_prev,
                                  torch.where(has_next, v_next, lf0)))
    return torch.where(uv > 0, lf0, out)


def prosody(wav, hop=160, win=320, f0_min=60, f0_max=300, sr=16000,
            der_order=2, **_):
    """4-dim prosody targets [interp log F0, uv, rms energy, zcr] + deltas.
    All-unvoiced chunks fall back to log(f0_min)."""
    n_frames = wav.shape[-1] // hop
    f0, uv = _autocorr_f0(wav, sr, hop, n_frames, f0_min, f0_max)
    lf0 = _interpolate_unvoiced(torch.log(f0 + 1e-10), uv)
    all_unvoiced = uv.sum(dim=1, keepdim=True) == 0
    lf0 = torch.where(all_unvoiced, torch.full_like(lf0, np.log(f0_min)),
                      lf0)

    half = win // 2
    frames = frame_signal(F.pad(wav, (half, half)), win, hop,
                          n_frames=n_frames)
    egy = torch.sqrt(torch.mean(frames * frames, dim=-1))
    xe = F.pad(wav[:, None, :], (half, half), mode="replicate")[:, 0]
    sign = frame_signal(xe, win, hop, n_frames=n_frames) >= 0
    zcr = (sign[..., 1:] != sign[..., :-1]).sum(dim=-1).to(wav.dtype) / win
    return add_deltas(torch.stack([lf0, uv, egy, zcr], dim=-1), der_order)


# ---------------------------------------------------------------------------
# worker-name dispatch
# ---------------------------------------------------------------------------

# dict order matters for substring dispatch
_FEATURE_BUILDERS = {
    "lps": lps,
    "fbank": fbanks,
    "gtn": gammatone,
    "mfcc": mfcc,
    "prosody": prosody,
}
_UNPORTED = ("kaldimfcc", "kaldiplp", "lpc")


def feature_fn_for_worker(name, transform_cfg=None, hop=160):
    """Resolve a worker name to its target extractor by the reference's
    substring dispatch. None for workers without a signal-feature target
    (mi / cmi / spc / gap / overlap / chunk / cchunk / regularizers)."""
    skip = ("mi", "cmi", "spc", "gap", "overlap", "chunk", "cchunk")
    if name in skip or "regu" in name or "wavernn" in name:
        return None
    for key in _UNPORTED:
        if key in name:
            raise NotImplementedError(
                f"worker feature {name!r} is not ported yet: ROADMAP.md, "
                "queue 1: off-path model variants")
    cfg = dict(transform_cfg or {})
    cfg["hop"] = hop
    for key, fn in _FEATURE_BUILDERS.items():
        if key in name:
            return functools.partial(fn, **cfg)
    raise TypeError(f"Unrecognized worker feature '{name}'")


def feature_dim_for_worker(name, transform_cfg=None, der_order=2):
    """Static output dim of a worker's target features."""
    cfg = dict(transform_cfg or {})
    mult = 1 + cfg.get("der_order", der_order)
    if "lps" in name:
        return (cfg.get("n_fft", 2048) // 2 + 1) * mult
    if "fbank" in name:
        return cfg.get("n_filters", 40) * mult
    if "gtn" in name:
        return cfg.get("n_channels", 40) * mult
    if "mfcc" in name:
        return cfg.get("order", 13) * mult
    if "prosody" in name:
        return 4 * mult
    return None
