"""The PASE+ waveform distortion stack on [B, T] batches, in PyTorch.

The port of ``pase_tpu/data/distortions.py``. Every stage is computed for
the whole batch and selected per sample with ``torch.where`` on a gate
(branch-free, no host sync), with the asset banks (impulse responses,
noise, overlap speech, FIR filters) as tensors on the batch's device.

The random draws are separate from the arithmetic:
  * ``draw_distortions(generator, b, t, cfg, assets)`` draws everything a
    step needs from one ``torch.Generator`` (gate uniforms, bank rows,
    offsets, SNR and factor indices, overlap onsets, chop scores and
    durations, speed warps) as a ``DistortionDraws``;
  * ``apply_distortions(wav, draws, cfg, assets, dec_res)`` is
    deterministic. A test hands it the draws the JAX function took from
    its keys (JAX's random streams cannot be reproduced in torch).

Stage order and semantics are the JAX package's (reverb -> overlap ->
additive noise -> speed -> resample -> clip -> chop -> bandrop ->
downsample, each gated with its own probability):
  reverb      full FFT convolution with a bank IR, shifted left by the
              IR's peak, energy matched to the input;
  overlap     another utterance from a random onset on, at a random SNR,
              energy renormalized; also the frame-level overlap label;
  noise       a bank noise segment at a random SNR, energy renormalized;
  speed       linear-interpolation resample to T(1 + w), centre crop or
              centred zero padding back to T;
  resample    zero-phase anti-alias FIR, decimation by q, linear
              interpolation back;
  clip        clipping at a random fraction of the sample's min / max;
  chop        zeroed Gaussian-length windows centred on random speech
              frames of an energy VAD;
  bandrop / downsample  FIR filtering with each filter's own group delay
              removed, energy matched.
"""

import glob
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pase_tpu_torch.ops.signal import fft_convolve_full

STAGES = ("reverb", "overlap", "noises", "speed", "resample", "clip", "chop",
          "bandrop", "downsample")
VAD_WIN = 160
VAD_THRESH_DB = -40.0


class DistortionAssets(NamedTuple):
    """Asset banks as tensors. Any field may be None (stage disabled)."""
    ir_bank: Optional[torch.Tensor] = None        # [n_ir, L_ir], zero-padded
    ir_pmax: Optional[torch.Tensor] = None        # [n_ir] argmax |ir|
    noise_bank: Optional[torch.Tensor] = None     # [n_noise, L_n]
    overlap_bank: Optional[torch.Tensor] = None   # [n_ov, L_o]
    bandrop_bank: Optional[torch.Tensor] = None   # [n_f, L_f], zero-padded
    bandrop_lens: Optional[torch.Tensor] = None   # [n_f] true filter lens
    downsample_bank: Optional[torch.Tensor] = None
    downsample_lens: Optional[torch.Tensor] = None
    resample_filters: Optional[torch.Tensor] = None  # [n_q, K], centred

    def to(self, device):
        return DistortionAssets(*(None if a is None else
                                  torch.as_tensor(a).to(device)
                                  for a in self))


class DistortionConfig(NamedTuple):
    reverb_p: float = 0.0
    overlap_p: float = 0.0
    overlap_snrs: Tuple[float, ...] = (0.0, 5.0, 10.0)
    overlap_reverb: bool = False
    noises_p: float = 0.0
    noises_snrs: Tuple[float, ...] = (0.0, 5.0, 10.0)
    speed_p: float = 0.0
    speed_range: Optional[Tuple[float, float]] = None
    clip_p: float = 0.0
    clip_factors: Tuple[float, ...] = (0.1, 0.3, 0.5)
    chop_p: float = 0.0
    chop_factors: Tuple[Tuple[float, float], ...] = ((0.05, 0.025),
                                                     (0.1, 0.05))
    max_chops: int = 2
    bandrop_p: float = 0.0
    downsample_p: float = 0.0
    resample_p: float = 0.0
    resample_factors: Tuple[int, ...] = ()
    sr: int = 16000


class DistortionDraws(NamedTuple):
    """The random draws of one step, [B] per field unless noted; the
    fields of a disabled stage are None."""
    gate: torch.Tensor                 # [B, 9] U[0, 1), one per stage
    reverb_ir: Optional[torch.Tensor] = None
    overlap_shift: Optional[torch.Tensor] = None   # onset in samples
    overlap_row: Optional[torch.Tensor] = None
    overlap_beg: Optional[torch.Tensor] = None
    overlap_snr: Optional[torch.Tensor] = None     # index into overlap_snrs
    overlap_ir: Optional[torch.Tensor] = None      # with overlap_reverb
    noise_row: Optional[torch.Tensor] = None
    noise_beg: Optional[torch.Tensor] = None
    noise_snr: Optional[torch.Tensor] = None
    speed_warp: Optional[torch.Tensor] = None      # U[lo, hi)
    resample_factor: Optional[torch.Tensor] = None
    clip_factor: Optional[torch.Tensor] = None
    chop_n: Optional[torch.Tensor] = None          # chops, 1..max_chops
    chop_u: Optional[torch.Tensor] = None          # [B, T // 160] scores
    chop_factor: Optional[torch.Tensor] = None     # [B, max_chops]
    chop_normal: Optional[torch.Tensor] = None     # [B, max_chops] N(0, 1)
    bandrop_filter: Optional[torch.Tensor] = None
    downsample_filter: Optional[torch.Tensor] = None

    def to(self, device):
        return DistortionDraws(*(None if a is None else a.to(device)
                                 for a in self))


# Every kwarg of the reference config_distortions signature. config_from_json
# maps the policy keys to DistortionConfig; the asset and path keys are read
# by the asset loaders (build_assets), codec2 by the host stage.
# Anything else is refused: a typo'd key must not silently disable a stage.
_REFERENCE_KEYS = frozenset({
    "reverb_irfiles", "reverb_fmt", "reverb_data_root", "reverb_p",
    "reverb_cache", "overlap_dir", "overlap_list", "overlap_snrs",
    "overlap_reverb", "overlap_p", "noises_dir", "noises_snrs",
    "noises_p", "noises_cache", "speed_range", "speed_p",
    "resample_factors", "resample_p", "bandrop_irfiles", "bandrop_fmt",
    "bandrop_data_root", "bandrop_p", "downsample_irfiles",
    "downsample_fmt", "downsample_data_root", "downsample_p",
    "clip_factors", "clip_p", "chop_factors", "max_chops", "chop_p",
    "codec2_p", "codec2_kbps", "codec2_cachedir", "codec2_cache",
    "report",
})
# extensions beyond the reference schema: the whisperize host stage and
# annotation keys of the shipped cfg copies
_EXTENSION_KEYS = frozenset({"whisper_p", "whisper_cachedir", "sr"})


def config_from_json(cfg):
    """A distortion cfg JSON (cfg/distortions/*.cfg) -> DistortionConfig.

    Every key must be a reference config_distortions kwarg, a documented
    extension or a '_'-prefixed annotation; unknown keys raise."""
    unknown = [k for k in cfg
               if k not in _REFERENCE_KEYS and k not in _EXTENSION_KEYS
               and not k.startswith("_")]
    if unknown:
        raise ValueError(
            f"unknown distortion cfg keys {unknown}; expected reference "
            "config_distortions kwargs or extensions "
            f"{sorted(_EXTENSION_KEYS)}")
    return DistortionConfig(
        reverb_p=cfg.get("reverb_p", 0.0),
        overlap_p=cfg.get("overlap_p", 0.0),
        overlap_snrs=tuple(cfg.get("overlap_snrs", (0, 5, 10))),
        overlap_reverb=bool(cfg.get("overlap_reverb", False)),
        noises_p=cfg.get("noises_p", 0.0),
        noises_snrs=tuple(cfg.get("noises_snrs", (0, 5, 10))),
        speed_p=cfg.get("speed_p", 0.0) if cfg.get("speed_range") else 0.0,
        speed_range=tuple(cfg["speed_range"]) if cfg.get("speed_range")
        else None,
        clip_p=cfg.get("clip_p", 0.0) if cfg.get("clip_factors") else 0.0,
        clip_factors=tuple(cfg.get("clip_factors", ())) or (0.1, 0.3, 0.5),
        chop_p=cfg.get("chop_p", 0.0) if cfg.get("chop_factors") else 0.0,
        chop_factors=tuple(tuple(c) for c in cfg.get("chop_factors", ())) or
        ((0.05, 0.025), (0.1, 0.05)),
        max_chops=cfg.get("max_chops", 2),
        bandrop_p=cfg.get("bandrop_p", 0.0),
        downsample_p=cfg.get("downsample_p", 0.0),
        resample_p=(cfg.get("resample_p", 0.0)
                    if cfg.get("resample_factors") else 0.0),
        resample_factors=tuple(int(q) for q in
                               cfg.get("resample_factors", ())),
    )


def enabled_stages(cfg, assets):
    """{stage: True when it runs}: its probability is positive and its
    assets are there."""
    return {
        "reverb": cfg.reverb_p > 0 and assets.ir_bank is not None,
        "overlap": cfg.overlap_p > 0 and assets.overlap_bank is not None,
        "noises": cfg.noises_p > 0 and assets.noise_bank is not None,
        "speed": cfg.speed_p > 0 and cfg.speed_range is not None,
        "resample": (cfg.resample_p > 0 and bool(cfg.resample_factors)
                     and assets.resample_filters is not None),
        "clip": cfg.clip_p > 0,
        "chop": cfg.chop_p > 0,
        "bandrop": cfg.bandrop_p > 0 and assets.bandrop_bank is not None,
        "downsample": (cfg.downsample_p > 0
                       and assets.downsample_bank is not None),
    }


def _overlap_reverb(cfg, assets):
    return cfg.overlap_reverb and assets.ir_bank is not None


# ---------------------------------------------------------------------------
# random draws
# ---------------------------------------------------------------------------


def draw_distortions(generator, b, t, cfg, assets):
    """Every random draw of one step for a [b, t] batch, on the
    generator's device."""
    dev = generator.device
    on = enabled_stages(cfg, assets)

    def randint(low, high, shape=(b,)):
        return torch.randint(low, high, shape, generator=generator,
                             device=dev)

    def uniform(shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=generator, device=dev)
        return lo + (hi - lo) * u

    d = {"gate": uniform((b, len(STAGES)))}
    if on["reverb"]:
        d["reverb_ir"] = randint(0, assets.ir_bank.shape[0])
    if on["overlap"]:
        n_ov, nlen = assets.overlap_bank.shape
        d.update(overlap_shift=randint(0, int(0.75 * t)),
                 overlap_row=randint(0, n_ov),
                 overlap_beg=randint(0, max(nlen - t, 1)),
                 overlap_snr=randint(0, len(cfg.overlap_snrs)))
        if _overlap_reverb(cfg, assets):
            d["overlap_ir"] = randint(0, assets.ir_bank.shape[0])
    if on["noises"]:
        n_noise, nlen = assets.noise_bank.shape
        d.update(noise_row=randint(0, n_noise),
                 noise_beg=randint(0, max(nlen - t, 1)),
                 noise_snr=randint(0, len(cfg.noises_snrs)))
    if on["speed"]:
        d["speed_warp"] = uniform((b,), *cfg.speed_range)
    if on["resample"]:
        d["resample_factor"] = randint(0, len(cfg.resample_factors))
    if on["clip"]:
        d["clip_factor"] = randint(0, len(cfg.clip_factors))
    if on["chop"]:
        m = int(cfg.max_chops)
        d.update(chop_n=randint(1, m + 1),
                 chop_u=uniform((b, t // VAD_WIN), 1e-6, 1 - 1e-6),
                 chop_factor=randint(0, len(cfg.chop_factors), (b, m)),
                 chop_normal=torch.randn((b, m), generator=generator,
                                         device=dev))
    if on["bandrop"]:
        d["bandrop_filter"] = randint(0, assets.bandrop_bank.shape[0])
    if on["downsample"]:
        d["downsample_filter"] = randint(0, assets.downsample_bank.shape[0])
    return DistortionDraws(**d)


# ---------------------------------------------------------------------------
# stages, [B, T] -> [B, T]
# ---------------------------------------------------------------------------


def _energy(x):
    return torch.sum(x * x, dim=-1)


def _norm_energy(out, in_energy, eps=1e-14):
    return torch.sqrt(in_energy / (_energy(out) + eps))[:, None] * out


def _slice(y, start, t):
    """y[i, start[i]:start[i] + t] per row, the start clamped so the slice
    fits (``jax.lax.dynamic_slice``)."""
    start = torch.clamp(start, 0, y.shape[-1] - t)
    return torch.gather(y, 1, start[:, None] + torch.arange(
        t, device=y.device))


def _bank_rows(bank, row, beg, t):
    return _slice(bank[row], beg, t)


def _snr_gain(ex, en, snr):
    """The noise gain that puts energy en at snr dB below energy ex (1
    for silent noise)."""
    k = torch.sqrt(ex / ((10.0 ** (snr / 10.0)) * torch.clamp(en, min=1e-20)))
    return torch.where(en > 0, k, 1.0)


def _table(values, device):
    return torch.tensor(values, dtype=torch.float32, device=device)


def reverb(wav, ir_idx, ir_bank, ir_pmax):
    """Convolve each row with its IR, shift left by the IR's peak, match
    the energy of the full convolution to the input's."""
    t = wav.shape[-1]
    ex = _energy(wav)
    rev = fft_convolve_full(wav, ir_bank[ir_idx])
    er = _energy(rev)
    rev = _slice(rev, ir_pmax[ir_idx].long(), t)
    eratio = torch.where(er > 0, torch.sqrt(ex / torch.clamp(er, min=1e-20)),
                         1.0)
    return eratio[:, None] * rev


def additive(wav, row, beg, snr_idx, noise_bank, snrs):
    """SNR-scaled additive noise, renormalized to the input energy."""
    noise = _bank_rows(noise_bank, row, beg, wav.shape[-1])
    snr = _table(snrs, wav.device)[snr_idx]
    ex, en = _energy(wav), _energy(noise)
    noisy = wav + _snr_gain(ex, en, snr)[:, None] * noise
    return torch.where((en > 0)[:, None], _norm_energy(noisy, ex), wav)


def overlap(wav, draws, overlap_bank, snrs, dec_res, reverb_assets=None):
    """Overlapping speech from each row's onset on: (noisy [B, T], the
    frame-level overlap label [B, T // dec_res])."""
    b, t = wav.shape
    noise = _bank_rows(overlap_bank, draws.overlap_row, draws.overlap_beg, t)
    if reverb_assets is not None:
        noise = reverb(noise, draws.overlap_ir, *reverb_assets)
    active = (torch.arange(t, device=wav.device)[None]
              >= draws.overlap_shift[:, None])
    noise = torch.where(active, noise, 0.0)
    snr = _table(snrs, wav.device)[draws.overlap_snr]
    ex, en = _energy(wav), _energy(noise)
    noisy = _norm_energy(wav + _snr_gain(ex, en, snr)[:, None] * noise, ex)
    mask = active.to(wav.dtype).reshape(b, -1, dec_res).mean(dim=2)
    return noisy, mask


def clipping(wav, factor_idx, clip_factors):
    cf = _table(clip_factors, wav.device)[factor_idx][:, None]
    clip = torch.maximum(wav, cf * wav.amin(dim=-1, keepdim=True))
    return torch.minimum(clip, cf * wav.amax(dim=-1, keepdim=True))


def chopper(wav, draws, chop_factors, max_chops, sr=16000):
    """Zero up to ``max_chops`` windows of Gaussian length centred on
    distinct random speech frames.

    Speech frames: VAD_WIN-sample frames whose energy is within
    VAD_THRESH_DB of the row's loudest frame and above -55 dB (a silent
    row has none and stays as it is). The JAX package picks the centres by
    Gumbel top-k over the speech frames; with equal logits that ranks the
    frames by -log(-log u), which is increasing in u, so ranking the
    uniforms themselves picks the same frames."""
    b, t = wav.shape
    nf = t // VAD_WIN
    frames = wav[:, :nf * VAD_WIN].reshape(b, nf, VAD_WIN)
    fe = torch.log10(torch.mean(frames * frames, dim=2) + 1e-12) * 10
    thresh = torch.clamp(fe.amax(dim=1, keepdim=True) + VAD_THRESH_DB,
                         min=-55.0)
    speech = fe > thresh                                   # [B, F]
    scores = torch.where(speech, draws.chop_u, -1.0)
    # best first; a stable sort of the negated scores breaks ties by
    # index, as jnp.argsort does
    order = torch.argsort(-scores, dim=1, stable=True)
    factors = _table(chop_factors, wav.device)             # [n_cf, 2]
    mean = factors[draws.chop_factor, 0]
    std = factors[draws.chop_factor, 1]
    durs = (mean + draws.chop_normal * std) * sr           # [B, max_chops]
    pos = torch.arange(t, dtype=wav.dtype, device=wav.device)[None]
    keep = torch.ones_like(wav, dtype=torch.bool)
    any_speech = speech.any(dim=1)
    for i in range(int(max_chops)):
        frame = order[:, i:i + 1]
        center = (frame * VAD_WIN + VAD_WIN // 2).to(wav.dtype)
        half = durs[:, i:i + 1] / 2.0
        inside = (pos >= center - half) & (pos <= center + half)
        active = ((i < draws.chop_n) & any_speech
                  & torch.gather(speech, 1, frame)[:, 0])
        keep = keep & ~(inside & active[:, None])
    return torch.where(keep, wav, 0.0)


def fir_filter(wav, filt_idx, filt_bank, filt_lens=None):
    """FIR filtering with group-delay compensation and energy match
    (BandDrop / Downsample). The bank is zero-padded to its longest
    filter; the delay removed is round(len / 2) of each filter's own
    length (``filt_lens``), or of the padded width when it is None."""
    b, t = wav.shape
    width = filt_bank.shape[1]
    ex = _energy(wav)
    y = F.pad(fft_convolve_full(wav, filt_bank[filt_idx]), (0, width))
    if filt_lens is None:
        shift = torch.full((b,), round(width / 2), dtype=torch.long,
                           device=wav.device)
    else:
        # half to even, as python's round and jnp.round
        shift = torch.round(filt_lens[filt_idx].to(torch.float32)
                            / 2.0).long()
    y = _slice(y, shift, t)
    ef = _energy(y)
    eratio = torch.where(ef > 0, torch.sqrt(ex / torch.clamp(ef, min=1e-20)),
                         1.0)
    return torch.where((ef > 0)[:, None], eratio[:, None] * y, wav)


def resample(wav, factor_idx, aa_bank, factors):
    """Decimate each row by its factor q through the zero-phase anti-alias
    FIR of q (``build_resample_filters``), then interpolate linearly back
    (align_corners) and keep the first T samples. Every factor is computed
    for the whole batch and each row keeps its own."""
    t = wav.shape[-1]
    c = (aa_bank.shape[1] - 1) // 2
    out = wav
    for i, q in enumerate(factors):
        q = int(q)
        y = fft_convolve_full(wav, aa_bank[i])[:, c:c + t]   # 'same' conv
        lr = y[:, ::q]
        n = lr.shape[1]
        pos = (torch.arange(n * q, dtype=wav.dtype, device=wav.device)
               * ((n - 1) / max(n * q - 1, 1)))
        lo = torch.floor(pos).long()
        hi = torch.clamp(lo + 1, max=n - 1)
        frac = pos - lo.to(wav.dtype)
        v = (lr[:, lo] * (1 - frac) + lr[:, hi] * frac)[:, :t]
        out = v if i == 0 else torch.where((factor_idx == i)[:, None], v,
                                           out)
    return out


def speed(wav, warp):
    """Speed perturbation: resample to T(1 + w) samples (w > 0 slows
    playback) by linear interpolation, centre-cropped (w >= 0) or centred
    in zero padding (w < 0) back to T."""
    t = wav.shape[-1]
    warp = warp.to(wav.dtype)[:, None]
    tw = t + torch.floor(warp * t)                          # warped length
    # read-position step; a tensor numerator: a python number over a
    # tensor is computed as number * (1 / tensor), rounded twice
    scale = torch.full_like(tw, t) / tw
    mid = torch.floor(tw / 2.0) - t // 2
    pad = torch.floor((t - tw) / 2.0)
    i = torch.arange(t, dtype=wav.dtype, device=wav.device)[None]
    j = torch.where(warp >= 0, i + mid, i - pad)            # warped index
    valid = (j >= 0) & (j < tw)
    src = torch.clamp(j * scale, 0.0, t - 1.0)
    lo = torch.floor(src).long()
    hi = torch.clamp(lo + 1, max=t - 1)
    frac = src - lo.to(wav.dtype)
    out = (torch.gather(wav, 1, lo) * (1 - frac)
           + torch.gather(wav, 1, hi) * frac)
    return torch.where(valid, out, 0.0)


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------


def apply_distortions(wav, draws, cfg, assets, dec_res=160):
    """[B, T] clean chunks -> (distorted [B, T], overlap label
    [B, T // dec_res]), every stage gated per row by draws.gate."""
    b, t = wav.shape
    on = enabled_stages(cfg, assets)
    overlap_mask = wav.new_zeros((b, t // dec_res))

    def gate(stage, p):
        return (draws.gate[:, STAGES.index(stage)] < p)[:, None]

    if on["reverb"]:
        y = reverb(wav, draws.reverb_ir, assets.ir_bank, assets.ir_pmax)
        wav = torch.where(gate("reverb", cfg.reverb_p), y, wav)
    if on["overlap"]:
        rev = ((assets.ir_bank, assets.ir_pmax)
               if _overlap_reverb(cfg, assets) else None)
        y, mask = overlap(wav, draws, assets.overlap_bank, cfg.overlap_snrs,
                          dec_res, rev)
        g = gate("overlap", cfg.overlap_p)
        wav = torch.where(g, y, wav)
        overlap_mask = torch.where(g, mask, overlap_mask)
    if on["noises"]:
        y = additive(wav, draws.noise_row, draws.noise_beg, draws.noise_snr,
                     assets.noise_bank, cfg.noises_snrs)
        wav = torch.where(gate("noises", cfg.noises_p), y, wav)
    if on["speed"]:
        y = speed(wav, draws.speed_warp)
        wav = torch.where(gate("speed", cfg.speed_p), y, wav)
    if on["resample"]:
        y = resample(wav, draws.resample_factor, assets.resample_filters,
                     cfg.resample_factors)
        wav = torch.where(gate("resample", cfg.resample_p), y, wav)
    if on["clip"]:
        y = clipping(wav, draws.clip_factor, cfg.clip_factors)
        wav = torch.where(gate("clip", cfg.clip_p), y, wav)
    if on["chop"]:
        y = chopper(wav, draws, cfg.chop_factors, cfg.max_chops, cfg.sr)
        wav = torch.where(gate("chop", cfg.chop_p), y, wav)
    if on["bandrop"]:
        y = fir_filter(wav, draws.bandrop_filter, assets.bandrop_bank,
                       assets.bandrop_lens)
        wav = torch.where(gate("bandrop", cfg.bandrop_p), y, wav)
    if on["downsample"]:
        y = fir_filter(wav, draws.downsample_filter, assets.downsample_bank,
                       assets.downsample_lens)
        wav = torch.where(gate("downsample", cfg.downsample_p), y, wav)
    return wav, overlap_mask


# ---------------------------------------------------------------------------
# asset loading (host side)
# ---------------------------------------------------------------------------


def load_ir_bank(files, data_root=".", fmt="npy", max_len=24000):
    """Impulse responses -> (bank [n, max len] zero-padded, pmax [n] the
    argmax of |ir|, lens [n]), each IR cut to max_len and scaled by its
    largest value when that is positive."""
    irs = []
    for f in files:
        path = os.path.join(data_root, f)
        if fmt == "npy":
            ir = np.load(path)
        elif fmt in ("imp", "txt"):
            ir = np.loadtxt(path)
        elif fmt == "wav":
            from pase_tpu_torch.data.io import read_wav
            ir, _ = read_wav(path)
        else:
            raise TypeError(f"Unrecognized IR format: {fmt}")
        ir = np.asarray(ir, dtype=np.float32)[:max_len]
        if np.max(ir) > 0:
            ir = ir / np.abs(np.max(ir))
        irs.append(ir)
    bank = np.zeros((len(irs), max(len(i) for i in irs)), dtype=np.float32)
    pmax = np.zeros((len(irs),), dtype=np.int32)
    lens = np.zeros((len(irs),), dtype=np.int32)
    for i, ir in enumerate(irs):
        bank[i, :len(ir)] = ir
        pmax[i] = int(np.argmax(np.abs(ir)))
        lens[i] = len(ir)
    return (torch.from_numpy(bank), torch.from_numpy(pmax),
            torch.from_numpy(lens))


def build_resample_filters(factors, max_taps=4096, tol=1e-7):
    """Zero-phase anti-alias kernels for the resample stage, one per
    integer factor q: the impulse response of scipy.signal.decimate's
    default filter (order-8 Chebyshev-I, rp 0.05 dB, Wn 0.8/q) applied
    forward and backward, truncated where the one-pass response falls
    below tol of its peak. A centred [n_q, K] bank (K odd)."""
    from scipy.signal import cheby1, lfilter
    kers = []
    for q in factors:
        b, a = cheby1(8, 0.05, 0.8 / int(q))
        delta = np.zeros(max_taps, np.float64)
        delta[0] = 1.0
        h1 = lfilter(b, a, delta)
        mag = np.abs(h1)
        keep = np.where(mag > tol * mag.max())[0]
        h1 = h1[: int(keep[-1]) + 1]
        kers.append(np.convolve(h1, h1[::-1]).astype(np.float32))
    k = max(len(h) for h in kers)
    bank = np.zeros((len(kers), k), np.float32)
    for i, h in enumerate(kers):
        off = (k - len(h)) // 2                 # both odd: stays centred
        bank[i, off:off + len(h)] = h
    return torch.from_numpy(bank)


def load_wav_bank(files, target_len):
    """Noise / overlap wavs -> a [n, target_len] bank (cropped, or tiled
    when shorter)."""
    from pase_tpu_torch.data.io import read_wav
    bank = np.zeros((len(files), target_len), dtype=np.float32)
    for i, f in enumerate(files):
        w, _ = read_wav(f)
        if len(w) < target_len:
            w = np.tile(w, int(np.ceil(target_len / max(len(w), 1))))
        bank[i] = w[:target_len]
    return torch.from_numpy(bank)


def build_assets(dcfg_json, cfg, chunk_size):
    """The asset banks a distortion cfg names, loaded from disk: IRs from
    ``reverb_irfiles`` (or every ``*.{reverb_fmt}`` under
    ``reverb_data_root``), noise from the wavs of ``noises_dir``, overlap
    speech from ``overlap_list`` under ``overlap_dir`` (or its wavs), both
    at 2 x chunk_size samples, the bandrop / downsample filters, and the
    resample filters of ``resample_factors``. A stage whose files are not
    found stays off."""
    ir_bank = ir_pmax = noise_bank = overlap_bank = None
    filters = {}
    if cfg.reverb_p > 0:
        root = dcfg_json.get("reverb_data_root", ".")
        fmt = dcfg_json.get("reverb_fmt", "npy")
        files = dcfg_json.get("reverb_irfiles") or [
            os.path.basename(f) for f in glob.glob(
                os.path.join(root, f"*.{fmt}"))]
        if files:
            ir_bank, ir_pmax, _ = load_ir_bank(files, root, fmt)
    if cfg.noises_p > 0 and dcfg_json.get("noises_dir"):
        dirs = dcfg_json["noises_dir"]
        dirs = dirs if isinstance(dirs, list) else [dirs]
        files = [f for d in dirs for f in glob.glob(os.path.join(d, "*.wav"))]
        if files:
            noise_bank = load_wav_bank(files, 2 * chunk_size)
    if cfg.overlap_p > 0 and dcfg_json.get("overlap_dir"):
        if dcfg_json.get("overlap_list"):
            with open(dcfg_json["overlap_list"]) as f:
                files = [os.path.join(dcfg_json["overlap_dir"], ln.strip())
                         for ln in f if ln.strip()]
        else:
            files = glob.glob(os.path.join(dcfg_json["overlap_dir"],
                                           "*.wav"))
        if files:
            overlap_bank = load_wav_bank(files, 2 * chunk_size)
    for key in ("bandrop", "downsample"):
        files = dcfg_json.get(f"{key}_irfiles") or []
        if getattr(cfg, f"{key}_p") > 0 and files:
            bank, _, lens = load_ir_bank(
                files, dcfg_json.get(f"{key}_data_root", "."),
                dcfg_json.get(f"{key}_fmt", "npy"))
            filters[f"{key}_bank"], filters[f"{key}_lens"] = bank, lens
    resample_filters = None
    if cfg.resample_p > 0 and cfg.resample_factors:
        resample_filters = build_resample_filters(cfg.resample_factors)
    return DistortionAssets(ir_bank=ir_bank, ir_pmax=ir_pmax,
                            noise_bank=noise_bank, overlap_bank=overlap_bank,
                            resample_filters=resample_filters, **filters)
