"""Host-side (CPU) distortions: the Codec2 round trip and ahocoder
whisperization, applied to raw numpy batches before they reach the card.

The port of ``pase_tpu/data/host_distortions.py`` (the reference's
Codec2Buffer / Codec2Cached and Whisperize, pase/transforms.py:2039-2325),
with the same names, draws and arithmetic. Host numpy and scipy, as in
the JAX package: a codec is sequential, branchy work on short int16
frames, and the stage runs on the batch before the transfer.

One difference: ``Codec2RoundTrip`` never turns into identity. Its last
backend, the codec2-style LPC vocoder, is this package's own source
(``csrc/codec2_lite.cc``), built at first use by ``ops.host_build``; a
missing compiler or a failed build raises. ``Whisperize`` without the
ahocoder binaries (and without a cache hit) is identity, as in JAX.

``HostDistortionStage`` also keeps counters that draw nothing: the rows
it saw, the rows each transform degraded, and its seconds (``summary``).
"""

import ctypes
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np

from pase_tpu_torch.data.io import read_wav, write_wav

_CODEC2LITE = {}


def _have(binary):
    return shutil.which(binary) is not None


def load_codec2lite():
    """ctypes handle to the codec2-style vocoder (``csrc/codec2_lite.cc``),
    built at first use; raises when it cannot be built."""
    if "lib" not in _CODEC2LITE:
        from pase_tpu_torch.ops import host_build
        _CODEC2LITE["lib"] = host_build.load(
            host_build.source_path("codec2_lite"),
            {"codec2lite_roundtrip": (ctypes.c_long, [
                ctypes.POINTER(ctypes.c_float), ctypes.c_long,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int])})
    return _CODEC2LITE["lib"]


class Codec2RoundTrip:
    """Encode + decode through codec2 at ``kbps`` (default the 1600 bps
    mode), returning the degraded waveform (transforms.py:2131-2325).

    Backend order: pycodec2 > the c2enc / c2dec binaries > the vendored
    codec2-style LPC vocoder (a workalike of the same codec family).
    ``cache_dir``: a wav of the utterance's name there is read instead."""

    def __init__(self, kbps=1600, cache_dir=None):
        self.kbps = kbps
        self.cache_dir = cache_dir
        try:
            import pycodec2  # noqa: F401
            self.pycodec2 = True
        except ImportError:
            self.pycodec2 = False
        binaries = _have("c2enc") and _have("c2dec")
        self.lite = (None if self.pycodec2 or binaries
                     else load_codec2lite())
        # JAX's flag; the vocoder's source ships, so never identity
        self.available = True

    def _lite_roundtrip(self, wav, sr):
        """Codec2Buffer semantics (transforms.py:2150-2181): decimate to
        8 kHz, int16 grid, codec round trip, resample back to sr,
        energy-match to the input (norm_energy, transforms.py:154)."""
        from scipy.signal import decimate, resample
        inwav = wav.astype(np.float32)
        x8 = decimate(inwav, sr // 8000).astype(np.float32)
        # int16 grid like the reference's int16 packing
        x8 = np.round(np.clip(x8, -1, 1) * (2 ** 15)) / (2 ** 15)
        x8 = np.ascontiguousarray(x8, np.float32)
        out8 = np.zeros_like(x8)
        rc = self.lite.codec2lite_roundtrip(
            x8.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x8),
            out8.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            int(self.kbps))
        if rc < 0:
            return wav
        out = resample(out8, len(out8) * (sr // 8000)).astype(np.float32)
        out = out[:len(inwav)]
        ie = float(np.dot(inwav, inwav))
        oe = float(np.dot(out, out))
        return (np.sqrt(ie / (oe + 1e-14)) * out).astype(np.float32)

    def __call__(self, wav, uttname=None, sr=16000):
        if self.cache_dir and uttname:
            path = os.path.join(self.cache_dir, uttname)
            if os.path.exists(path):
                cached, _ = read_wav(path)
                n = min(len(cached), len(wav))
                out = np.zeros_like(wav)
                out[:n] = cached[:n]
                return out
        if self.lite is not None:
            return self._lite_roundtrip(wav, sr)
        if self.pycodec2:
            import pycodec2
            c2 = pycodec2.Codec2(self.kbps)
            spf = c2.samples_per_frame()
            pcm = (np.clip(wav, -1, 1) * 32767).astype(np.int16)
            n = (len(pcm) // spf) * spf
            out = np.zeros(n, dtype=np.int16)
            for i in range(0, n, spf):
                out[i:i + spf] = c2.decode(c2.encode(pcm[i:i + spf]))
            res = np.zeros_like(wav)
            res[:n] = out.astype(np.float32) / 32768.0
            return res
        with tempfile.TemporaryDirectory() as td:
            raw = os.path.join(td, "in.raw")
            enc = os.path.join(td, "enc.c2")
            dec = os.path.join(td, "out.raw")
            (np.clip(wav, -1, 1) * 32767).astype("<i2").tofile(raw)
            mode = str(self.kbps)
            subprocess.run(["c2enc", mode, raw, enc], check=True)
            subprocess.run(["c2dec", mode, enc, dec], check=True)
            out = np.fromfile(dec, dtype="<i2").astype(np.float32) / 32768.0
            res = np.zeros_like(wav)
            n = min(len(out), len(wav))
            res[:n] = out[:n]
            return res


class Whisperize:
    """Unvoice a waveform through the ahocoder vocoder (encode, overwrite
    F0 / FV with unvoiced values, decode; transforms.py:2039-2127)."""

    def __init__(self, cache_dir=None, sr=16000):
        self.cache_dir = cache_dir
        self.sr = sr
        self.available = _have("ahocoder16_64") and _have("ahodecoder16_64")
        if not self.available and cache_dir is None:
            print("[host_distortions] ahocoder unavailable; Whisperize is "
                  "identity")

    def __call__(self, wav, uttname=None, chunk_beg=0, chunk_end=None):
        if self.cache_dir and uttname:
            path = os.path.join(self.cache_dir, os.path.basename(uttname))
            if os.path.exists(path):
                cached, _ = read_wav(path)
                end = chunk_end if chunk_end is not None else len(wav)
                if len(cached) < end:
                    cached = np.pad(cached, (0, end - len(cached)))
                return cached[chunk_beg:end].astype(np.float32)
        if not self.available:
            return wav
        with tempfile.TemporaryDirectory() as td:
            inw = os.path.join(td, "in.wav")
            f0 = os.path.join(td, "a.lf0")
            cc = os.path.join(td, "a.cc")
            fv = os.path.join(td, "a.fv")
            write_wav(inw, wav, self.sr)
            subprocess.run(["ahocoder16_64", inw, f0, cc, fv], check=True)
            n = os.path.getsize(f0) // 4
            np.full(n, -1e10, dtype="<f4").tofile(f0)
            np.full(n, 1e3, dtype="<f4").tofile(fv)
            outw = os.path.join(td, "out.wav")
            subprocess.run(["ahodecoder16_64", f0, cc, fv, outw], check=True)
            out, _ = read_wav(outw)
            res = np.zeros_like(wav)
            m = min(len(out), len(wav))
            res[:m] = out[:m]
            return res


class HostDistortionStage:
    """Applies host-side distortions to a raw numpy batch, each transform
    to each row with its probability, before the transfer. The draws are
    one ``np.random.RandomState(seed)`` in the JAX package's order
    (transform-major, then row); a zero-speech row (``zs_mask``) skips the
    whole stack (the reference's dataset returns before its transforms on
    such rows), though its draws are still made."""

    def __init__(self, transforms, probs, seed=0):
        self.transforms = transforms
        self.probs = probs
        self.rng = np.random.RandomState(seed)
        self.rows = 0
        self.fired = [0] * len(transforms)
        self.seconds = 0.0
        self.batches = 0

    def __call__(self, batch):
        t0 = time.perf_counter()
        chunk = batch["chunk"].copy()
        zs = np.asarray(batch.get("zs_mask", np.zeros(chunk.shape[0])))
        zs = zs.reshape(chunk.shape[0], -1)[:, 0] > 0
        for j, (t, p) in enumerate(zip(self.transforms, self.probs)):
            for i in range(chunk.shape[0]):
                if self.rng.rand() < p and not zs[i]:
                    chunk[i] = t(chunk[i])
                    self.fired[j] += 1
        out = dict(batch)
        out["chunk"] = chunk
        self.rows += chunk.shape[0]
        self.batches += 1
        self.seconds += time.perf_counter() - t0
        return out

    def summary(self):
        """{'rows', 'batches', 'ms_per_batch', 'fired_<name>' and
        'share_<name>' per transform} of the batches staged so far."""
        out = {"rows": self.rows, "batches": self.batches,
               "ms_per_batch": 1e3 * self.seconds / max(self.batches, 1)}
        for t, n in zip(self.transforms, self.fired):
            name = type(t).__name__
            out[f"fired_{name}"] = n
            out[f"share_{name}"] = n / max(self.rows, 1)
        return out


class StagedBatcher:
    """Wraps a batcher so every raw numpy batch passes through a
    ``HostDistortionStage`` before the transfer, in the consuming thread
    (the reference applies codec2 / whisperize inside its DataLoader
    workers)."""

    def __init__(self, batcher, stage):
        self.batcher = batcher
        self.stage = stage

    @property
    def bpe(self):
        return getattr(self.batcher, "bpe", None)

    def __iter__(self):
        for batch in self.batcher:
            yield self.stage(batch)


def asl_p56(x, srate=16000, nbits=16, eps=1e-22):
    """ITU-T P.56 method-B active speech level (the measurement inside
    the legacy Additive distortion, transforms.py:1921-2025).

    Returns (asl_ms, asl, c0): mean-square active level, activity
    factor, and the active-level threshold (None when no activity). The
    reference's per-sample loop with per-threshold hangover counters is
    the vectorized form of the JAX package: a sample is active for
    threshold c[j] iff it lies within I samples of the last envelope
    exceedance (the activity sets are nested, so the loop's early break
    changes nothing)."""
    from scipy.signal import lfilter
    T, H, M = 0.03, 0.2, 15.9
    thres_no = nbits - 1
    I = int(np.ceil(srate * H))     # noqa: E741 (the standard's name)
    g = np.exp(-1.0 / (srate * T))
    c = 2.0 ** np.arange(-15, thres_no - 15)      # 2^-15 .. 0.5
    x = np.asarray(x, np.float64).reshape(-1)
    sq = float(np.dot(x, x))
    x_len = len(x)
    p = lfilter([1 - g], [1, -g], np.abs(x))
    q = lfilter([1 - g], [1, -g], p)
    k = np.arange(x_len)
    a = np.zeros(thres_no)
    for j in range(thres_no):
        act = q >= c[j]
        if not act.any():
            break                                  # nested: higher too
        last = np.maximum.accumulate(np.where(act, k, -x_len - I - 1))
        a[j] = int(np.count_nonzero(k - last <= I))
    if a[0] == 0:
        return 0.0, 0.0, None
    AdB = 10 * np.log10(sq / (a + eps) + eps)
    CdB = 20 * np.log10(c + eps)
    if AdB[0] - CdB[0] < M:
        return 0.0, 0.0, None
    for j in range(1, thres_no):
        if a[j] != 0 and (AdB[j] - CdB[j]) <= M:
            asl_ms_log, cl0 = _bin_interp(AdB[j], AdB[j - 1],
                                          CdB[j], CdB[j - 1], M, 0.5)
            asl_ms = 10 ** (asl_ms_log / 10)
            return asl_ms, (sq / x_len) / asl_ms, 10 ** (cl0 / 20)
    return 0.0, 0.0, None


def _bin_interp(upcount, lwcount, upthr, lwthr, margin, tol):
    """P.56 bisection between adjacent thresholds (transforms.py:
    1987-2025), with its quirks: both early-outs return the LOWER count,
    and the diff < -tol branch averages (mid - lw) / 2."""
    tol = abs(tol)
    if abs(upcount - upthr - margin) < tol or \
            abs(lwcount - lwthr - margin) < tol:
        return lwcount, lwthr
    midcount = (upcount + lwcount) / 2
    midthr = (upthr + lwthr) / 2
    iterno = 1
    while True:
        diff = midcount - midthr - margin
        if abs(diff) <= tol:
            return midcount, midthr
        iterno += 1
        if iterno > 20:
            tol *= 1.1
        if diff > tol:
            midcount = (upcount + midcount) / 2
            midthr = (upthr + midthr) / 2
        elif diff < -tol:
            midcount = (midcount - lwcount) / 2
            midthr = (midthr + lwthr) / 2


class AdditiveP56:
    """Legacy ``Additive`` distortion (transforms.py:1783-1870): the noise
    is scaled so the SNR is measured against the P.56 ACTIVE speech level
    (method B), then the mix is attenuated by 1 / (1 + 0.1 k) until it
    fits [-1, 1). ``noises``: waveform arrays or a directory of wavs.
    do_IRS (telephone-band filtering) is unimplemented in the reference
    too and is rejected."""

    def __init__(self, noises, snr_levels=(0, 5, 10), do_IRS=False, seed=0):
        if do_IRS:
            raise NotImplementedError(
                "do_IRS is under construction in the reference as well "
                "(transforms.py:1873)")
        if isinstance(noises, str):
            import glob as _glob
            files = sorted(_glob.glob(os.path.join(noises, "*.wav")))
            if not files:
                raise ValueError(f"[!] No noises found in {noises}")
            noises = [read_wav(f)[0] for f in files]
        if not noises:
            raise ValueError("[!] No noises given")
        self.noises = [np.asarray(n, np.float32).reshape(-1)
                       for n in noises]
        self.snr_levels = list(snr_levels)
        self.rng = np.random.RandomState(seed)
        self.eps = 1e-22

    def __call__(self, wav, srate=16000, nbits=16):
        wav = np.asarray(wav, np.float32).reshape(-1)
        noise = self.noises[self.rng.randint(len(self.noises))]
        snr = self.snr_levels[self.rng.randint(len(self.snr_levels))]
        if len(noise) <= len(wav):
            raise ValueError("Noise length has to be greater than speech "
                             "length!")
        px, _, _ = asl_p56(wav, srate, nbits)
        start = int(np.round((len(noise) - len(wav)) *
                             self.rng.rand() + 1))
        seg = noise[start:start + len(wav)].astype(np.float64)
        pn = np.dot(seg, seg) / len(wav)
        sf = np.sqrt(px / pn / (10 ** (snr / 10))) if pn > 0 else 0.0
        noisy = wav + sf * seg
        small = 0.1
        while noisy.max() >= 1 or noisy.min() < -1:
            noisy = noisy / (1.0 + small)
            small += 0.1
        return noisy.astype(np.float32)


def build_host_stage(dcfg_json, seed=0):
    """The host stage of a distortion cfg's keys (transforms.py:38-146:
    codec2_p / codec2_kbps (or codec_kbits) / codec2_cachedir; whisper_p
    / whisper_cachedir), or None when none is configured."""
    transforms, probs = [], []
    codec2_p = float(dcfg_json.get("codec2_p", 0) or 0)
    if codec2_p > 0:
        transforms.append(Codec2RoundTrip(
            kbps=int(dcfg_json.get("codec2_kbps",
                                   dcfg_json.get("codec_kbits", 1600))),
            cache_dir=dcfg_json.get("codec2_cachedir")))
        probs.append(codec2_p)
    whisper_p = float(dcfg_json.get("whisper_p", 0) or 0)
    if whisper_p > 0:
        transforms.append(Whisperize(
            cache_dir=dcfg_json.get("whisper_cachedir")))
        probs.append(whisper_p)
    if not transforms:
        return None
    return HostDistortionStage(transforms, probs, seed=seed)
