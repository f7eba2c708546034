"""WAV and data-config IO on the host.

A stdlib ``wave`` / numpy PCM reader, with the repo's optional C++ decoder
(``native/libpase_wavio.so``, built by ``make -C native``) loaded through
``ctypes`` when it is there: threaded decode and random crops of a whole
batch (``native_load_chunk_batch``). Without the library every reader
takes the numpy path. The port's copy of ``pase_tpu/data/io.py``.
"""

import ctypes
import functools
import json
import os
import wave

import numpy as np

NATIVE_LIB = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native", "libpase_wavio.so")


@functools.cache
def _native_lib():
    """The C++ wav decoder with its signatures declared, or None."""
    if not os.path.exists(NATIVE_LIB):
        return None
    try:
        lib = ctypes.CDLL(NATIVE_LIB)
    except OSError:
        return None
    lib.read_wav_pcm16.restype = ctypes.c_long
    lib.read_wav_pcm16.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_long]
    lib.wav_num_samples.restype = ctypes.c_long
    lib.wav_num_samples.argtypes = [ctypes.c_char_p]
    lib.load_chunk_batch.restype = ctypes.c_long
    lib.load_chunk_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
        ctypes.c_ulonglong, ctypes.c_int]
    return lib


def native_load_chunk_batch(paths, chunk, seed=0, n_threads=8):
    """Decode and randomly crop a [len(paths), chunk] float32 batch in C++
    worker threads. None when the native library is absent or a file
    fails."""
    lib = _native_lib()
    if lib is None:
        return None
    b = len(paths)
    arr = (ctypes.c_char_p * b)(*[p.encode() for p in paths])
    out = np.empty((b, chunk), dtype=np.float32)
    r = lib.load_chunk_batch(
        arr, b, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        b, chunk, seed, n_threads)
    if r != b:
        return None
    return out


def read_wav(path):
    """Read a WAV file -> (float32 mono samples in [-1, 1], sample_rate).
    Multi-channel files keep their first channel."""
    lib = _native_lib()
    if lib is not None:
        n = lib.wav_num_samples(path.encode())
        if n > 0:
            buf = np.empty(n, dtype=np.float32)
            got = lib.read_wav_pcm16(
                path.encode(),
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
            if got == n:
                return buf, 16000
    data, sr = read_wav_channels(path)
    if data.ndim > 1:
        data = data[:, 0].copy()
    return data, sr


def wav_len(path):
    """Sample count from the WAV header alone (no decode)."""
    lib = _native_lib()
    if lib is not None:
        n = lib.wav_num_samples(path.encode())
        if n > 0:
            return int(n)
    with wave.open(path, "rb") as w:
        return w.getnframes()


def read_wav_channels(path):
    """Read a WAV keeping every channel -> ([N, C] or [N] float32, sr)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        sw = w.getsampwidth()
        raw = w.readframes(n)
    if sw == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 4:
        data = (np.frombuffer(raw, dtype="<i4").astype(np.float32)
                / 2147483648.0)
    elif sw == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported sample width {sw} in {path}")
    if ch > 1:
        data = data.reshape(-1, ch).copy()
    return data, sr


def write_wav(path, data, sr=16000):
    """Write mono float samples (clipped to [-1, 1]) as 16-bit PCM."""
    data = np.clip(np.asarray(data, dtype=np.float64), -1.0, 1.0)
    pcm = (data * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def load_data_cfg(path):
    """Load a data-config JSON: per split, the file list ('data': [{
    'filename', ...}]) and 'total_wav_dur' in samples; 'speakers'."""
    with open(path, "r") as f:
        return json.load(f)
