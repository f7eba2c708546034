"""WAV read/write with the stdlib ``wave`` module and numpy (PCM)."""

import wave

import numpy as np


def read_wav(path):
    """Read a WAV file -> (float32 mono samples in [-1, 1], sample_rate).
    Multi-channel files keep their first channel."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        sw = w.getsampwidth()
        raw = w.readframes(n)
    if sw == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sw == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported sample width {sw} in {path}")
    if ch > 1:
        data = data.reshape(-1, ch)[:, 0].copy()
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
