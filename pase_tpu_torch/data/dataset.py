"""Synthetic raw-chunk sources for tests and the synthetic training CLI.

Both mirror the MI-tuple structure of real data: 'chunk' and 'chunk_ctxt'
come from the same synthetic 'speaker' (shared f0 and spectral tilt,
different phases, envelope and noise), 'chunk_rand' from another, so the
LIM / GIM contrastive tasks are learnable.

* ``SyntheticChunkBatcher`` — numpy, an exact copy of
  ``pase_tpu.data.dataset.SyntheticChunkBatcher``: the same seed gives the
  same arrays.
* ``DeviceSyntheticBatcher`` — the same signal family drawn on the device
  with a ``torch.Generator``; it keeps the synthetic training loop off
  the host. Its random streams are not the JAX package's.
"""

import math

import numpy as np
import torch


class SyntheticChunkBatcher:
    """Deterministic numpy synthetic batches {chunk, chunk_ctxt,
    chunk_rand} of [batch_size, chunk_size] float32."""

    def __init__(self, batch_size, chunk_size, seed=0, bpe=100):
        self.batch_size = batch_size
        self.chunk_size = chunk_size
        self.rng = np.random.RandomState(seed)
        self.bpe = bpe

    def _speechlike(self, f0, tilt, t):
        b = f0.shape[0]
        n = np.arange(t, dtype=np.float32)
        f0 = f0.astype(np.float32)
        sig = np.zeros((b, t), np.float32)
        for k in range(1, 6):
            ph = self.rng.uniform(0, 6.28, (b, 1)).astype(np.float32)
            sig += np.sin(2 * np.pi * f0 * k * n[None, :] / 16000 + ph,
                          dtype=np.float32) / (k ** tilt).astype(np.float32)
        env = 0.5 + 0.5 * np.sin(
            2 * np.pi * self.rng.uniform(1, 4, (b, 1)).astype(np.float32)
            * n[None, :] / 16000
            + self.rng.uniform(0, 6.28, (b, 1)).astype(np.float32),
            dtype=np.float32)
        noise = self.rng.randn(b, t).astype(np.float32) * 0.05
        return sig * env * np.float32(0.2) + noise

    def _make_batch(self):
        b, t = self.batch_size, self.chunk_size
        f0 = self.rng.uniform(80, 260, size=(b, 1))
        tilt = self.rng.uniform(0.7, 1.5, size=(b, 1))
        f0_rand = self.rng.uniform(80, 260, size=(b, 1))
        tilt_rand = self.rng.uniform(0.7, 1.5, size=(b, 1))
        return {"chunk": self._speechlike(f0, tilt, t),
                "chunk_ctxt": self._speechlike(f0, tilt, t),
                "chunk_rand": self._speechlike(f0_rand, tilt_rand, t)}

    def __iter__(self):
        while True:
            yield self._make_batch()


class DeviceSyntheticBatcher:
    """Synthetic batches made on ``device`` from a ``torch.Generator``
    seeded with ``seed``: harmonic stacks of 5 partials at f0 ~ U[80, 260)
    Hz with 1/k^tilt amplitudes (tilt ~ U[0.7, 1.5)), a slow sine envelope
    (U[1, 4) Hz), times 0.2, plus N(0, 0.05^2) noise."""

    def __init__(self, batch_size, chunk_size, seed=0, device="cuda"):
        self.batch_size = batch_size
        self.chunk_size = chunk_size
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)
        self._n = torch.arange(chunk_size, dtype=torch.float32,
                               device=self.device)

    def _uniform(self, lo, hi, shape):
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return lo + (hi - lo) * u

    def _speechlike(self, f0, tilt):
        b = self.batch_size
        ks = torch.arange(1, 6, dtype=torch.float32,
                          device=self.device)[:, None, None]
        phases = self._uniform(0.0, 6.28, (5, b, 1))
        sig = torch.sum(torch.sin(2 * math.pi * f0[None] * ks * self._n
                                  / 16000 + phases) / ks ** tilt[None], 0)
        env = 0.5 + 0.5 * torch.sin(
            2 * math.pi * self._uniform(1.0, 4.0, (b, 1)) * self._n / 16000
            + self._uniform(0.0, 6.28, (b, 1)))
        noise = torch.randn((b, self.chunk_size), generator=self.generator,
                            device=self.device) * 0.05
        return sig * env * 0.2 + noise

    def make_batch(self):
        b = self.batch_size
        f0 = self._uniform(80.0, 260.0, (b, 1))
        tilt = self._uniform(0.7, 1.5, (b, 1))
        f0r = self._uniform(80.0, 260.0, (b, 1))
        tiltr = self._uniform(0.7, 1.5, (b, 1))
        return {"chunk": self._speechlike(f0, tilt),
                "chunk_ctxt": self._speechlike(f0, tilt),
                "chunk_rand": self._speechlike(f0r, tiltr)}

    def __iter__(self):
        while True:
            yield self.make_batch()
