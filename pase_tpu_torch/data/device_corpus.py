"""The card-resident corpus: a whole train split on the device as one int16
buffer, with the crops sampled and gathered there.

The port of ``pase_tpu/data/device_corpus.py``'s single-buffer
``DeviceCorpusBatcher``. PCM16 audio is 2 bytes per sample: 50 h of
LibriSpeech is 5.76 GB, next to the model in the card's 80 GB. After the
build, the host sends the card nothing per step: crop starts are drawn on
the card from a ``torch.Generator`` and the rows gathered there with
plain torch indexing, so the feed costs no host-to-card copy and no host
time beyond a few launches.

Semantics kept from the host path (``data/dataset.py``):
  * tuple sampling: chunk from utterance i, chunk_ctxt from a random
    same-prefix neighbor (i itself when it has none), chunk_rand from a
    random other utterance;
  * a uniform crop start per row in [0, len - T]; utterances shorter than
    the chunk padded once at the build with ``crop_at``'s regime (the host
    path always crops them from 0 too);
  * int16 is lossless for PCM16 wavs: ``read_wav`` divides the stored
    sample by 32768, and x * 32768 restores it;
  * parallel clean/noisy corpora (``GenhancementDataset``) get a second,
    clean buffer: chunk and cchunk share one window (valid in both
    trees), chunk_ctxt is an independent crop of the clean utterance,
    chunk_rand comes from the noisy tree;
  * with ``zero_speech_p``, an anchor is drawn from a bank of
    ``zero_speech_bank`` near-silent utterances with that probability
    (1e-5 noise is silence on the int16 grid but for a rare sample of
    1 / 32768), and no zs_mask is emitted, as in the JAX batcher.

Deviations from the JAX batcher: the random streams differ (uniform draws
as there, from a ``torch.Generator`` instead of ``jax.random``); batch k
is drawn from ``step_seed(seed + 77, k)``, so ``batches(k)`` replays an
uninterrupted run's batches from step k on (JAX's ``feed_state(k)``);
and the offset, length and neighbor tables are int64 on the card, so the
JAX batcher's cap of 2^31 samples per buffer (its int32 gather) does not
apply. Not supported: zero-speech on a parallel corpus (raises), and the
sharded multi-card corpus.
"""

import numpy as np
import torch

from pase_tpu_torch.data.dataset import crop_at, step_seed, zerospeech

# the exclusive upper end of the raw draws reduced modulo a count or span
_DRAW_HIGH = 1 << 62


def _to_pcm16(wav):
    return np.clip(wav * 32768.0, -32768, 32767).astype(np.int16)


class DeviceCorpusBatcher:
    """Dicts of [B, T] float32 {chunk, chunk_ctxt, chunk_rand} (and cchunk
    for a parallel corpus) on ``device``, gathered from the corpus's int16
    buffer. ``bpe`` as the host ``ChunkBatcher``'s.

    dataset: a ``LibriSpeechTupleDataset`` or ``GenhancementDataset`` (its
    wavs, neighbor_prefixes and loaders; its host wav cache is emptied as
    the buffer is built)."""

    def __init__(self, dataset, batch_size, chunk_size, seed=0,
                 zero_speech_bank=16, device="cuda"):
        self.batch_size = batch_size
        self.chunk_size = chunk_size
        self.seed = seed + 77
        self.device = torch.device(device)
        self.bpe = max((dataset.total_wav_dur // chunk_size) // batch_size, 1)
        self.zero_speech_p = float(getattr(dataset, "zero_speech_p", 0.0))
        self.parallel = bool(getattr(dataset, "parallel", False))
        if self.parallel and self.zero_speech_p > 0:
            raise ValueError("zero-speech injection is not supported on "
                             "parallel (clean/noisy) device corpora")
        names = [w["filename"] for w in dataset.wavs]
        n = len(names)
        self.n_utts = n
        name_pos = {f: i for i, f in enumerate(names)}
        # neighbors[i]: the utterances of i's filename prefix but i, or [i]
        self.neighbors = []
        for i, f in enumerate(names):
            prefix = dataset.rec.sub("", f)
            sibs = [name_pos[s] for s in dataset.neighbor_prefixes[prefix]
                    if s != f]
            self.neighbors.append(np.asarray(sibs if sibs else [i],
                                             dtype=np.int64))

        def pack_tree(load, cache_prefix=""):
            """One wav tree -> (offsets, lengths, int16 parts, total)."""
            offs = np.empty(n, dtype=np.int64)
            lens = np.empty(n, dtype=np.int64)
            parts = []
            pos = 0
            for i, f in enumerate(names):
                wav = load(f)
                if len(wav) < chunk_size:
                    wav = crop_at(wav, 0, chunk_size)
                dataset.wav_cache.pop(cache_prefix + f, None)
                pcm = _to_pcm16(wav)
                offs[i] = pos
                lens[i] = len(pcm)
                parts.append(pcm)
                pos += len(pcm)
            return offs, lens, parts, pos

        offsets, lengths, parts, pos = pack_tree(dataset._load)
        zs_ids = None
        if self.zero_speech_p > 0:
            zs_rng = np.random.RandomState(seed + 911)
            zs_ids = np.arange(n, n + zero_speech_bank)
            for _ in range(zero_speech_bank):
                pcm = _to_pcm16(zerospeech(max(int(5 * 16e3), chunk_size),
                                           zs_rng))
                offsets = np.append(offsets, pos)
                lengths = np.append(lengths, len(pcm))
                parts.append(pcm)
                pos += len(pcm)
        self.offsets, self.lengths = offsets, lengths
        self.buf = torch.from_numpy(np.concatenate(parts)).to(self.device)
        parts.clear()
        self.nbytes = self.buf.numel() * self.buf.element_size()
        if self.parallel:
            self.coffsets, self.clengths, cparts, _ = pack_tree(
                dataset._load_clean, "clean::")
            self.cbuf = torch.from_numpy(np.concatenate(cparts)).to(
                self.device)
            self.nbytes += self.cbuf.numel() * self.cbuf.element_size()
            self._coffs = torch.from_numpy(self.coffsets).to(self.device)
            self._clens = torch.from_numpy(self.clengths).to(self.device)

        # padded neighbor table: nb[i, j < cnt[i]] are i's neighbors; the
        # zero-speech rows are their own neighbor
        n_tot = len(offsets)
        max_nb = max(len(nb) for nb in self.neighbors) if n else 1
        nb_pad = np.zeros((n_tot, max_nb), dtype=np.int64)
        nb_cnt = np.ones(n_tot, dtype=np.int64)
        for i, nb in enumerate(self.neighbors):
            nb_pad[i, :len(nb)] = nb
            nb_cnt[i] = len(nb)
        for i in range(n, n_tot):
            nb_pad[i, 0] = i
        self.nb_table, self.nb_count = nb_pad, nb_cnt
        self._offs = torch.from_numpy(offsets).to(self.device)
        self._lens = torch.from_numpy(lengths).to(self.device)
        self._nb = torch.from_numpy(nb_pad).to(self.device)
        self._cnt = torch.from_numpy(nb_cnt).to(self.device)
        self._zs = (None if zs_ids is None
                    else torch.from_numpy(zs_ids).to(self.device))
        self.generator = torch.Generator(device=self.device)
        self._arange = torch.arange(chunk_size, device=self.device)

    def _randint(self, high, shape):
        return torch.randint(0, high, shape, generator=self.generator,
                             device=self.device)

    def _other(self, idx):
        """A uniform utterance other than each of idx."""
        if self.n_utts < 2:
            return torch.zeros_like(idx)
        r = self._randint(self.n_utts - 1, idx.shape)
        return torch.where(r >= idx, r + 1, r)

    def _start_in(self, offs, lens):
        """offs + a uniform start in [0, max(lens - T, 0)]."""
        span = torch.clamp(lens - self.chunk_size, min=0)
        r = self._randint(_DRAW_HIGH, span.shape)
        return offs + r % (span + 1)

    def sample_starts(self, step):
        """[3, B] absolute starts in ``buf`` (anchor, context, random) of
        batch ``step``; for a parallel corpus [4, B]: the noisy anchor in
        ``buf``, the clean anchor and the clean context in ``cbuf``, the
        noisy random row in ``buf``."""
        self.generator.manual_seed(step_seed(self.seed, step))
        b, t = self.batch_size, self.chunk_size
        idx = self._randint(self.n_utts, (b,))
        if self.parallel:
            lens, clens = self._lens[idx], self._clens[idx]
            span = torch.clamp(torch.minimum(lens, clens) - t, min=0)
            rel = self._randint(_DRAW_HIGH, (b,)) % (span + 1)
            cstart = self._start_in(self._coffs[idx], clens)
            rand = self._other(idx)
            return torch.stack([
                self._offs[idx] + rel, self._coffs[idx] + rel, cstart,
                self._start_in(self._offs[rand], self._lens[rand])])
        if self._zs is not None:
            pick = torch.rand((b,), generator=self.generator,
                              device=self.device) < self.zero_speech_p
            zs = self._zs[self._randint(len(self._zs), (b,))]
            idx = torch.where(pick, zs, idx)
        j = self._randint(_DRAW_HIGH, (b,)) % self._cnt[idx]
        ids = torch.stack([idx, self._nb[idx, j], self._other(idx)])
        return self._start_in(self._offs[ids], self._lens[ids])

    def _rows(self, buf, starts):
        pcm = buf[starts[:, None] + self._arange]
        return pcm.float() / 32768.0

    def make_batch(self, step):
        """Batch ``step``: the same step gives the same batch."""
        st = self.sample_starts(step)
        if self.parallel:
            return {"chunk": self._rows(self.buf, st[0]),
                    "cchunk": self._rows(self.cbuf, st[1]),
                    "chunk_ctxt": self._rows(self.cbuf, st[2]),
                    "chunk_rand": self._rows(self.buf, st[3])}
        rows = self._rows(self.buf, st.reshape(-1)).view(
            3, self.batch_size, self.chunk_size)
        return {"chunk": rows[0], "chunk_ctxt": rows[1],
                "chunk_rand": rows[2]}

    def batches(self, step=0):
        """Batches ``step``, ``step + 1``, ...: ``batches(k)`` is the tail
        of ``batches(0)`` from batch k on."""
        while True:
            yield self.make_batch(step)
            step += 1

    def __iter__(self):
        return self.batches(0)
