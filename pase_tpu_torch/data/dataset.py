"""Host corpora, chunk batchers and synthetic raw-chunk sources.

Corpora on disk (numpy, each an exact copy of its class in
``pase_tpu.data.dataset``: the same corpus and seed give the same arrays
bit for bit):

* ``LibriSpeechTupleDataset`` samples (current, neighbor, random) wav
  tuples: the neighbor is another file of the same filename prefix
  (``{spk}-{chap}-``), the random one another utterance; with
  ``zero_speech_p`` a draw is replaced by near-silence (``zerospeech``).
  ``PairWavDataset`` has no neighbor context, ``GenhancementDataset``
  reads a parallel clean tree, ``AmiSegTupleWavDataset`` AMI's far-field
  segments against their headset ones (a parallel tree, or per-channel
  cfg keys), ``MetaConcatDataset`` concatenates corpora with per-corpus
  distortion flags.
* ``ChunkBatcher`` crops [B, T] float32 {chunk, chunk_ctxt, chunk_rand}
  batches (``crop_chunk``: reflect-tail or tile padding of short
  utterances) in a background thread, with 'cchunk' (the aligned clean
  crop of a parallel corpus), 'dist_mask' and 'zs_mask' where the corpus
  has them. ``FastChunkBatcher`` decodes and crops in the native C++
  library (``data/io.py``) where it can. ``ThreadedPrefetcher`` fans
  batch production out over N threads into one bounded queue.
* ``FeatsClassDataset`` / ``WavClassDataset`` give (features or wav,
  class id) items of a split list for the downstream probes.

Every background thread is a daemon, re-checks a stop event on its
bounded ``put``s, and hands a producer error to the consumer.

Synthetic sources mirror the MI-tuple structure of real data: 'chunk'
and 'chunk_ctxt' come from the same synthetic 'speaker' (shared f0 and
spectral tilt, different phases, envelope and noise), 'chunk_rand' from
another, so the LIM / GIM contrastive tasks are learnable.

* ``SyntheticChunkBatcher`` — numpy, an exact copy of
  ``pase_tpu.data.dataset.SyntheticChunkBatcher``: the same seed gives the
  same arrays.
* ``DeviceSyntheticBatcher`` — the same signal family drawn on the device
  with a ``torch.Generator``; it keeps the synthetic training loop off
  the host. Its random streams are not the JAX package's.

``step_seed(seed, step)`` is the seed of one step's stream: the device
batchers' batch k and the trainer's distortion draws of step k come from
generators seeded with it, so a run resumed at step k replays the
uninterrupted run's batches and draws without any generator state.
"""

import math
import os
import queue as queue_mod
import re
import threading

import numpy as np
import torch

from pase_tpu_torch.data.io import load_data_cfg, read_wav


def step_seed(seed, step):
    """The seed of step ``step``'s stream of a run seeded with ``seed``."""
    return ((int(seed) & 0x7FFFFFFF) << 32) | (int(step) & 0xFFFFFFFF)


def zerospeech(n_samples, rng):
    """A near-silent synthetic utterance: N(0, 1e-10) samples."""
    return (rng.randn(n_samples) * 1e-5).astype(np.float32)


class LibriSpeechTupleDataset:
    """Samples (raw, raw_ctxt, raw_rand) wav tuples of one split of a
    data cfg: the context from a neighbor (a file of the same name prefix,
    the trailing ``<digits>.wav`` removed), the random one from another
    utterance. Wavs are read on first use and kept (``cache_on_load``);
    ``preload_wav`` reads them all at construction."""

    def __init__(self, data_root, data_cfg_file, split, preload_wav=False,
                 cache_on_load=True, zero_speech_p=0.0, seed=0):
        self.data_root = data_root
        self.split = split
        self.zero_speech_p = zero_speech_p
        cfg = load_data_cfg(data_cfg_file)
        self.wavs = cfg[split]["data"]
        self.total_wav_dur = int(cfg[split]["total_wav_dur"])
        self.spk_info = cfg.get("speakers", [])
        self.rng = np.random.RandomState(seed)
        self.cache_on_load = cache_on_load
        self.wav_cache = {}
        self.rec = re.compile(r"(\d+).wav")
        self.neighbor_prefixes = {}
        for wav in self.wavs:
            fname = wav["filename"]
            prefix = self.rec.sub("", fname)
            self.neighbor_prefixes.setdefault(prefix, []).append(fname)
        if preload_wav and cache_on_load:
            for wav in self.wavs:
                self._load(wav["filename"])

    def __len__(self):
        return len(self.wavs)

    def _load(self, fname):
        if fname in self.wav_cache:
            return self.wav_cache[fname]
        wav, _ = read_wav(os.path.join(self.data_root, fname))
        if self.cache_on_load:
            self.wav_cache[fname] = wav
        return wav

    def sample_tuple(self, index, rng=None, info=None):
        """(wav, context wav, random wav) of utterance ``index``.

        rng: a caller-owned RandomState; threaded batchers pass their own
        (``self.rng`` is a single-consumer fallback). info: an optional
        dict this sets {'zs': True} in when the draw was a zero-speech
        injection (the batcher's zs_mask)."""
        rng = self.rng if rng is None else rng
        if rng.rand() < self.zero_speech_p:
            if info is not None:
                info["zs"] = True
            wav = zerospeech(int(5 * 16e3), rng)
            cwav = wav
        else:
            uttname = self.wavs[index]["filename"]
            wav = self._load(uttname)
            prefix = self.rec.sub("", uttname)
            neighbors = [n for n in self.neighbor_prefixes[prefix]
                         if n != uttname]
            cwav = self._load(rng.choice(neighbors)) if neighbors else wav
        rindex = rng.randint(len(self.wavs) - 1)
        if rindex >= index:
            rindex += 1
        rwav = self._load(self.wavs[rindex]["filename"])
        return wav, cwav, rwav


def crop_at(wav, beg, chunk_size):
    """The chunk at a fixed offset (clamped to fit); an utterance no longer
    than the chunk is padded: reflect tail when the pad is shorter than
    the utterance, else tiled."""
    if len(wav) <= chunk_size:
        p = chunk_size - len(wav)
        if len(wav) == 0:
            return np.zeros(chunk_size, dtype=np.float32)
        if p == 0:
            return wav.astype(np.float32)
        if p < len(wav):
            return np.concatenate([wav, wav[-2:-2 - p:-1]]).astype(np.float32)
        reps = int(np.ceil(chunk_size / len(wav)))
        return np.tile(wav, reps)[:chunk_size].astype(np.float32)
    beg = min(beg, len(wav) - chunk_size)
    return wav[beg:beg + chunk_size]


def crop_chunk(wav, chunk_size, rng):
    """A random chunk of a longer utterance; a short one padded from 0
    (``crop_at``)."""
    if len(wav) > chunk_size:
        return crop_at(wav, rng.randint(0, len(wav) - chunk_size),
                       chunk_size)
    return crop_at(wav, 0, chunk_size)


def _bounded_put(q, item, stop):
    """Put ``item`` on ``q``, giving up once ``stop`` is set: a producer
    blocked on a full queue exits when its consumer goes away."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.25)
            return
        except queue_mod.Full:
            continue


class _ProducerError:
    """A producer's exception, queued for the consumer to raise."""

    def __init__(self, error):
        self.error = error


class ChunkBatcher:
    """Iterates [B, T] float32 batches of chunk triplets cropped from a
    tuple dataset, made one step ahead in a background thread. ``bpe`` is
    the reference's epoch: total_wav_dur // chunk_size // batch_size."""

    def __init__(self, dataset, batch_size, chunk_size, seed=0, prefetch=4):
        self.ds = dataset
        self.batch_size = batch_size
        self.chunk_size = chunk_size
        self.rng = np.random.RandomState(seed + 77)
        self.prefetch = prefetch
        self.bpe = max((dataset.total_wav_dur // chunk_size) // batch_size, 1)

    def _make_batch(self):
        b, t = self.batch_size, self.chunk_size
        ds = self.ds
        chunk = np.empty((b, t), dtype=np.float32)
        ctxt = np.empty((b, t), dtype=np.float32)
        rand = np.empty((b, t), dtype=np.float32)
        masked = getattr(ds, "dist_flags", None) is not None
        mask = np.ones((b,), dtype=np.float32) if masked else None
        subsets = getattr(ds, "datasets", None)
        # zero-speech rows carry a zs_mask: the prepare skips the
        # distortion stack on them and applies the zero-speech additive
        zs_on = any(getattr(d, "zero_speech_p", 0.0) > 0
                    for d in (subsets or [ds]))
        zs_mask = np.zeros((b,), dtype=np.float32) if zs_on else None
        any_parallel = (any(getattr(d, "parallel", False)
                            for d in subsets) if subsets
                        else getattr(ds, "parallel", False))
        cchunk = np.empty((b, t), dtype=np.float32) if any_parallel \
            else None
        for i in range(b):
            idx = self.rng.randint(len(ds))
            sub = ds.datasets[ds._locate(idx)[0]] if subsets else ds
            # info only when zero-speech is on: dataset stand-ins without
            # the info argument keep working
            if zs_on:
                info = {}
                tup = ds.sample_tuple(idx, self.rng, info)
                if info.get("zs"):
                    zs_mask[i] = 1.0
            else:
                tup = ds.sample_tuple(idx, self.rng)
            wav, cwav, rwav = tup[:3]
            # an optional 4th element is a dedicated context source
            ctxt_src = tup[3] if len(tup) > 3 else cwav
            if getattr(sub, "parallel", False):
                # parallel clean/noisy: one shared window for chunk and
                # cchunk; the context is an independent crop
                beg = (self.rng.randint(0, len(wav) - t)
                       if len(wav) > t else 0)
                chunk[i] = crop_at(wav, beg, t)
                cchunk[i] = crop_at(cwav, beg, t)
                ctxt[i] = crop_chunk(ctxt_src, t, self.rng)
            else:
                chunk[i] = crop_chunk(wav, t, self.rng)
                ctxt[i] = crop_chunk(ctxt_src, t, self.rng)
                if cchunk is not None:
                    cchunk[i] = chunk[i]
            rand[i] = crop_chunk(rwav, t, self.rng)
            if masked:
                mask[i] = ds.dist_mask_of(idx)
        out = {"chunk": chunk, "chunk_ctxt": ctxt, "chunk_rand": rand}
        if cchunk is not None:
            out["cchunk"] = cchunk
        if masked:
            out["dist_mask"] = mask
        if zs_mask is not None:
            out["zs_mask"] = zs_mask
        return out

    def __iter__(self):
        q = queue_mod.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    batch = self._make_batch()
                except BaseException as e:   # noqa: BLE001
                    # handed to the consumer: a producer that died
                    # silently would block its q.get() forever
                    batch = _ProducerError(e)
                _bounded_put(q, batch, stop)
                if isinstance(batch, _ProducerError):
                    return

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, _ProducerError):
                    raise item.error
                yield item
        finally:
            stop.set()


class ThreadedPrefetcher:
    """Batch production fanned out over N threads into one bounded queue
    (the reference DataLoader's num_workers). ``make_iter(tid)`` returns an
    independent batch iterator per thread, with its own seed. Batch order
    across threads is nondeterministic; each thread's stream is
    deterministic. A finite per-thread iterator ends the stream when it
    is drained."""

    def __init__(self, make_iter, n_threads=4, prefetch=8, bpe=None):
        self.make_iter = make_iter
        self.n_threads = max(1, int(n_threads))
        self.prefetch = prefetch
        if bpe is not None:
            self.bpe = bpe

    def __iter__(self):
        q = queue_mod.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker(tid):
            try:
                it = iter(self.make_iter(tid))
            except BaseException as e:   # noqa: BLE001
                _bounded_put(q, _ProducerError(e), stop)
                return
            while not stop.is_set():
                try:
                    batch = next(it)
                except BaseException as e:   # noqa: BLE001
                    batch = _ProducerError(e)
                _bounded_put(q, batch, stop)
                if isinstance(batch, _ProducerError):
                    return

        threads = [threading.Thread(target=worker, args=(tid,), daemon=True)
                   for tid in range(self.n_threads)]
        for th in threads:
            th.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, _ProducerError):
                    if isinstance(item.error, StopIteration):
                        return
                    raise item.error
                yield item
        finally:
            stop.set()


class PairWavDataset(LibriSpeechTupleDataset):
    """(current, random) pairs: no neighbor context, the context chunk is
    cropped from the current wav."""

    def sample_tuple(self, index, rng=None, info=None):
        wav, _, rwav = super().sample_tuple(index, rng, info)
        return wav, wav, rwav


class GenhancementDataset(LibriSpeechTupleDataset):
    """Parallel noisy / clean trees: 'chunk' from the noisy tree
    (data_root), 'cchunk' from the clean tree (clean_root, the same
    relative path) at the same window, so the worker targets come from
    clean audio (the denoising setup). ``parallel`` tells the batcher to
    crop both at one offset."""

    parallel = True

    def __init__(self, data_root, clean_root, data_cfg_file, split,
                 **kwargs):
        super().__init__(data_root, data_cfg_file, split, **kwargs)
        self.clean_root = clean_root

    def _load_clean(self, fname):
        key = "clean::" + fname
        if key in self.wav_cache:
            return self.wav_cache[key]
        wav, _ = read_wav(os.path.join(self.clean_root, fname))
        if self.cache_on_load:
            self.wav_cache[key] = wav
        return wav

    def sample_tuple(self, index, rng=None, info=None):
        rng = self.rng if rng is None else rng
        uttname = self.wavs[index]["filename"]
        noisy = self._load(uttname)
        clean = self._load_clean(uttname)
        rindex = rng.randint(len(self.wavs) - 1)
        if rindex >= index:
            rindex += 1
        rwav = self._load(self.wavs[rindex]["filename"])
        return noisy, clean, rwav


def _load_utt2class(utt2class):
    """utt2class map from a .json file or a pickled / .npy dict."""
    if utt2class.endswith(".json"):
        import json
        with open(utt2class) as f:
            return json.load(f)
    arr = np.load(utt2class, allow_pickle=True)
    return dict(arr.item() if hasattr(arr, "item") and arr.ndim == 0
                else arr.any())


def _load_split_list(split_list):
    """A list as it is, or the non-blank lines of a file."""
    if isinstance(split_list, list):
        return list(split_list)
    with open(split_list) as f:
        return [ln.rstrip() for ln in f if ln.strip()]


class FeatsClassDataset:
    """Precomputed features -> class id, for downstream probes: one
    ``<name>.<ext>`` .npy file [T, D] per utterance of the split list, the
    utt2class map, optional ZNorm from a stats pickle ({mean, std})."""

    def __init__(self, data_root, utt2class, split_list, stats=None,
                 ext="fb.npy"):
        self.data_root = data_root
        self.ext = ext
        self.utt2class = _load_utt2class(utt2class)
        self.split_list = _load_split_list(split_list)
        self.stats = None
        if stats is not None:
            import pickle
            with open(stats, "rb") as f:
                st = pickle.load(f)
            self.stats = {"mean": np.asarray(st["mean"], np.float32),
                          "std": np.asarray(st["std"], np.float32)}

    def __len__(self):
        return len(self.split_list)

    def __getitem__(self, index):
        item = self.split_list[index]
        bname = os.path.splitext(item)[0]
        ft = np.asarray(np.load(os.path.join(self.data_root,
                                             bname + "." + self.ext)),
                        np.float32)
        if self.stats is not None:
            ft = (ft - self.stats["mean"]) / self.stats["std"]
        return ft, int(self.utt2class[item])


class WavClassDataset:
    """Wav -> class id: the split list's ``<name>.wav`` under data_root,
    the utt2class map; with ``chunk_size``, zero-padded to chunk_size + 1
    samples, then a random ``crop_chunk`` (numpy RandomState(seed))."""

    def __init__(self, data_root, utt2class, split_list, chunk_size=None,
                 seed=0):
        self.data_root = data_root
        self.utt2class = _load_utt2class(utt2class)
        self.split_list = _load_split_list(split_list)
        self.chunk_size = chunk_size
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.split_list)

    def __getitem__(self, index):
        item = self.split_list[index]
        bname = os.path.splitext(item)[0]
        wav, _ = read_wav(os.path.join(self.data_root, bname + ".wav"))
        wav = np.asarray(wav, np.float32)
        if self.chunk_size is not None:
            if len(wav) < self.chunk_size + 1:
                wav = np.concatenate(
                    [wav, np.zeros(self.chunk_size + 1 - len(wav),
                                   np.float32)])
            wav = crop_chunk(wav, self.chunk_size, self.rng)
        return wav, int(self.utt2class[item])


class AmiSegTupleWavDataset(GenhancementDataset):
    """AMI's far-field (sdm) segments trained against their headset (ihm)
    ones, in one of two layouts:

    * tree mode (``ihm2sdm`` None): 'chunk' from the sdm tree
      (data_root), the clean 'cchunk' from the ihm tree (clean_root) at
      the same relative path and window: ``GenhancementDataset``'s tuple;
    * channel-key mode (``ihm2sdm="1,3,5,7"``): the cfg entries (the
      ``data_prep ami-cfg`` output) carry the distant-mic segments under
      per-channel keys beside the headset 'filename'. Entries that lack a
      requested channel are dropped (with a message). Each sample draws
      one distant channel, shared by chunk, context and rand; 'cchunk' is
      the headset segment; the context is a same-prefix neighbour in that
      channel, or the sample's own segment there when the prefix has no
      other. The neighbours are drawn without removing them from the
      prefix's pool (the reference's ``neighbors.remove`` shrinks the
      pool at each visit; the JAX package samples as here).

    The tuples, and the draws of ``rng`` that make them, are the JAX
    class's."""

    def __init__(self, data_root, clean_root, data_cfg_file, split,
                 ihm2sdm=None, **kwargs):
        super().__init__(data_root, clean_root or data_root, data_cfg_file,
                         split, **kwargs)
        self.ihm2sdm = ([c for c in ihm2sdm.split(",") if c]
                        if ihm2sdm else None)
        if self.ihm2sdm:
            kept = [w for w in self.wavs
                    if all(c in w for c in self.ihm2sdm)]
            n_lost = len(self.wavs) - len(kept)
            if n_lost:
                print(f"AmiSegTupleWavDataset: dropped {n_lost} segments "
                      f"missing sdm channels {self.ihm2sdm}")
            self.wavs = kept
            # prefix -> cfg entries, so a neighbour reads in any channel
            self.neighbor_entries = {}
            for wav in self.wavs:
                prefix = self.rec.sub("", wav["filename"])
                self.neighbor_entries.setdefault(prefix, []).append(wav)

    def sample_tuple(self, index, rng=None, info=None):
        if not self.ihm2sdm:
            return super().sample_tuple(index, rng, info)
        rng = self.rng if rng is None else rng
        entry = self.wavs[index]
        chan = self.ihm2sdm[rng.randint(len(self.ihm2sdm))]
        noisy = self._load(entry[chan])
        clean = self._load_clean(entry["filename"])
        prefix = self.rec.sub("", entry["filename"])
        neighbors = [e for e in self.neighbor_entries[prefix]
                     if e["filename"] != entry["filename"]]
        ctxt = (self._load(neighbors[rng.randint(len(neighbors))][chan])
                if neighbors else noisy)
        rindex = rng.randint(len(self.wavs) - 1)
        if rindex >= index:
            rindex += 1
        rwav = self._load(self.wavs[rindex][chan])
        return noisy, clean, rwav, ctxt


class MetaConcatDataset:
    """Several tuple datasets as one. ``dist_flags``: an optional bool per
    dataset; the batcher emits a per-row ``dist_mask`` from them and the
    prepare leaves the rows of a False corpus undistorted."""

    def __init__(self, datasets, dist_flags=None):
        self.datasets = list(datasets)
        self.total_wav_dur = sum(d.total_wav_dur for d in self.datasets)
        self._offsets = []
        off = 0
        for d in self.datasets:
            self._offsets.append(off)
            off += len(d)
        self._len = off
        self.rec = self.datasets[0].rec
        self.wavs = [w for d in self.datasets for w in d.wavs]
        self.dist_flags = (list(dist_flags) if dist_flags is not None
                           else None)

    def __len__(self):
        return self._len

    def _locate(self, index):
        for i in range(len(self.datasets) - 1, -1, -1):
            if index >= self._offsets[i]:
                return i, index - self._offsets[i]
        return 0, index

    def sample_tuple(self, index, rng=None, info=None):
        i, sub = self._locate(index)
        return self.datasets[i].sample_tuple(sub, rng, info)

    def dist_mask_of(self, index):
        if self.dist_flags is None:
            return 1.0
        return 1.0 if self.dist_flags[self._locate(index)[0]] else 0.0


class FastChunkBatcher(ChunkBatcher):
    """A ChunkBatcher whose decode and random crops run in the native C++
    library's threads; Python samples only the utterance tuple. Corpora
    that need per-row masks, shared-offset crops or zero-speech draws,
    and hosts without the library, take the Python path. The library
    seeds one generator per decoder thread and its threads take files in
    the order they get to them, so its crops repeat from the seed only
    with one thread (``native_load_chunk_batch(..., n_threads=1)``)."""

    def _make_batch(self):
        from pase_tpu_torch.data.io import native_load_chunk_batch
        b, t = self.batch_size, self.chunk_size
        ds = self.ds
        if getattr(ds, "datasets", None) is not None or \
                getattr(ds, "parallel", False) or \
                getattr(ds, "zero_speech_p", 0.0) > 0:
            return super()._make_batch()
        paths = []
        for _ in range(b):
            idx = self.rng.randint(len(ds))
            utt = ds.wavs[idx]["filename"]
            prefix = ds.rec.sub("", utt)
            neighbors = [n for n in ds.neighbor_prefixes[prefix] if n != utt]
            ctxt = self.rng.choice(neighbors) if neighbors else utt
            ridx = self.rng.randint(len(ds.wavs) - 1)
            if ridx >= idx:
                ridx += 1
            rand = ds.wavs[ridx]["filename"]
            paths += [os.path.join(ds.data_root, p)
                      for p in (utt, ctxt, rand)]
        out = native_load_chunk_batch(paths, t,
                                      seed=int(self.rng.randint(2 ** 31)))
        if out is None:
            return super()._make_batch()
        out = out.reshape(b, 3, t)
        return {"chunk": out[:, 0], "chunk_ctxt": out[:, 1],
                "chunk_rand": out[:, 2]}


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
    """Synthetic batches made on ``device`` from a ``torch.Generator``:
    harmonic stacks of 5 partials at f0 ~ U[80, 260) Hz with 1/k^tilt
    amplitudes (tilt ~ U[0.7, 1.5)), a slow sine envelope (U[1, 4) Hz),
    times 0.2, plus N(0, 0.05^2) noise. Batch k of ``batches(step)`` is
    drawn from ``step_seed(seed, k)``, so ``batches(k0)`` is the tail of
    ``batches(0)`` from batch k0 on (a resumed run's feed);
    ``make_batch()`` without a step continues the generator's stream."""

    def __init__(self, batch_size, chunk_size, seed=0, device="cuda"):
        self.batch_size = batch_size
        self.chunk_size = chunk_size
        self.seed = seed
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

    def make_batch(self, step=None):
        if step is not None:
            self.generator.manual_seed(step_seed(self.seed, step))
        b = self.batch_size
        f0 = self._uniform(80.0, 260.0, (b, 1))
        tilt = self._uniform(0.7, 1.5, (b, 1))
        f0r = self._uniform(80.0, 260.0, (b, 1))
        tiltr = self._uniform(0.7, 1.5, (b, 1))
        return {"chunk": self._speechlike(f0, tilt),
                "chunk_ctxt": self._speechlike(f0, tilt),
                "chunk_rand": self._speechlike(f0r, tiltr)}

    def batches(self, step=0):
        while True:
            yield self.make_batch(step)
            step += 1

    def __iter__(self):
        return self.batches(0)
