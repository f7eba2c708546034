"""The port's disk data layer (pase_tpu_torch.data: io, dataset, pipeline,
cache and the statistics CLI) against the JAX package on the same seeded
wav corpus, on the CPU.

Bounds: the numpy batchers equal JAX's bit for bit (the same corpus and
seed give the same arrays). ``make_prepare_fn`` on a batch with
dist_mask, zs_mask, cchunk, int16 waveforms and cached targets, given the
JAX prepare's own draws: every output within 1e-5 of its largest value,
the overlap label exactly. The computed targets there are fbank, mfcc and
prosody, which the two packages agree on within 2.3e-6 of their largest
value; lps (3e-5, a log of near-zero STFT bins) is held to 1e-4 by
tests/test_torch_features.py and enters here as a cached target. The
feature cache: the port's files within 1e-5 of JAX's per array, and the
batches of either package's ``CachedTargetBatcher`` identical on either
package's cache. The statistics CLI: its pickle within 1e-5 of the root
script's per array. Every wait on a background thread has a time limit.
"""

import functools
import gc
import json
import os
import pickle
import runpy
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pase_tpu.data import cache as jax_cache
from pase_tpu.data import dataset as JD
from pase_tpu.data import io as jax_io
from pase_tpu.data import pipeline as jax_pipeline
from pase_tpu.data.distortions import (DistortionAssets as JaxAssets,
                                       DistortionConfig as JaxConfig)
from pase_tpu.model import parse_workers_cfg as jax_parse_workers
from pase_tpu_torch.data import cache
from pase_tpu_torch.data import dataset as D
from pase_tpu_torch.data import distortions as PD
from pase_tpu_torch.data import io as port_io
from pase_tpu_torch.data import pipeline
from pase_tpu_torch.data.synthetic_corpus import write_synthetic_corpus
from pase_tpu_torch.model import parse_workers_cfg
from test_torch_distortions import jax_draws
from torch_port_common import rel_err
from torch_port_common import port_test_guard  # noqa: F401

CHUNK = 4000
REL = 1e-5
WAIT_S = 60.0
# the targets the two packages compute within 2.3e-6 of their largest value
CLOSE_TARGETS = ("fbank", "mfcc", "prosody")


def write_corpus(root, train_seconds=3.0, valid_seconds=1.0, seed=0):
    """A synthetic corpus of 0.1-0.6 s utterances (some shorter than
    CHUNK), a parallel clean tree of the same names, and a noise
    directory; a namespace of their paths."""
    wav_root, cfg = write_synthetic_corpus(
        root, train_seconds, valid_seconds, seed=seed, utts_per_chapter=3,
        min_seconds=0.1, max_seconds=0.6)
    rng = np.random.RandomState(seed + 1)
    clean = os.path.join(root, "clean")
    noise = os.path.join(root, "noise")
    os.makedirs(clean)
    os.makedirs(noise)
    for name in sorted(os.listdir(wav_root)):
        w, _ = port_io.read_wav(os.path.join(wav_root, name))
        port_io.write_wav(os.path.join(clean, name),
                          0.5 * w + 0.01 * rng.randn(len(w)))
    for i in range(2):
        port_io.write_wav(os.path.join(noise, f"n{i}.wav"),
                          0.1 * rng.randn(12000))
    return SimpleNamespace(root=wav_root, cfg=cfg, clean=clean, noise=noise)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("corpus")))


def _dataset(pkg, corpus, case, seed=3):
    """The tuple dataset of one batcher case in package ``pkg``."""
    c = corpus
    if case == "pair":
        return pkg.PairWavDataset(c.root, c.cfg, "train", seed=seed)
    if case == "genhancement":
        return pkg.GenhancementDataset(c.root, c.clean, c.cfg, "train",
                                       seed=seed)
    if case == "metaconcat":
        return pkg.MetaConcatDataset(
            [pkg.LibriSpeechTupleDataset(c.root, c.cfg, "train", seed=seed),
             pkg.GenhancementDataset(c.root, c.clean, c.cfg, "valid",
                                     seed=seed + 1)],
            dist_flags=[True, False])
    zs = 0.5 if case == "zero_speech" else 0.0
    return pkg.LibriSpeechTupleDataset(c.root, c.cfg, "train", seed=seed,
                                       zero_speech_p=zs)


def _reset_native():
    """Build native/libpase_wavio.so where a toolchain allows, then make
    both packages look for it again."""
    import subprocess
    if not os.path.exists(port_io.NATIVE_LIB):
        subprocess.run(["make", "-C", os.path.dirname(port_io.NATIVE_LIB)],
                       capture_output=True)
    jax_io._NATIVE = None
    port_io._native_lib.cache_clear()


def take(iterable, n=None, timeout=WAIT_S):
    """The first n items of ``iterable`` (all of them with n None), read in
    a thread that must end within ``timeout`` s; the iterator is closed
    after."""
    it = iter(iterable)
    out, err = [], []

    def run():
        try:
            while n is None or len(out) < n:
                out.append(next(it))
        except StopIteration:
            pass
        except BaseException as e:   # noqa: BLE001
            err.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), f"no {n} items within {timeout} s"
    it.close()
    if err:
        raise err[0]
    return out


def _assert_same(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def test_wav_io_matches_jax(corpus):
    names = sorted(os.listdir(corpus.root))[:4]
    for name in names:
        path = os.path.join(corpus.root, name)
        got, sr = port_io.read_wav(path)
        want, want_sr = jax_io.read_wav(path)
        assert sr == want_sr == 16000
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(port_io.read_wav_channels(path)[0],
                                      jax_io.read_wav_channels(path)[0])
        assert port_io.wav_len(path) == jax_io.wav_len(path) == len(want)
    assert port_io.load_data_cfg(corpus.cfg) == jax_io.load_data_cfg(
        corpus.cfg)


@pytest.mark.parametrize("case", ["tuple", "fast", "pair", "genhancement",
                                  "metaconcat", "zero_speech"])
def test_batchers_equal_jax_bit_for_bit(corpus, case, monkeypatch):
    """Three batches of _make_batch, then two through the prefetch
    thread, equal the JAX batcher's on the same corpus and seed. The
    native loader seeds one generator per decoder thread and its threads
    take files in whatever order they get to them, so its crops repeat
    only with one thread: both packages' loaders run with one here."""
    if case == "fast":
        _reset_native()
        assert (jax_io._native_lib() is None) == (
            port_io._native_lib() is None)
        for mod in (jax_io, port_io):
            monkeypatch.setattr(mod, "native_load_chunk_batch",
                                functools.partial(
                                    mod.native_load_chunk_batch,
                                    n_threads=1))
    cls = "FastChunkBatcher" if case == "fast" else "ChunkBatcher"
    want = getattr(JD, cls)(_dataset(JD, corpus, case), 3, CHUNK, seed=5)
    got = getattr(D, cls)(_dataset(D, corpus, case), 3, CHUNK, seed=5)
    assert got.bpe == want.bpe
    batches = [(got._make_batch(), want._make_batch()) for _ in range(3)]
    batches += zip(take(got, 2), take(want, 2))
    for i, (g, w) in enumerate(batches):
        _assert_same(g, w, f"{case} batch {i}")
    keys = {"chunk", "chunk_ctxt", "chunk_rand"} | {
        "genhancement": {"cchunk"}, "metaconcat": {"cchunk", "dist_mask"},
        "zero_speech": {"zs_mask"}}.get(case, set())
    assert set(batches[0][0]) == keys
    if case == "zero_speech":
        assert 0 < sum(g["zs_mask"].sum() for g, _ in batches) < 15
    if case == "metaconcat":
        assert 0 < sum(g["dist_mask"].sum() for g, _ in batches) < 15


def test_crops_match_jax():
    rng = np.random.RandomState(0)
    for n in (0, 1, 700, 1000, 1500, 2500, 4000):
        wav = rng.randn(n).astype(np.float32)
        for beg in (0, 3, 900):
            np.testing.assert_array_equal(D.crop_at(wav, beg, 1000),
                                          JD.crop_at(wav, beg, 1000))
        a, b = np.random.RandomState(n), np.random.RandomState(n)
        np.testing.assert_array_equal(D.crop_chunk(wav, 1000, a),
                                      JD.crop_chunk(wav, 1000, b))
    np.testing.assert_array_equal(
        D.zerospeech(100, np.random.RandomState(2)),
        JD.zerospeech(100, np.random.RandomState(2)))


def _wait_threads(base, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline and threading.active_count() > base:
        time.sleep(0.05)
    return threading.active_count() - base


class _TinyDS:
    total_wav_dur = 16000 * 4

    def __init__(self, fail=False):
        self.fail = fail

    def __len__(self):
        return 4

    def sample_tuple(self, idx, rng=None):
        if self.fail:
            raise RuntimeError("boom")
        w = np.random.RandomState(idx).randn(3200).astype(np.float32)
        return w, w, w


def test_chunk_batcher_thread_stops_and_hands_over_errors():
    base = threading.active_count()
    for _ in range(3):
        it = iter(D.ChunkBatcher(_TinyDS(), 2, 1600, prefetch=1))
        assert take(it, 1)[0]["chunk"].shape == (2, 1600)
        del it
        gc.collect()
    assert _wait_threads(base) <= 0, "producer threads left running"
    with pytest.raises(RuntimeError, match="boom"):
        take(D.ChunkBatcher(_TinyDS(fail=True), 2, 1600, prefetch=1), 1)
    assert _wait_threads(base) <= 0


def test_threaded_prefetcher_content_cleanup_and_errors():
    """Every item comes from one thread's stream, in that stream's order;
    a drained stream ends the iteration; threads stop when the consumer
    does; a producer's error (from make_iter or from its iterator) is
    raised in the consumer."""
    base = threading.active_count()
    pf = D.ThreadedPrefetcher(
        lambda tid: iter([{"tid": tid, "i": i} for i in range(6)]),
        n_threads=3, prefetch=2, bpe=7)
    assert pf.bpe == 7
    got = take(pf, 4)
    for tid in range(3):
        seq = [d["i"] for d in got if d["tid"] == tid]
        assert seq == list(range(len(seq)))
    drained = take(D.ThreadedPrefetcher(lambda tid: iter([{"i": 0}]),
                                        n_threads=2))
    assert 1 <= len(drained) <= 2 and all(d == {"i": 0} for d in drained)

    for _ in range(3):
        it = iter(D.ThreadedPrefetcher(
            lambda tid: D.SyntheticChunkBatcher(2, 1600, seed=tid),
            n_threads=3, prefetch=2))
        b = take(it, 1)[0]
        assert b["chunk"].shape == (2, 1600) and b["chunk"].dtype == np.float32
        del it
        gc.collect()
    assert _wait_threads(base) <= 0, "producer threads left running"

    def failing(tid):
        yield {"tid": tid}
        raise ValueError("producer failed")

    with pytest.raises(ValueError, match="producer failed"):
        take(D.ThreadedPrefetcher(failing, n_threads=2), 10)

    def broken(tid):
        raise KeyError("no iterator")

    with pytest.raises(KeyError, match="no iterator"):
        take(D.ThreadedPrefetcher(broken, n_threads=2), 1)
    assert _wait_threads(base) <= 0


def test_threads_sharing_a_dataset_keep_their_streams(corpus):
    """16 producer threads (more than the cores) over one dataset and its
    shared wav cache, with a short switch interval: each thread's batches
    equal, in order, those of a batcher with its seed run alone."""
    ds = D.LibriSpeechTupleDataset(corpus.root, corpus.cfg, "train")

    def make_iter(tid):
        b = D.ChunkBatcher(ds, 2, CHUNK, seed=13 * tid)
        while True:
            yield dict(b._make_batch(), tid=tid)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = take(D.ThreadedPrefetcher(make_iter, n_threads=16,
                                        prefetch=4), 64)
    finally:
        sys.setswitchinterval(interval)
    alone = {}
    for item in got:
        tid = item.pop("tid")
        if tid not in alone:
            alone[tid] = D.ChunkBatcher(
                D.LibriSpeechTupleDataset(corpus.root, corpus.cfg, "train"),
                2, CHUNK, seed=13 * tid)
        _assert_same(item, alone[tid]._make_batch(), f"thread {tid}")
    assert len(alone) > 1


def _overlap_assets(t):
    rng = np.random.RandomState(0)
    ir = (rng.randn(2, 300) * np.exp(-np.arange(300) / 40.0) * 0.2).astype(
        np.float32)
    ir[:, 0] = 1.0
    return PD.DistortionAssets(
        ir_bank=torch.from_numpy(ir),
        ir_pmax=torch.zeros(2, dtype=torch.int32),
        noise_bank=torch.from_numpy(rng.randn(3, 2 * t).astype(np.float32)
                                    * 0.1),
        overlap_bank=torch.from_numpy(rng.randn(2, 2 * t).astype(np.float32)
                                      * 0.1))


def jax_zs_draws(key, b, t, bank, snrs):
    """The draws of the JAX prepare's zero-speech additive from its key
    (``split(key, b)``, then each sample's ``additive_one`` splits)."""
    r = jax.random
    n, nlen = bank.shape
    ks = r.split(key, b)
    highs = (n, max(nlen - t, 1), len(snrs))
    cols = [np.asarray(jax.vmap(lambda k, i=i, h=h: r.randint(
        r.split(k, 3)[i], (), 0, h))(ks)) for i, h in enumerate(highs)]
    return pipeline.ZeroSpeechDraws(*(torch.from_numpy(np.array(c)).long()
                                      for c in cols))


def test_prepare_with_masks_int16_and_cache_matches_jax(corpus):
    """A MetaConcat batch (dist_mask, cchunk) with zero-speech rows
    (zs_mask), lps cached, and all waveforms but 'chunk' as int16 ('chunk'
    stays float32: the int16 grid rounds zero-speech rows to silence, on
    which the zero-speech additive is the identity): each output within
    1e-5 of its largest value, given the JAX prepare's own draws."""
    t = CHUNK
    ds = D.MetaConcatDataset(
        [D.LibriSpeechTupleDataset(corpus.root, corpus.cfg, "train", seed=1,
                                   zero_speech_p=0.4),
         D.GenhancementDataset(corpus.root, corpus.clean, corpus.cfg,
                               "valid", seed=2)], dist_flags=[True, False])
    raw = D.ChunkBatcher(ds, 6, t, seed=4)._make_batch()
    assert 0 < raw["dist_mask"].sum() < 6 and 0 < raw["zs_mask"].sum() < 6
    for k in ("chunk_ctxt", "chunk_rand", "cchunk"):
        raw[k] = np.clip(raw[k] * 32768.0, -32768, 32767).astype(np.int16)
    rng = np.random.RandomState(8)
    raw["lps"] = rng.randn(6, t // 160, 1025).astype(np.float32)
    wk = {"regr": [{"name": n} for n in CLOSE_TARGETS + ("lps",)],
          "cls": [{"name": "overlap", "loss": "BCEWithLogitsLoss"}]}
    stats = {n: {"mean": rng.randn(d).astype(np.float32),
                 "std": rng.uniform(0.5, 2, d).astype(np.float32)}
             for n, d in (("fbank", 120), ("lps", 1025))}
    cfg = PD.DistortionConfig(reverb_p=0.5, overlap_p=0.7, noises_p=0.7,
                              clip_p=0.5)
    assets = _overlap_assets(t)
    zs_bank = torch.from_numpy(rng.randn(2, 2 * t).astype(np.float32) * 0.1)
    snrs = (0, 5, 10)
    key = jax.random.PRNGKey(3)
    want = jax.jit(jax_pipeline.make_prepare_fn(
        jax_parse_workers(wk), stats=stats,
        dist_cfg=JaxConfig(**cfg._asdict()),
        assets=JaxAssets(*(None if a is None else jnp.asarray(a.numpy())
                           for a in assets)),
        zs_bank=jnp.asarray(zs_bank.numpy()), zs_snrs=snrs))(
        {k: jnp.asarray(v) for k, v in raw.items()}, key)
    _, k_dist, k_zs = jax.random.split(key, 3)
    got = pipeline.make_prepare_fn(
        parse_workers_cfg(wk), stats=stats, dist_cfg=cfg, assets=assets,
        zs_bank=zs_bank, zs_snrs=snrs)(
        {k: torch.from_numpy(v) for k, v in raw.items()},
        draws=jax_draws(k_dist, 6, t, cfg, assets),
        zs_draws=jax_zs_draws(k_zs, 6, t, zs_bank, snrs))
    assert set(got) == set(want) == {
        "chunk", "chunk_ctxt", "chunk_rand", "cchunk", "overlap", "lps",
        *CLOSE_TARGETS}
    np.testing.assert_array_equal(got["cchunk"].numpy(),
                                  raw["cchunk"] / np.float32(32768))
    for k in sorted(want):
        if k == "overlap":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        else:
            assert rel_err(got[k].numpy(), np.asarray(want[k])) <= REL, k
    zs = raw["zs_mask"] > 0
    kept = (raw["dist_mask"] == 0) & ~zs
    np.testing.assert_array_equal(got["chunk"].numpy()[kept],
                                  raw["chunk"][kept])
    assert (got["overlap"].numpy()[kept | zs] == 0).all()
    # zero-speech rows: bank noise added, the input's energy kept
    noisy = got["chunk"].numpy()[zs]
    assert (np.abs(noisy - raw["chunk"][zs]).max(axis=1) > 0).all()
    np.testing.assert_allclose((noisy.astype(np.float64) ** 2).sum(1),
                               (raw["chunk"][zs].astype(np.float64) ** 2)
                               .sum(1), rtol=1e-4)
    np.testing.assert_allclose(
        got["lps"].numpy(),
        (raw["lps"] - stats["lps"]["mean"]) / stats["lps"]["std"],
        rtol=1e-6)


def test_prepare_random_scale_shares_the_gain_with_cchunk():
    rng = np.random.RandomState(0)
    chunk = torch.from_numpy(rng.randn(3, 1600).astype(np.float32))
    clean = chunk * 0.5 + 0.1
    raw = {"chunk": chunk, "chunk_ctxt": -chunk, "chunk_rand": chunk * 2,
           "cchunk": clean}
    out = pipeline.make_prepare_fn({"regr": []}, random_scale=True)(
        raw, torch.Generator().manual_seed(1))
    gain = out["chunk"][:, :1] / chunk[:, :1]
    assert (gain > 0).all() and (gain <= 1 / chunk.abs().amax(1, True)).all()
    torch.testing.assert_close(out["cchunk"], clean * gain, rtol=1e-6,
                               atol=1e-7)


CACHE_WORKERS = {"regr": [{"name": n} for n in CLOSE_TARGETS]}


@pytest.fixture(scope="module")
def caches(corpus, tmp_path_factory):
    root = tmp_path_factory.mktemp("caches")
    files = [w["filename"] for w in
             json.load(open(corpus.cfg))["train"]["data"]]
    dirs = {"jax": str(root / "jax"), "port": str(root / "port")}
    assert jax_cache.precompute_features(
        corpus.root, files, jax_parse_workers(CACHE_WORKERS), dirs["jax"],
        bucket=8000) == len(files)
    assert cache.precompute_features(
        corpus.root, files, parse_workers_cfg(CACHE_WORKERS), dirs["port"],
        bucket=8000, device="cpu") == len(files)
    assert cache.precompute_features(
        corpus.root, files, parse_workers_cfg(CACHE_WORKERS), dirs["port"],
        bucket=8000, device="cpu") == 0
    return files, dirs


def test_precompute_features_matches_jax(caches):
    files, dirs = caches
    for f in files:
        name = os.path.splitext(f)[0] + cache.CACHE_EXT
        with np.load(os.path.join(dirs["jax"], name)) as w, \
                np.load(os.path.join(dirs["port"], name)) as g:
            assert set(g.files) == set(w.files) == {"_hop", *CLOSE_TARGETS}
            assert int(g["_hop"]) == int(w["_hop"]) == 160
            for k in CACHE_WORKERS["regr"]:
                a, b = g[k["name"]], w[k["name"]]
                assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
                assert rel_err(a, b) <= REL, (f, k)


@pytest.mark.parametrize("which", ["jax", "port"])
def test_cached_batchers_read_either_cache(corpus, caches, which):
    names = [e["name"] for e in CACHE_WORKERS["regr"]]
    make = {pkg: mod.CachedTargetBatcher(
        ds_mod.LibriSpeechTupleDataset(corpus.root, corpus.cfg, "train"), 3,
        CHUNK, cache_dir=caches[1][which], worker_names=names, seed=2)
        for pkg, mod, ds_mod in (("jax", jax_cache, JD), ("port", cache, D))}
    for i in range(3):
        g, w = make["port"]._make_batch(), make["jax"]._make_batch()
        _assert_same(g, w, f"cached batch {i} on the {which} cache")
        assert g["fbank"].shape == (3, CHUNK // 160, 120)
    with pytest.raises(ValueError, match="zero_speech_p"):
        cache.CachedTargetBatcher(_dataset(D, corpus, "zero_speech"), 2,
                                  CHUNK, caches[1][which], names)
    with pytest.raises(ValueError, match="plain tuple"):
        cache.CachedTargetBatcher(_dataset(D, corpus, "genhancement"), 2,
                                  CHUNK, caches[1][which], names)


def test_prepare_passes_cached_targets_through(corpus, caches):
    """A cached batch skips extraction: its targets are the cache's
    slices, ZNormed; the chunk itself is untouched."""
    names = [e["name"] for e in CACHE_WORKERS["regr"]]
    raw = cache.CachedTargetBatcher(
        D.LibriSpeechTupleDataset(corpus.root, corpus.cfg, "train"), 2,
        CHUNK, caches[1]["port"], names)._make_batch()
    stats = {"mfcc": {"mean": np.full(39, 0.5, np.float32),
                      "std": np.full(39, 2.0, np.float32)}}
    out = pipeline.make_prepare_fn(parse_workers_cfg(CACHE_WORKERS),
                                   stats=stats)(
        {k: torch.from_numpy(v) for k, v in raw.items()})
    np.testing.assert_array_equal(out["fbank"].numpy(), raw["fbank"])
    np.testing.assert_allclose(out["mfcc"].numpy(),
                               (raw["mfcc"] - 0.5) / 2.0, rtol=1e-6)
    np.testing.assert_array_equal(out["chunk"].numpy(), raw["chunk"])


def test_statistics_cli_matches_the_root_script(corpus, tmp_path,
                                                monkeypatch):
    from pase_tpu_torch import make_trainset_statistics as port_stats
    wk = tmp_path / "wk.cfg"
    wk.write_text(json.dumps(CACHE_WORKERS))
    args = ["--data_root", corpus.root, "--data_cfg", corpus.cfg,
            "--net_cfg", str(wk), "--batch_size", "3", "--chunk_size",
            str(CHUNK), "--max_batches", "2"]
    root_script = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "make_trainset_statistics.py")
    monkeypatch.setattr(sys, "argv", [root_script] + args + [
        "--out_file", str(tmp_path / "jax.pkl"), "--jax_cache_dir", ""])
    runpy.run_path(root_script, run_name="__main__")
    port_stats.main(args + ["--out_file", str(tmp_path / "port.pkl"),
                            "--device", "cpu"])
    with open(tmp_path / "jax.pkl", "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "port.pkl", "rb") as f:
        got = pickle.load(f)
    assert set(got) == set(want) == set(CLOSE_TARGETS)
    for k in want:
        for m in ("mean", "std"):
            assert got[k][m].shape == want[k][m].shape
            assert rel_err(got[k][m], want[k][m]) <= REL, (k, m)
