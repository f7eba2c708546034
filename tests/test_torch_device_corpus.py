"""The port's card-resident corpus (pase_tpu_torch.data.device_corpus), the
training step on a disk batch, and the training CLI's disk feeds, against
the JAX package on the CPU.

* ``DeviceCorpusBatcher`` on the CPU device: its int16 buffer and its
  offset, length and neighbor tables equal the JAX batcher's exactly
  (plain, zero-speech and parallel corpora); rows equal ``read_wav``
  (padded with ``crop_at`` when short) at the starts it draws; the
  sampling rules hold; ``batches(k)`` is the tail of ``batches(0)``. Its
  random streams are not JAX's, so batches are compared by rules.
* One train step on a MetaConcat disk batch with dist_mask, zs_mask and
  cchunk, the distortion stack and the zero-speech additive on, given the
  JAX step's draws: per-worker losses within 1e-5 relative and gradients
  within 1e-4 of each leaf's largest (the bounds of
  tests/test_torch_train.py). The trainer's staging under the int16 wire:
  exact PCM16, and the same prepared batch as the float32 wire.
* ``python -m pase_tpu_torch.train`` at a tiny width, 2 steps per feed:
  the host feed (threads or one batcher), --fast_loader, --device_corpus,
  --cache_feats_dir, --wire_dtype int16, zero-speech with a
  --zerospeech_cfg, a parallel clean tree, two corpora, and resume.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from pase_tpu.data import dataset as JD
from pase_tpu.data.device_corpus import DeviceCorpusBatcher as JaxCorpus
from pase_tpu.data.distortions import (DistortionAssets as JaxAssets,
                                       DistortionConfig as JaxConfig)
from pase_tpu.parallel.mesh import get_mesh
from pase_tpu.trainer import Trainer as JaxTrainer
from pase_tpu_torch.checkpoint import (load_model_variables,
                                       model_state_dict_to_variables)
from pase_tpu_torch.data import dataset as D
from pase_tpu_torch.data import distortions as PD
from pase_tpu_torch.data.device_corpus import DeviceCorpusBatcher
from pase_tpu_torch.data.io import read_wav, write_wav
from pase_tpu_torch.trainer import Trainer
from test_torch_data import _overlap_assets, jax_zs_draws, write_corpus
from test_torch_distortions import jax_draws
from test_torch_train import (ADAM_B1, BN_CANCELLED, SMALL_FE, _cfg,
                              _init_state, _np_tree, small_workers)
from torch_port_common import port_test_guard  # noqa: F401

CHUNK = 4800


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("corpus")))


def _libri(pkg, corpus, split="train", **kw):
    return pkg.LibriSpeechTupleDataset(corpus.root, corpus.cfg, split, **kw)


def _genh(pkg, corpus, split="train"):
    return pkg.GenhancementDataset(corpus.root, corpus.clean, corpus.cfg,
                                   split)


@pytest.mark.parametrize("case", ["plain", "zero_speech", "parallel"])
def test_buffer_and_tables_equal_jax(corpus, case):
    zs = 0.5 if case == "zero_speech" else 0.0
    make = _genh if case == "parallel" else (
        lambda pkg, c: _libri(pkg, c, zero_speech_p=zs))
    want = JaxCorpus(make(JD, corpus), 3, CHUNK, seed=4)
    got = DeviceCorpusBatcher(make(D, corpus), 3, CHUNK, seed=4,
                              device="cpu")
    assert got.buf.dtype == torch.int16 and got.buf.device.type == "cpu"
    np.testing.assert_array_equal(got.buf.numpy(), np.asarray(want.buf))
    for name in ("offsets", "lengths"):
        assert getattr(got, name).dtype == np.int64
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    np.testing.assert_array_equal(got.nb_table, np.asarray(want._d_nb))
    np.testing.assert_array_equal(got.nb_count, np.asarray(want._d_cnt))
    for g, w in zip(got.neighbors, want.neighbors):
        np.testing.assert_array_equal(g, w)
    assert got.bpe == want.bpe and got.n_utts == want.n_utts
    assert got.nbytes == round(want.buf_gb * 1e9)
    if case == "parallel":
        np.testing.assert_array_equal(got.cbuf.numpy(),
                                      np.asarray(want.cbuf))
        np.testing.assert_array_equal(got.coffsets, want.coffsets)
        np.testing.assert_array_equal(got.clengths, want.clengths)


def _padded(root, name, t):
    wav, _ = read_wav(os.path.join(root, name))
    return D.crop_at(wav, 0, t) if len(wav) < t else wav


def _utt_of(batcher, start):
    """(utterance index, offset in it) of an absolute start."""
    i = int(np.searchsorted(batcher.offsets, start, side="right") - 1)
    return i, int(start - batcher.offsets[i])


def test_rows_are_the_wav_samples_and_sampling_rules_hold(corpus):
    ds = _libri(D, corpus)
    names = [w["filename"] for w in ds.wavs]
    b = DeviceCorpusBatcher(ds, 4, CHUNK, seed=1, device="cpu")
    assert any(len(read_wav(os.path.join(corpus.root, n))[0]) < CHUNK
               for n in names), "the corpus needs short utterances"
    prefix = [ds.rec.sub("", n) for n in names]
    ctxt_seen_other = False
    for step in range(12):
        batch = b.make_batch(step)
        starts = b.sample_starts(step).numpy()
        assert starts.shape == (3, 4)
        for role, key in enumerate(("chunk", "chunk_ctxt", "chunk_rand")):
            for r in range(4):
                i, off = _utt_of(b, starts[role, r])
                assert 0 <= off <= b.lengths[i] - CHUNK
                wav = _padded(corpus.root, names[i], CHUNK)
                np.testing.assert_array_equal(
                    batch[key][r].numpy(), wav[off:off + CHUNK])
        for r in range(4):
            a, c, x = (_utt_of(b, starts[k, r])[0] for k in range(3))
            assert prefix[c] == prefix[a]
            assert c != a or len(b.neighbors[a]) == 1 and \
                b.neighbors[a][0] == a
            ctxt_seen_other |= c != a
            assert x != a
    assert ctxt_seen_other
    # the same step gives the same batch; batches(k) is batches(0)'s tail
    tail = b.batches(5)
    whole = b.batches(0)
    for _ in range(5):
        next(whole)
    for _ in range(3):
        g, w = next(tail), next(whole)
        for k in w:
            assert torch.equal(g[k], w[k])


def test_short_utterances_are_padded_like_crop_at(tmp_path):
    rng = np.random.RandomState(0)
    wavs, total = [], 0
    for i, n in enumerate((700, 3000, 2000, 9000)):
        name = f"7-70-{i:04d}.wav"
        write_wav(str(tmp_path / name), rng.randn(n) * 0.1)
        wavs.append({"filename": name})
        total += n
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"train": {"data": wavs,
                                         "total_wav_dur": total}}))
    ds = D.LibriSpeechTupleDataset(str(tmp_path), str(cfg), "train")
    b = DeviceCorpusBatcher(ds, 2, 2500, device="cpu")
    assert list(b.lengths) == [2500, 3000, 2500, 9000]
    for i, w in enumerate(wavs):
        wav, _ = read_wav(str(tmp_path / w["filename"]))
        seg = b.buf[b.offsets[i]:b.offsets[i] + b.lengths[i]].numpy()
        np.testing.assert_array_equal(
            seg.astype(np.float32) / 32768, D.crop_at(wav, 0, 2500)
            if len(wav) < 2500 else wav)
    assert ds.wav_cache == {}


def test_parallel_trees(corpus):
    ds = _genh(D, corpus)
    names = [w["filename"] for w in ds.wavs]
    b = DeviceCorpusBatcher(ds, 4, CHUNK, seed=2, device="cpu")
    for step in range(6):
        batch = b.make_batch(step)
        st = b.sample_starts(step).numpy()
        assert set(batch) == {"chunk", "cchunk", "chunk_ctxt", "chunk_rand"}
        for r in range(4):
            i, off = _utt_of(b, st[0, r])
            ci = int(np.searchsorted(b.coffsets, st[1, r], "right") - 1)
            assert ci == i and st[1, r] - b.coffsets[i] == off
            noisy = _padded(corpus.root, names[i], CHUNK)
            clean = _padded(corpus.clean, names[i], CHUNK)
            np.testing.assert_array_equal(batch["chunk"][r].numpy(),
                                          noisy[off:off + CHUNK])
            np.testing.assert_array_equal(batch["cchunk"][r].numpy(),
                                          clean[off:off + CHUNK])
            k = int(np.searchsorted(b.coffsets, st[2, r], "right") - 1)
            coff = int(st[2, r] - b.coffsets[k])
            assert k == i and 0 <= coff <= b.clengths[i] - CHUNK
            np.testing.assert_array_equal(batch["chunk_ctxt"][r].numpy(),
                                          clean[coff:coff + CHUNK])
            x, xoff = _utt_of(b, st[3, r])
            assert x != i
            np.testing.assert_array_equal(
                batch["chunk_rand"][r].numpy(),
                _padded(corpus.root, names[x], CHUNK)[xoff:xoff + CHUNK])
    with pytest.raises(ValueError, match="zero-speech"):
        ds.zero_speech_p = 0.5
        DeviceCorpusBatcher(ds, 2, CHUNK, device="cpu")


def test_zero_speech_rows_come_from_the_bank(corpus):
    b = DeviceCorpusBatcher(_libri(D, corpus, zero_speech_p=0.5), 8, CHUNK,
                            seed=3, zero_speech_bank=4, device="cpu")
    anchors = torch.cat([b.sample_starts(s)[0] for s in range(10)]).numpy()
    in_bank = anchors >= b.offsets[b.n_utts]
    assert 0.3 < in_bank.mean() < 0.7
    batch = b.make_batch(0)
    zs = b.sample_starts(0)[0].numpy() >= b.offsets[b.n_utts]
    # 1e-5 noise on the int16 grid: silence but for a rare step of 1 / 32768
    assert zs.any() and (np.abs(batch["chunk"].numpy()[zs]) * 32768 <= 2).all()


# --------------------------------------------------------------------------
# one train step on a disk batch against the JAX step
# --------------------------------------------------------------------------

DIST = dict(reverb_p=0.5, overlap_p=0.6, noises_p=0.6)
SNRS = (0, 5, 10)


def test_disk_batch_train_step_matches_jax(corpus, tmp_path):
    """The JAX Trainer with the stack and the zero-speech additive, its
    state's params and BatchNorm stats randomized as test_torch_train
    does, one step on a MetaConcat batch; the port's step on the same batch
    with the JAX step's draws. The batch stays float32: on the int16 grid
    a zero-speech row is silence with a few samples of 1 / 32768, where
    the two packages' box sums of the gammatone power leave different
    rounding noise (gtn targets 5.6 % of their largest value apart on
    those rows; ROADMAP.md queue 3)."""
    b = 4
    ds = D.MetaConcatDataset(
        [_libri(D, corpus, seed=1, zero_speech_p=0.4),
         _genh(D, corpus, "valid")], dist_flags=[True, False])
    # seed 2: rows 0 and 2 zero-speech, row 3 from the undistorted corpus
    raw = D.ChunkBatcher(ds, b, CHUNK, seed=2)._make_batch()
    assert 0 < raw["zs_mask"].sum() < b and 0 < raw["dist_mask"].sum() < b
    assert set(raw) == {"chunk", "chunk_ctxt", "chunk_rand", "cchunk",
                        "dist_mask", "zs_mask"}
    cfg = PD.DistortionConfig(**DIST)
    assets = _overlap_assets(CHUNK)
    zs_bank = torch.from_numpy(np.random.RandomState(4).randn(
        2, 2 * CHUNK).astype(np.float32) * 0.1)
    jcfg = dict(_cfg(tmp_path / "jax"), batch_size=b)
    jtr = JaxTrainer(
        SMALL_FE, small_workers(), jcfg, mesh=get_mesh(
            devices=jax.devices()[:1]),
        dist_cfg=JaxConfig(**cfg._asdict()),
        dist_assets=JaxAssets(*(None if a is None else jnp.asarray(a.numpy())
                                for a in assets)),
        zs_bank=jnp.asarray(zs_bank.numpy()), zs_snrs=SNRS)
    state = _init_state(jtr)
    params = _np_tree(state.params)
    rng = np.random.RandomState(7)
    for k, v in params.items():
        if k.endswith("norm/weight"):
            params[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("norm/bias"):
            params[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("act/weight"):
            params[k] = rng.uniform(0.0, 0.3, v.shape).astype(np.float32)
    state = state._replace(params=unflatten_dict(
        {k: jnp.asarray(v) for k, v in params.items()}, sep="/"))
    stats = _np_tree(state.batch_stats)
    k_prep = jax.random.split(state.rng, 5)[1]
    _, k_dist, k_zs = jax.random.split(k_prep, 3)
    new_state, jlosses = jtr._make_train_step()(
        state, {k: jnp.asarray(v) for k, v in raw.items()})
    grads = {}
    for group in new_state.opt_state.inner_states.values():
        adam = group.inner_state[0]
        for k, mu in flatten_dict(unfreeze(adam.mu), sep="/").items():
            if not isinstance(mu, optax.MaskedNode):
                grads[k] = np.asarray(mu, np.float64) / (1.0 - ADAM_B1)

    tr = Trainer(SMALL_FE, small_workers(),
                 dict(jcfg, save_path=str(tmp_path / "port")),
                 dist_cfg=cfg, dist_assets=assets, device="cpu",
                 zs_bank=zs_bank, zs_snrs=SNRS)
    flat = {f"params/{k}": v for k, v in params.items()}
    flat.update({f"batch_stats/{k}": v for k, v in stats.items()})
    load_model_variables(tr.model, flat)
    losses = tr.train_step(raw, draws=jax_draws(k_dist, b, CHUNK, cfg,
                                                assets),
                           zs_draws=jax_zs_draws(k_zs, b, CHUNK, zs_bank,
                                                 SNRS))
    for name in tr.ordered_names + ["total"]:
        got, want = float(losses[name]), float(jlosses[name])
        assert abs(got - want) <= 1e-5 * abs(want), (name, got, want)
    port_grads = model_state_dict_to_variables(
        {k: p.grad for k, p in tr.model.named_parameters()})
    fe_max = max(np.abs(g).max() for k, g in grads.items()
                 if k.startswith("frontend/"))
    for k, g in grads.items():
        got = port_grads["params/" + k]
        if k in BN_CANCELLED:
            assert np.abs(got).max() <= 1e-5 * fe_max, k
            continue
        err = np.abs(got - g).max()
        assert err <= 1e-4 * np.abs(g).max(), (k, err, np.abs(g).max())


def test_stage_sends_waveforms_as_int16(corpus, tmp_path):
    """Under the int16 wire the host waveforms cross as PCM16 (read_wav's
    samples exactly), the rest as float32; int16 input stays int16; the
    prepared batch equals the float32 wire's. (On the card, tests/
    test_torch_cuda.py holds the pinned copy and the device tensors kept
    in place.)"""
    raw = D.ChunkBatcher(_genh(D, corpus), 3, CHUNK, seed=1)._make_batch()
    raw["dist_mask"] = np.ones(3, np.float32)
    trs = {w: Trainer(SMALL_FE, small_workers(),
                      dict(_cfg(tmp_path / w), wire_dtype=w), device="cpu")
           for w in ("float32", "int16")}
    staged = trs["int16"].stage(raw)
    assert staged.event is None
    for k in ("chunk", "chunk_ctxt", "chunk_rand", "cchunk"):
        assert staged.batch[k].dtype == torch.int16
        np.testing.assert_array_equal(staged.batch[k].numpy(),
                                      np.round(raw[k] * 32768))
    assert staged.batch["dist_mask"].dtype == torch.float32
    pcm = torch.from_numpy(np.round(raw["chunk"] * 32768).astype(np.int16))
    assert trs["float32"].stage({"chunk": pcm}).batch["chunk"].dtype == \
        torch.int16
    with torch.no_grad():
        got = trs["int16"].prepare(trs["int16"].ready(staged))
        want = trs["float32"].prepare(trs["float32"].ready(raw))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="wire_dtype"):
        Trainer(SMALL_FE, small_workers(),
                dict(_cfg(tmp_path / "x"), wire_dtype="int8"), device="cpu")


# --------------------------------------------------------------------------
# the training CLI from a corpus
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_corpus(tmp_path_factory):
    """A corpus of 2 steps per epoch at batch 2 x CHUNK, its clean tree,
    noise, cfgs, a ZNorm pickle and a feature cache."""
    from test_torch_data import CLOSE_TARGETS
    from pase_tpu_torch.data.cache import precompute_features
    from pase_tpu_torch.data.pipeline import compute_stats, save_stats_pkl
    from pase_tpu_torch.model import parse_workers_cfg
    root = tmp_path_factory.mktemp("cli")
    c = write_corpus(str(root), train_seconds=1.2, valid_seconds=0.5,
                     seed=7)
    total = json.load(open(c.cfg))["train"]["total_wav_dur"]
    assert total // CHUNK // 2 == 2, total
    wk = small_workers()
    for name, cfg in (("fe.cfg", SMALL_FE), ("wk.cfg", wk)):
        (root / name).write_text(json.dumps(cfg))
    (root / "zs.cfg").write_text(json.dumps({"noises_dir": c.noise,
                                             "noises_snrs": [0, 5]}))
    # a second corpus: the valid split's files as a train split
    split = json.load(open(c.cfg))["valid"]
    (root / "cfg2.json").write_text(json.dumps({"train": split,
                                                "valid": split}))
    meta = parse_workers_cfg(wk)
    save_stats_pkl(compute_stats(
        D.SyntheticChunkBatcher(2, CHUNK, seed=1), meta, max_batches=1,
        device="cpu"), str(root / "stats.pkl"))
    files = [w["filename"] for split in ("train", "valid")
             for w in json.load(open(c.cfg))[split]["data"]]
    precompute_features(c.root, files, meta, str(root / "feats"),
                        device="cpu")
    assert CLOSE_TARGETS
    return root, c


def _run(root, c, save, *flags, epoch=1):
    from pase_tpu_torch import train as port_train
    return port_train.main([
        "--device", "cpu", "--data_root", c.root, "--data_cfg", c.cfg,
        "--net_cfg", str(root / "wk.cfg"), "--fe_cfg", str(root / "fe.cfg"),
        "--batch_size", "2", "--chunk_size", str(CHUNK), "--epoch",
        str(epoch), "--log_freq", "1", "--stats", str(root / "stats.pkl"),
        "--save_path", str(save)] + list(flags))


def _records(save):
    with open(os.path.join(save, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


FEEDS = {
    "threads": [],                       # --num_workers 2, the default
    "one_batcher": ["--num_workers", "1"],
    "fast_loader": ["--fast_loader", "--num_workers", "1"],
    "wire_int16": ["--wire_dtype", "int16", "--num_workers", "3"],
    "device_corpus": ["--device_corpus"],
    "cache": ["--cache_feats_dir", "{root}/feats"],
    "trans_cache": ["--trans_cache", "{root}/feats", "--num_workers", "1"],
    "zero_speech": ["--zero_speech_p", "0.5", "--zerospeech_cfg",
                    "{root}/zs.cfg"],
    "parallel": ["--dataset", "GenhancementDataset", "--clean_root",
                 "{clean}", "--device_corpus"],
    "two_corpora": ["--data_root", "{data}", "--data_cfg", "{root}/cfg2.json",
                    "--dataset", "LibriSpeechSegTupleWavDataset",
                    "--dataset", "PairWavDataset", "--dtrans_cfg", "None"],
}


@pytest.mark.parametrize("feed", sorted(FEEDS))
def test_train_cli_feeds_and_resume(cli_corpus, tmp_path, feed):
    """Two steps and an eval batch, every logged loss finite, then a
    second call with --epoch 2 resumes at step 2."""
    root, c = cli_corpus
    flags = [f.format(root=root, clean=c.clean, data=c.root, cfg=c.cfg)
             for f in FEEDS[feed]]
    tr = _run(root, c, tmp_path, *flags)
    bpe = tr.bpe
    assert bpe == (2 if feed != "two_corpora" else 3)
    assert tr.step == bpe and tr.cfg["va_bpe"] == 1
    recs = _records(tmp_path)
    splits = [r["split"] for r in recs]
    extra = ["feed"] if "--device_corpus" in flags else []
    assert splits == extra + ["train"] * bpe + ["perf", "eval"], splits
    for r in recs:
        assert all(np.isfinite(v) for v in r.values()
                   if isinstance(v, float)), r
    perf = recs[splits.index("perf")]
    assert perf["feed_wait_ms"] >= 0 and perf["stage_ms"] >= 0
    if extra:
        assert recs[0]["corpus_bytes"] > 0 and recs[0]["corpus_build_s"] > 0
    tr = _run(root, c, tmp_path, *flags, epoch=2)
    assert tr.step == 2 * bpe
    assert [r["step"] for r in _records(tmp_path)
            if r["split"] == "train"] == list(range(1, 2 * bpe + 1))


def test_train_cli_device_corpus_resume_replays_the_batches(cli_corpus,
                                                            tmp_path):
    """The device feed from a resumed step: a run cut after epoch 1 and
    resumed ends with the uninterrupted run's losses, bit for bit."""
    root, c = cli_corpus
    whole = _run(root, c, tmp_path / "whole", "--device_corpus", epoch=2)
    _run(root, c, tmp_path / "cut", "--device_corpus", epoch=1)
    resumed = _run(root, c, tmp_path / "cut", "--device_corpus", epoch=2)
    assert whole.step == resumed.step == 4
    want = [r for r in _records(tmp_path / "whole") if r["split"] == "train"]
    got = [r for r in _records(tmp_path / "cut") if r["split"] == "train"]
    assert [r["step"] for r in got] == [1, 2, 3, 4]
    for g, w in zip(got[2:], want[2:]):
        assert {k: v for k, v in g.items() if k != "t"} == \
            {k: v for k, v in w.items() if k != "t"}


@pytest.mark.parametrize("flags,match", [
    (["--cache_feats_dir", "x", "--fast_loader"], "incompatible"),
    (["--cache_feats_dir", "x", "--trans_cache", "y"], "same capability"),
    (["--device_corpus", "--data_root", "{data}", "--data_cfg", "{cfg}"],
     "single corpus"),
    (["--device_corpus", "--dataset", "PairWavDataset"], "single corpus"),
    (["--device_corpus", "--zero_speech_p", "0.5", "--zerospeech_cfg",
      "{root}/zs.cfg"], "host feed"),
    (["--dataset", "NoSuchDataset"], "NoSuchDataset"),
])
def test_train_cli_refuses_what_jax_refuses(cli_corpus, tmp_path, flags,
                                            match):
    root, c = cli_corpus
    flags = [f.format(root=root, data=c.root, cfg=c.cfg) for f in flags]
    with pytest.raises(ValueError, match=match):
        _run(root, c, tmp_path, *flags)
