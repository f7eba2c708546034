"""The sharded device corpus of the port
(pase_tpu_torch/data/device_corpus.py ``ShardedDeviceCorpusBatcher``)
against the JAX package's, on the CPU.

The partition of the filename-prefix groups over D shards is the JAX
batcher's exactly (JAX side on the 8-device CPU mesh of tests/conftest.py,
D = 8 and D = 4), and so is each shard's packing; a rank decodes only its
shard. The port's sampling is its own (a torch generator keyed by seed,
step and rank), held here to its law: every row from the rank's shard,
chunk_ctxt a same-prefix sibling, chunk_rand another utterance of the
shard, the rows the wav samples. Then the JAX errors, and the training
CLI on two gloo ranks (tests/torch_port_ranks.py), mirroring
tests/test_cli_scripts.py's sharded-corpus run.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from pase_tpu.data import dataset as JD
from pase_tpu.data.device_corpus import \
    ShardedDeviceCorpusBatcher as JaxSharded
from pase_tpu.parallel.mesh import get_mesh
from pase_tpu_torch.data import dataset as D
from pase_tpu_torch.data import device_corpus as port_dc
from pase_tpu_torch.data.device_corpus import ShardedDeviceCorpusBatcher
from pase_tpu_torch.data.io import read_wav
from pase_tpu_torch.parallel import mesh
from test_torch_data import write_corpus
from torch_port_common import port_test_guard  # noqa: F401
from torch_port_ranks import rank_rows, run_cli_ranks

CHUNK = 4800


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """About 10 s of 0.1-0.6 s utterances (some shorter than CHUNK) in
    three-utterance chapters (well over 8 prefix groups), a parallel
    clean tree."""
    c = write_corpus(str(tmp_path_factory.mktemp("corpus")),
                     train_seconds=10.0, valid_seconds=2.0, seed=3)
    ds = D.LibriSpeechTupleDataset(c.root, c.cfg, "train")
    assert len(ds.neighbor_prefixes) >= 8
    return c


def _ds(pkg, c, parallel=False, split="train", **kw):
    if parallel:
        return pkg.GenhancementDataset(c.root, c.clean, c.cfg, split)
    return pkg.LibriSpeechTupleDataset(c.root, c.cfg, split, **kw)


def _port(c, n, rank, parallel=False, batch=None, seed=3):
    return ShardedDeviceCorpusBatcher(_ds(D, c, parallel), batch or 2 * n,
                                      CHUNK, seed=seed, device="cpu",
                                      rank=rank, world=n)


@pytest.mark.parametrize("n,parallel", [(8, False), (4, False), (4, True)],
                         ids=["D8", "D4", "D4_parallel"])
def test_partition_and_packing_equal_jax(corpus, n, parallel):
    want = JaxSharded(_ds(JD, corpus, parallel), 2 * n, CHUNK,
                      mesh=get_mesh(devices=jax.devices()[:n]), seed=3)
    buf = np.asarray(want._fs0["buf"])
    cbuf = np.asarray(want._fs0["cbuf"]) if parallel else None
    for r in (0, n - 1):
        got = _port(corpus, n, r, parallel)
        assert got.shard_names == want.shard_names
        assert got.n_shards == want.n_shards == n
        assert got.buf_gb == pytest.approx(want.buf_gb, rel=1e-12)
        assert got.bpe == want.bpe and got.batch_size == 2
        m = int(want.n_utts[r])
        assert got.n_utts == m
        np.testing.assert_array_equal(got.offsets, want.offsets[r, :m])
        np.testing.assert_array_equal(got.lengths, want.lengths[r, :m])
        total = int(got.lengths.sum())
        np.testing.assert_array_equal(got.buf.numpy(), buf[r, :total])
        if parallel:
            ctotal = int(got.clengths.sum())
            np.testing.assert_array_equal(got.cbuf.numpy(),
                                          cbuf[r, :ctotal])


def test_each_rank_decodes_only_its_shard(corpus, monkeypatch):
    n = 4
    ds = _ds(D, corpus)
    all_bytes = sum(2 * max(len(read_wav(os.path.join(corpus.root, w[
        "filename"]))[0]), CHUNK) for w in ds.wavs)
    loaded, nbytes = [], 0
    for r in range(n):
        ds = _ds(D, corpus)
        seen = []
        orig = ds._load

        def load(f, orig=orig, seen=seen):
            seen.append(f)
            return orig(f)

        monkeypatch.setattr(ds, "_load", load)
        b = ShardedDeviceCorpusBatcher(ds, 2 * n, CHUNK, seed=3,
                                       device="cpu", rank=r, world=n)
        assert b.owned_rows == [r]
        assert sorted(seen) == sorted(b.shard_names[r])
        loaded += seen
        nbytes += b.nbytes
    assert sorted(loaded) == sorted(w["filename"] for w in ds.wavs)
    assert nbytes == all_bytes


def _utt_of(b, start, offsets=None):
    offsets = b.offsets if offsets is None else offsets
    i = int(np.searchsorted(offsets, start, side="right") - 1)
    return i, int(start - offsets[i])


@pytest.mark.parametrize("rank", [0, 3])
def test_sampling_law_within_the_shard(corpus, rank):
    n = 4
    b = _port(corpus, n, rank, batch=12)
    names = b.shard_names[rank]
    ds = _ds(D, corpus)
    prefix = [ds.rec.sub("", f) for f in names]
    saw_sibling = False
    for step in range(8):
        batch = b.make_batch(step)
        starts = b.sample_starts(step).numpy()
        assert starts.shape == (3, 3)
        for role, key in enumerate(("chunk", "chunk_ctxt", "chunk_rand")):
            for r in range(3):
                i, off = _utt_of(b, starts[role, r])
                assert 0 <= off <= b.lengths[i] - CHUNK
                wav, _ = read_wav(os.path.join(corpus.root, names[i]))
                if len(wav) < CHUNK:
                    wav = D.crop_at(wav, 0, CHUNK)
                np.testing.assert_array_equal(batch[key][r].numpy(),
                                              wav[off:off + CHUNK])
        for r in range(3):
            a, c, x = (_utt_of(b, starts[k, r])[0] for k in range(3))
            assert prefix[c] == prefix[a]
            assert c != a or list(b.neighbors[a]) == [a]
            saw_sibling |= c != a
            assert x != a
    assert saw_sibling
    # another rank draws other rows from its own shard
    other = _port(corpus, n, (rank + 1) % n, batch=12)
    assert not torch.equal(other.make_batch(0)["chunk"],
                           b.make_batch(0)["chunk"])
    # resume: batches(k) / feed_state(k) is batches(0)'s tail
    whole, tail = b.batches(0), b.feed_state(3)
    for _ in range(3):
        next(whole)
    for _ in range(2):
        g, w = next(tail), next(whole)
        for k in w:
            assert torch.equal(g[k], w[k])


def test_parallel_trees_share_the_window(corpus):
    b = _port(corpus, 4, 1, parallel=True, batch=12)
    names = b.shard_names[1]
    for step in range(4):
        batch = b.make_batch(step)
        st = b.sample_starts(step).numpy()
        for r in range(3):
            i, off = _utt_of(b, st[0, r])
            ci, coff = _utt_of(b, st[1, r], b.coffsets)
            xi, _ = _utt_of(b, st[2, r], b.coffsets)
            assert (ci, coff) == (i, off) and xi == i
            clean, _ = read_wav(os.path.join(corpus.clean, names[i]))
            if len(clean) < CHUNK:
                clean = D.crop_at(clean, 0, CHUNK)
            np.testing.assert_array_equal(batch["cchunk"][r].numpy(),
                                          clean[coff:coff + CHUNK])


@pytest.mark.parametrize("case", ["zero_speech", "indivisible", "groups",
                                  "cap", "header"])
def test_errors_are_jaxs(corpus, monkeypatch, case):
    kw, n, batch, match = {}, 4, 8, None
    if case == "zero_speech":
        kw, match = {"zero_speech_p": 0.5}, "zero-speech"
    elif case == "indivisible":
        batch, match = 6, "not divisible"
    elif case == "groups":
        n, batch, match = 64, 64, "prefix groups"
    elif case == "cap":
        monkeypatch.setattr(port_dc, "wav_len", lambda p: 1 << 31)
        match = "2\\^31"
    else:
        real = port_dc.wav_len
        monkeypatch.setattr(port_dc, "wav_len",
                            lambda p: max(real(p), CHUNK) + 1)
        match = "header said"
    with pytest.raises(ValueError, match=match):
        ShardedDeviceCorpusBatcher(_ds(D, corpus, **kw), batch, CHUNK,
                                   device="cpu", rank=0, world=n)


def _cli_files(tmp, corpus, data_cfg=None):
    fe = {"kwidths": [65, 10, 5, 5], "strides": [1, 10, 4, 4],
          "fmaps": [16, 16, 32, 32], "emb_dim": 32, "norm_out": True}
    wk = {"regr": [{"num_outputs": 39, "dropout": 0, "hidden_size": 32,
                    "hidden_layers": 1, "name": "mfcc", "r": 1,
                    "loss": "MSELoss", "skip": False}],
          "cls": [{"num_outputs": 1, "dropout": 0, "hidden_size": 32,
                   "hidden_layers": 1, "name": "mi",
                   "loss": "BCEWithLogitsLoss", "skip": False}]}
    (tmp / "fe.cfg").write_text(json.dumps(fe))
    (tmp / "wk.cfg").write_text(json.dumps(wk))
    return ["--device", "cpu", "--net_cfg", str(tmp / "wk.cfg"),
            "--fe_cfg", str(tmp / "fe.cfg"), "--data_root", corpus.root,
            "--data_cfg", data_cfg or corpus.cfg, "--batch_size", "8",
            "--chunk_size",
            str(CHUNK), "--epoch", "1", "--log_freq", "1"]


def test_train_cli_two_ranks_shard_the_corpus(corpus, tmp_path):
    """Two gloo ranks of the training CLI with --device_corpus
    --shard_device_corpus: each holds its shard, the bytes add up to the
    corpus's, rank 0 writes FE_e0.npz and metrics.jsonl, rank 1's rows
    (printed) equal them bit for bit, every loss finite."""
    base = _cli_files(tmp_path, corpus) + [
        "--device_corpus", "--shard_device_corpus", "--save_path",
        str(tmp_path / "run")]
    outs = run_cli_ranks(lambda r, n, port: [
        "pase_tpu_torch.train"] + base + [
        "--coordinator_address", f"127.0.0.1:{port}",
        "--num_processes", str(n), "--process_id", str(r)])
    assert os.path.isfile(tmp_path / "run" / "FE_e0.npz")
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    ours = rank_rows(outs[1], 1)
    strip = [{k: v for k, v in r.items() if k != "t"} for r in rows
             if r["split"] in ("train", "eval")]
    assert strip and strip == [{k: v for k, v in r.items() if k != "t"}
                               for r in ours
                               if r["split"] in ("train", "eval")]
    assert all(np.isfinite(v) for r in strip for v in r.values()
               if isinstance(v, float))
    feeds = [r for r in rows + ours if r["split"] == "feed"]
    assert len(feeds) == 2
    nbytes = [int(r["corpus_bytes"]) for r in feeds]
    assert min(nbytes) > 0
    ds = _ds(D, corpus)
    assert sum(nbytes) == sum(
        2 * max(len(read_wav(os.path.join(corpus.root, w["filename"]))[0]),
                CHUNK) for w in ds.wavs)


@pytest.mark.parametrize("flags,match", [
    (["--shard_device_corpus"], "requires --device_corpus"),
    (["--device_corpus"], "single-process only"),
    (["--device_corpus", "--shard_device_corpus"], "prefix groups"),
], ids=["no_device_corpus", "single_buffer", "valid_too_small"])
def test_train_cli_multi_process_errors(corpus, tmp_path, monkeypatch,
                                        flags, match):
    """JAX's errors of a multi-process run (the process group faked as
    two ranks, rank 0): --shard_device_corpus without --device_corpus;
    the single-buffer device corpus; a valid split with fewer prefix
    groups than processes, which only a single process may put in one
    buffer."""
    from pase_tpu_torch import train as port_train
    monkeypatch.setattr(mesh, "world", lambda: 2)
    monkeypatch.setattr(mesh, "rank", lambda: 0)
    data_cfg = corpus.cfg
    if match == "prefix groups":
        cfg = json.load(open(corpus.cfg))
        first = cfg["valid"]["data"][0]["filename"]
        prefix = first[:first.rindex("-")]
        cfg["valid"]["data"] = [e for e in cfg["valid"]["data"]
                                if e["filename"].startswith(prefix)]
        data_cfg = str(tmp_path / "data.cfg")
        with open(data_cfg, "w") as f:
            json.dump(cfg, f)
    argv = _cli_files(tmp_path, corpus, data_cfg) + flags + [
        "--save_path", str(tmp_path / "run")]
    with pytest.raises(ValueError, match=match):
        port_train.train(port_train.build_argparser().parse_args(argv))
