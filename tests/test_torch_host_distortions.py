"""The port's host distortion stage (pase_tpu_torch/data/host_distortions.py,
its vocoder csrc/codec2_lite.cc built by ops/host_build.py, the training
CLI's stage and util_scripts encode-codec2) against pase_tpu.data.
host_distortions and the root util_scripts.py, on the CPU.

Bounds: everything bit for bit (np.array_equal): the lite vocoder's round
trip (both libraries are built here by one g++ from the same code with
native/Makefile's flags), the c2enc / c2dec and ahocoder subprocess
paths (fake binaries on PATH, the same in both packages), the cache
reads, the stage's batches and draws, P.56 and AdditiveP56, the
encode-codec2 files. The train step on a staged batch: per-worker losses
within 1e-5 relative of JAX's (tests/test_torch_train.py's bound).
"""

import json
import os
import stat
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from pase_tpu.data import host_distortions as J
from pase_tpu.data.dataset import SyntheticChunkBatcher as JaxBatcher
from pase_tpu_torch.data import host_distortions as P
from pase_tpu_torch.data.io import read_wav, write_wav
from pase_tpu_torch.ops import host_build
from test_torch_train import _fresh, _port, jax_step, setup  # noqa: F401
from torch_port_common import port_test_guard  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000


@pytest.fixture(scope="module", autouse=True)
def jax_lite():
    """The JAX package's vocoder library (native/, built by its Makefile
    where the checkout has none yet)."""
    so = os.path.join(REPO, "native", "libpase_codec2lite.so")
    if not os.path.exists(so):
        subprocess.run(["make", "-C", os.path.join(REPO, "native"),
                        "libpase_codec2lite.so"],
                       capture_output=True)
    assert os.path.exists(so), "make -C native failed"


def _speech(t, f0=150.0, seed=0):
    n = np.arange(t) / SR
    x = sum(np.sin(2 * np.pi * f0 * k * n) / k for k in range(1, 8)) * 0.15
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * n))
    x += np.random.RandomState(seed).randn(t) * 0.005
    return x.astype(np.float32)


@pytest.mark.parametrize("kbps", [3200, 2400, 1600, 1300, 700])
def test_lite_round_trip_is_the_jax_one(kbps):
    """The 16k -> 8k -> 16k path, the int16 grid, the vocoder and the
    energy match: the same samples as JAX's, bit for bit, for a
    speech-like 2 s row and a noise row; not identity."""
    p, j = P.Codec2RoundTrip(kbps=kbps), J.Codec2RoundTrip(kbps=kbps)
    assert p.lite is not None and j.lite is not None
    for x in (_speech(32000, seed=kbps), (np.random.RandomState(kbps)
                                          .randn(16000) * 0.1)
              .astype(np.float32)):
        got, want = p(x), j(x)
        assert got.dtype == np.float32 and got.shape == x.shape
        assert np.array_equal(got, want)
        assert not np.allclose(got, x)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No compiler, a compiler that fails, a source that does not
    compile: each raises; nothing falls back to identity."""
    src = tmp_path / "bad.cc"
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="failed"):
        host_build.load(str(src), {}, build_dir=str(tmp_path / "b"))
    assert not os.listdir(tmp_path / "b")       # no half-written library
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        host_build.load(host_build.source_path("codec2_lite"), {},
                        build_dir=str(tmp_path / "c"))
    monkeypatch.setenv("CXX", "")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        host_build.load(host_build.source_path("codec2_lite"), {},
                        build_dir=str(tmp_path / "d"))
    # the vocoder's own library is named by its source and flags
    so = host_build.library_path(host_build.source_path("codec2_lite"),
                                 flags=host_build.CXX_FLAGS)
    assert os.path.basename(so).startswith("libcodec2_lite_")


def _script(path, body):
    path.write_text(f"#!{sys.executable}\n{body}")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)


FAKE_C2ENC = """import sys, numpy as np
mode, raw, enc = sys.argv[1:4]
x = np.fromfile(raw, dtype="<i2").astype(np.int32)
np.save(enc + ".npy", (x // 3 + int(mode) % 7).astype("<i2"))
import os; os.rename(enc + ".npy", enc)
"""
FAKE_C2DEC = """import sys, numpy as np
mode, enc, dec = sys.argv[1:4]
y = np.load(open(enc, "rb"))
y[::5] = 0
y[:-40].tofile(dec)
"""
FAKE_AHOCODER = """import sys, wave, numpy as np
inw, f0, cc, fv = sys.argv[1:5]
with wave.open(inw) as w:
    x = np.frombuffer(w.readframes(w.getnframes()), "<i2")
n = len(x) // 80
np.full(n, 4.5, "<f4").tofile(f0)
x[:n * 40].astype("<f4").tofile(cc)
np.zeros(n, "<f4").tofile(fv)
"""
FAKE_AHODECODER = """import sys, wave, numpy as np
f0, cc, fv, outw = sys.argv[1:5]
a = np.fromfile(f0, "<f4"); v = np.fromfile(fv, "<f4")
assert (a == -1e10).all() and (v == 1e3).all(), "F0 / FV not unvoiced"
c = np.fromfile(cc, "<f4")
y = (0.5 * c).astype("<i2")
with wave.open(outw, "wb") as w:
    w.setnchannels(1); w.setsampwidth(2); w.setframerate(16000)
    w.writeframes(y.tobytes())
"""


@pytest.fixture
def fake_tools(tmp_path, monkeypatch):
    """c2enc / c2dec and ahocoder16_64 / ahodecoder16_64 stand-ins on
    PATH (the real ones are not installed): deterministic transforms of
    their files."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name, body in (("c2enc", FAKE_C2ENC), ("c2dec", FAKE_C2DEC),
                       ("ahocoder16_64", FAKE_AHOCODER),
                       ("ahodecoder16_64", FAKE_AHODECODER)):
        _script(bin_dir / name, body)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}"
                       + os.environ.get("PATH", ""))
    return bin_dir


def test_codec2_binaries_path_is_the_jax_one(fake_tools):
    """With c2enc / c2dec on PATH both packages take the binaries (not
    the vocoder): the same PCM16 files in, the same samples out, the
    short decode zero-padded."""
    p, j = P.Codec2RoundTrip(kbps=1300), J.Codec2RoundTrip(kbps=1300)
    assert p.lite is None and j.lite is None and p.available
    x = _speech(8000, seed=3)
    got, want = p(x), j(x)
    assert np.array_equal(got, want)
    assert (got[-40:] == 0).all() and not np.allclose(got, x)


def test_whisperize_ahocoder_path_is_the_jax_one(fake_tools):
    """With the ahocoder binaries: the wav written, F0 / FV overwritten
    with the unvoiced values (the fake decoder checks them), the decoded
    wav read back and zero-padded, as in JAX."""
    p, j = P.Whisperize(), J.Whisperize()
    assert p.available and j.available
    x = _speech(8000, seed=4)
    got, want = p(x), j(x)
    assert np.array_equal(got, want)
    assert np.abs(got[:100]).max() > 0 and not np.allclose(got, x)


def test_whisperize_cache_and_identity_are_the_jax_ones(tmp_path, capsys):
    """The cache mode (basename lookup, chunk_beg:chunk_end, zero-padded
    past the cached wav's end), the identity without ahocoder (its
    message printed only without a cache dir) and Codec2's cache read."""
    cached = (np.random.RandomState(1).randn(16000) * 0.1).astype(np.float32)
    write_wav(str(tmp_path / "utt1.wav"), cached)
    x = np.zeros(8000, np.float32)
    for beg, end in ((1000, 9000), (12000, 20000), (0, None)):
        xi = x if end is not None else np.zeros(16000, np.float32)
        got = P.Whisperize(cache_dir=str(tmp_path))(
            xi, uttname="spk/utt1.wav", chunk_beg=beg, chunk_end=end)
        want = J.Whisperize(cache_dir=str(tmp_path))(
            xi, uttname="spk/utt1.wav", chunk_beg=beg, chunk_end=end)
        assert np.array_equal(got, want) and np.abs(got).max() > 0.01
    capsys.readouterr()
    w = P.Whisperize()
    assert "ahocoder unavailable; Whisperize is identity" in \
        capsys.readouterr().out
    assert not w.available and w(x) is x
    P.Whisperize(cache_dir=str(tmp_path))
    assert capsys.readouterr().out == ""
    for n in (8000, 20000):
        xi = _speech(n)
        got = P.Codec2RoundTrip(cache_dir=str(tmp_path))(xi, "utt1.wav")
        want = J.Codec2RoundTrip(cache_dir=str(tmp_path))(xi, "utt1.wav")
        assert np.array_equal(got, want)
        assert np.array_equal(got[:min(n, 16000)],
                              read_wav(str(tmp_path / "utt1.wav"))[0][:n])


def _batches(b=8, t=4800, n=3, seed=2):
    it = iter(JaxBatcher(b, t, seed=seed, bpe=n))
    out = []
    for i in range(n):
        batch = next(it)
        zs = np.zeros((b, 1), np.float32)
        zs[[1, 4 + i % 3]] = 1.0
        batch["zs_mask"] = zs
        out.append(batch)
    return out


def test_stage_batches_are_the_jax_ones_bit_for_bit():
    """HostDistortionStage / StagedBatcher over the same numpy batches,
    codec2 at 0.5 and whisperize (identity here) at 0.3, from one seed:
    every batch bit for bit, the zero-speech rows untouched, the input
    not mutated, the draws in JAX's order (the next draw agrees), and the
    stage's counters: the rows the codec changed."""
    src = _batches()
    jst = J.HostDistortionStage([J.Codec2RoundTrip(), J.Whisperize()],
                                [0.5, 0.3], seed=11)
    pst = P.HostDistortionStage([P.Codec2RoundTrip(), P.Whisperize()],
                                [0.5, 0.3], seed=11)
    want = list(J.StagedBatcher(src, jst))
    got = list(P.StagedBatcher([dict(b) for b in src], pst))
    assert P.StagedBatcher(src, pst).bpe is None
    changed = 0
    for s, g, w in zip(src, got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert np.array_equal(g[k], w[k]), k
        zs = s["zs_mask"][:, 0] > 0
        assert np.array_equal(g["chunk"][zs], s["chunk"][zs])
        changed += int((g["chunk"] != s["chunk"]).any(axis=1).sum())
        for k in ("chunk_ctxt", "chunk_rand"):
            assert g[k] is s[k]
    assert pst.rng.rand() == jst.rng.rand()
    summ = pst.summary()
    assert summ["rows"] == 24 and summ["batches"] == 3
    assert summ["fired_Codec2RoundTrip"] == changed > 0
    assert summ["share_Codec2RoundTrip"] == changed / 24
    assert summ["ms_per_batch"] > 0
    assert not np.array_equal(src[0]["chunk"], got[0]["chunk"])


def test_stage_fire_rate_and_zero_speech_rows():
    """Over 4000 rows at p = 0.2 the stage fires within 5 binomial sd of
    0.2 x the speech rows, exactly as JAX's does (the same rows); a
    zero-speech row never fires but consumes its draw."""
    rows = []

    def mark(x):
        rows.append(1)
        return x - 1.0

    batch = {"chunk": np.zeros((400, 4), np.float32),
             "zs_mask": (np.arange(400) % 10 == 0).astype(np.float32)}
    pst = P.HostDistortionStage([mark], [0.2], seed=5)
    jst = J.HostDistortionStage([lambda x: x - 1.0], [0.2], seed=5)
    fired = 0
    for _ in range(10):
        got, want = pst(batch), jst(batch)
        assert np.array_equal(got["chunk"], want["chunk"])
        assert (got["chunk"][::10] == 0).all()
        fired += int((got["chunk"][:, 0] != 0).sum())
    n = 10 * 360
    assert abs(fired - 0.2 * n) <= 5 * np.sqrt(n * 0.2 * 0.8)
    assert fired == len(rows) == pst.summary()["fired_function"]
    assert pst.summary()["rows"] == 4000


@pytest.mark.parametrize("case", ["speech", "quiet", "silence", "short"])
def test_asl_p56_is_the_jax_one(case):
    rng = np.random.RandomState(3)
    x = {"speech": _speech(32000),
         "quiet": _speech(16000) * 1e-3,
         "silence": np.zeros(8000, np.float32),
         "short": (rng.randn(400) * 0.2).astype(np.float32)}[case]
    got, want = P.asl_p56(x), J.asl_p56(x)
    assert got == want
    if case == "speech":
        assert got[0] > 0 and 0 < got[1] <= 1 and got[2] is not None
    if case == "silence":
        assert got == (0.0, 0.0, None)


@pytest.mark.parametrize("args", [
    (40.0, 30.0, 20.0, 10.0, 15.9, 0.5),     # bisection
    (36.0, 20.0, 20.1, 4.0, 15.9, 0.5),      # early-out: the lower
    (30.0, 29.0, 0.0, -2.0, 15.9, 0.5),      # diff > tol steps
    (10.0, 40.0, -20.0, -10.0, 15.9, 0.01)])
def test_bin_interp_quirks_are_the_jax_ones(args):
    assert P._bin_interp(*args) == J._bin_interp(*args)


def test_additive_p56_is_the_jax_one(tmp_path):
    """The legacy Additive: noise rows drawn, SNR by the P.56 active
    level, the iterative attenuation into [-1, 1); from arrays and from a
    directory; its refusals."""
    rng = np.random.RandomState(8)
    noises = [(rng.randn(12000) * 0.3).astype(np.float32) for _ in range(3)]
    p = P.AdditiveP56(noises, snr_levels=(-5, 0, 10), seed=4)
    j = J.AdditiveP56(noises, snr_levels=(-5, 0, 10), seed=4)
    for i in range(6):
        x = _speech(8000, seed=i) * (4.0 if i == 2 else 1.0)
        got, want = p(x), j(x)
        assert np.array_equal(got, want)
        assert got.max() < 1 and got.min() >= -1
    for i, n in enumerate(noises):
        write_wav(str(tmp_path / f"n{i}.wav"), n)
    x = _speech(8000, seed=9)
    assert np.array_equal(P.AdditiveP56(str(tmp_path), seed=1)(x),
                          J.AdditiveP56(str(tmp_path), seed=1)(x))
    with pytest.raises(NotImplementedError, match="do_IRS"):
        P.AdditiveP56(noises, do_IRS=True)
    with pytest.raises(ValueError, match="No noises found"):
        P.AdditiveP56(str(tmp_path / "none"))
    with pytest.raises(ValueError, match="greater than speech"):
        P.AdditiveP56([noises[0][:100]])(x)


def test_build_host_stage_is_the_jax_one(tmp_path):
    """The cfg keys: none -> None; codec2_p with codec2_kbps, or the
    legacy codec_kbits, and codec2_cachedir; whisper_p with
    whisper_cachedir; probabilities, kbps and seed as in JAX."""
    assert P.build_host_stage({}) is None
    assert P.build_host_stage({"codec2_p": 0, "whisper_p": None}) is None
    for cfg in ({"codec2_p": 0.4, "codec2_kbps": 1300},
                {"codec2_p": 0.4, "codec_kbits": 2400,
                 "codec2_cachedir": str(tmp_path)},
                {"whisper_p": 0.25, "whisper_cachedir": str(tmp_path)},
                {"codec2_p": "0.2", "whisper_p": 0.1}):
        p, j = P.build_host_stage(cfg, seed=6), J.build_host_stage(cfg,
                                                                    seed=6)
        assert p.probs == j.probs
        assert [type(t).__name__ for t in p.transforms] == \
            [type(t).__name__ for t in j.transforms]
        for a, b in zip(p.transforms, j.transforms):
            assert a.cache_dir == b.cache_dir
            assert getattr(a, "kbps", None) == getattr(b, "kbps", None)
        assert p.rng.rand() == j.rng.rand()


def test_encode_codec2_is_the_jax_tool(tmp_path):
    """util_scripts encode-codec2 against the root util_scripts.py's on
    three wavs (one at 8 kHz: both treat it as 16 kHz): the same names,
    byte for byte the same files."""
    sys.path.insert(0, REPO)
    import util_scripts as jax_tools
    from pase_tpu_torch import util_scripts
    src = tmp_path / "in"
    src.mkdir()
    write_wav(str(src / "a.wav"), _speech(32000, seed=1))
    write_wav(str(src / "b.wav"), _speech(9000, f0=220.0, seed=2))
    write_wav(str(src / "c.wav"), _speech(12000, seed=3), sr=8000)
    (src / "notes.txt").write_text("not a wav")
    import argparse
    # the root tool's subcommand arguments (its parser lives in main())
    jopts = argparse.Namespace(input_dir=str(src),
                               output_dir=str(tmp_path / "jax"), kbps=1300,
                               num_workers=3)
    jax_tools.encode_codec2(jopts)
    assert util_scripts.main(["encode-codec2", str(src),
                              str(tmp_path / "port"), "--kbps", "1300",
                              "--num_workers", "3"]) == 3
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == \
        ["a.wav", "b.wav", "c.wav"]
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == \
            (tmp_path / "port" / n).read_bytes(), n


def test_staged_train_step_matches_jax(setup, jax_step):  # noqa: F811
    """tests/test_torch_train.py's narrow model (B = 2), one step on a
    batch through the stage with codec2 at p = 1 (both rows degraded, the
    same bits in both packages): per-worker losses within 1e-5 relative
    of the JAX step's."""
    _, state, _, _, batches, _ = setup
    raw = {k: v.copy() for k, v in batches[0].items()}
    jb = J.HostDistortionStage([J.Codec2RoundTrip()], [1.0], seed=0)(raw)
    pb = P.HostDistortionStage([P.Codec2RoundTrip()], [1.0], seed=0)(raw)
    for k in jb:
        assert np.array_equal(pb[k], jb[k]), k
    assert not np.array_equal(pb["chunk"], raw["chunk"])
    _, jlosses = jax_step(_fresh(state),
                          {k: jnp.asarray(v) for k, v in jb.items()})
    tr = _port(setup, "staged")
    losses = tr.train_step(pb)
    for name in tr.ordered_names + ["total"]:
        got, want = float(losses[name]), float(jlosses[name])
        assert abs(got - want) <= 1e-5 * abs(want), (name, got, want)


def test_train_cli_with_the_host_stage(tmp_path):
    """python -m pase_tpu_torch.train from a seeded corpus with a
    --dtrans_cfg of codec2_p 0.5 / whisper_p 0.1 (its device stack off):
    two steps and an eval batch through two feed threads and the stage,
    every loss finite, the 'host_stage' line (4 rows, the codec's count);
    --synthetic and --device_corpus refuse the cfg."""
    from pase_tpu_torch import train as port_train
    from pase_tpu_torch.data.synthetic_corpus import write_synthetic_corpus
    from test_torch_train import SMALL_FE, small_workers
    root, cfg = write_synthetic_corpus(str(tmp_path / "corpus"), 1.2, 0.5,
                                       seed=7, utts_per_chapter=3,
                                       min_seconds=0.1, max_seconds=0.6)
    for name, c in (("fe.cfg", SMALL_FE), ("wk.cfg", small_workers()),
                    ("dist.cfg", {"codec2_p": 0.5, "codec2_kbps": 1600,
                                  "whisper_p": 0.1})):
        (tmp_path / name).write_text(json.dumps(c))
    argv = ["--device", "cpu", "--net_cfg", str(tmp_path / "wk.cfg"),
            "--fe_cfg", str(tmp_path / "fe.cfg"), "--batch_size", "2",
            "--chunk_size", "4800", "--epoch", "1", "--log_freq", "1",
            "--dtrans_cfg", str(tmp_path / "dist.cfg")]
    save = tmp_path / "run"
    tr = port_train.main(argv + ["--data_root", root, "--data_cfg", cfg,
                                 "--save_path", str(save)])
    assert tr.step == tr.bpe == 2
    with open(save / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    splits = [r["split"] for r in recs]
    assert splits == ["train", "train", "perf", "eval", "host_stage"], splits
    for r in recs:
        assert all(np.isfinite(v) for v in r.values()
                   if isinstance(v, float)), r
    hs = recs[-1]
    assert hs["rows"] == 4 and hs["batches"] == 2
    assert 0 <= hs["fired_Codec2RoundTrip"] <= 4
    assert hs["share_Whisperize"] == hs["fired_Whisperize"] / 4
    for flags, match in ((["--synthetic"], "--synthetic is incompatible"),
                         (["--data_root", root, "--data_cfg", cfg,
                           "--device_corpus"],
                          "--device_corpus is incompatible")):
        with pytest.raises(ValueError, match=match):
            port_train.main(argv + flags + ["--save_path",
                                            str(tmp_path / "no")])
