"""The port's worker targets and batch preparation (pase_tpu_torch.ops
.features, .ops.signal, .data.pipeline, .data.dataset) against the JAX
package on the same numpy inputs, on the CPU.

Bounds: each workers+ target within 1e-4 of its largest value (the JAX
side computes its STFTs and the prosody autocorrelation as float32
matmuls, the port through torch.fft); prosody's voicing decision (uv)
identical at the test seed; host-built constant matrices exact."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pase_tpu.data import pipeline as jax_pipeline
from pase_tpu.data.dataset import SyntheticChunkBatcher as JaxBatcher
from pase_tpu.model import parse_workers_cfg as jax_parse_workers
from pase_tpu.ops import features as jax_features
from pase_tpu.ops import signal as jax_signal
from pase_tpu_torch.data import pipeline
from pase_tpu_torch.data.dataset import DeviceSyntheticBatcher
from pase_tpu_torch.model import parse_workers_cfg
from pase_tpu_torch.ops import features, signal
from torch_port_common import rel_err
from torch_port_common import port_test_guard  # noqa: F401

REL = 1e-4
WORKERS = "cfg/workers/workers+.cfg"
TARGETS = ["lps", "lps_long", "fbank", "fbank_long", "gtn", "gtn_long",
           "mfcc", "mfcc_long", "prosody"]


@pytest.fixture(scope="module")
def wav():
    """Two synthetic speech-like chunks of 0.5 s, the second with a
    stretch of white noise (unvoiced frames for prosody). Not silence:
    the windowed mean of the gammatone power is a difference of running
    sums on both sides, which leaves only rounding noise in a near-silent
    stretch after a loud one."""
    x = next(iter(JaxBatcher(2, 8000, seed=0)))["chunk"].copy()
    x[1, 3000:5000] = np.random.RandomState(1).randn(2000) * 0.05
    return x


def _transform(name):
    with open(WORKERS) as f:
        cfg = json.load(f)
    return next(e for e in cfg["regr"] if e["name"] == name).get("transform")


@pytest.mark.parametrize("name", TARGETS)
def test_worker_target_matches_jax(wav, name):
    tcfg = _transform(name)
    want = np.asarray(jax.jit(jax_features.feature_fn_for_worker(
        name, tcfg))(jnp.asarray(wav)))
    got = features.feature_fn_for_worker(name, tcfg)(
        torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (
        2, 50, features.feature_dim_for_worker(name, tcfg))
    assert rel_err(got, want) <= REL, rel_err(got, want)
    if name == "prosody":
        np.testing.assert_array_equal(got[..., 1], want[..., 1])
        assert 0 < got[..., 1].sum() < got[..., 1].size


def test_stft_mag_matches_jax(wav):
    for n_fft, win in ((2048, 400), (512, 512)):
        want = np.asarray(jax_signal.stft_mag(jnp.asarray(wav), n_fft, 160,
                                              win, use_matmul=False))
        got = signal.stft_mag(torch.from_numpy(wav), n_fft, 160, win).numpy()
        assert got.shape == want.shape
        assert rel_err(got, want) <= 1e-5, (n_fft, win)


@pytest.mark.parametrize("win,hop,n_frames", [(400, 160, 30), (2048, 160, 5),
                                               (160, 160, 12)])
def test_framed_box_mean_matches_jax(win, hop, n_frames):
    x = np.random.RandomState(win).randn(2, 2000, 3).astype(np.float32)
    want = np.asarray(jax_signal.framed_box_mean_ntc(jnp.asarray(x), win,
                                                     hop, n_frames))
    got = signal.framed_box_mean_ntc(torch.from_numpy(x), win, hop,
                                     n_frames).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("pad_end", [False, True])
def test_frame_signal_matches_jax(pad_end):
    x = np.arange(2 * 1001, dtype=np.float32).reshape(2, 1001)
    want = np.asarray(jax_signal.frame_signal(jnp.asarray(x), 400, 160,
                                              pad_end=pad_end))
    got = signal.frame_signal(torch.from_numpy(x), 400, 160,
                              pad_end=pad_end).numpy()
    np.testing.assert_array_equal(got, want)


def test_add_deltas_matches_jax():
    x = np.random.RandomState(3).randn(2, 23, 5).astype(np.float32)
    want = np.asarray(jax_features.add_deltas(jnp.asarray(x)))
    got = features.add_deltas(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_constant_matrices_equal_jax():
    pairs = [
        (features.mel_filterbank(16000, 400, 128, 0.0, 8000.0),
         jax_features.mel_filterbank(16000, 400, 128, 0.0, 8000.0)),
        (features.psf_mel_filterbank(16000, 512, 40),
         jax_features.psf_mel_filterbank(16000, 512, 40)),
        (features.dct_matrix(13, 128), jax_features.dct_matrix(13, 128)),
        (features.hann_window(400), jax_features.hann_window(400)),
        (features.gammatone_fir_bank(16000, 40, 500.0),
         jax_features.gammatone_fir_bank(16000, 40, 500.0)),
        (features._delta_matrix(30, 2), jax_features._delta_matrix(30, 2)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got, want)


def test_feature_dims_match_jax():
    with open(WORKERS) as f:
        regr = json.load(f)["regr"]
    for e in regr:
        assert features.feature_dim_for_worker(e["name"], e.get(
            "transform")) == jax_features.feature_dim_for_worker(
            e["name"], e.get("transform")), e["name"]
    assert features.feature_fn_for_worker("mi") is None


@pytest.mark.parametrize("with_stats", [False, True])
def test_prepare_matches_jax(wav, with_stats):
    """make_prepare_fn without distortions: cchunk is the chunk, every
    target from it, ZNorm'd with a stats dict."""
    stats = None
    if with_stats:
        rng = np.random.RandomState(5)
        stats = {n: {"mean": rng.randn(features.feature_dim_for_worker(
            n, _transform(n))).astype(np.float32),
            "std": rng.uniform(0.5, 2.0, features.feature_dim_for_worker(
                n, _transform(n))).astype(np.float32)}
            for n in ("fbank", "prosody")}
    raw = {"chunk": wav, "chunk_ctxt": wav[::-1].copy(),
           "chunk_rand": -wav}
    want = jax.jit(jax_pipeline.make_prepare_fn(
        jax_parse_workers(WORKERS), stats=stats))(
        {k: jnp.asarray(v) for k, v in raw.items()}, jax.random.PRNGKey(0))
    got = pipeline.make_prepare_fn(parse_workers_cfg(WORKERS), stats=stats)(
        {k: torch.from_numpy(v) for k, v in raw.items()})
    assert set(got) == set(want)
    for k in got:
        assert rel_err(got[k].numpy(), np.asarray(want[k])) <= REL, k
    np.testing.assert_array_equal(got["cchunk"].numpy(), wav)


def test_prepare_refuses_distortions():
    """The rows a batch's dist_mask (0) or zs_mask (1) excludes are not
    distorted (overlap label 0), the other rows are; an explicit clean
    chunk is the cchunk; int16 waveforms are divided by 32768."""
    from pase_tpu_torch.data.distortions import (DistortionAssets,
                                                 DistortionConfig)
    prepare = pipeline.make_prepare_fn(
        {"regr": [], "cls": [{"name": "overlap"}]},
        dist_cfg=DistortionConfig(clip_p=1.0), assets=DistortionAssets())
    rng = np.random.RandomState(0)
    wav = torch.from_numpy(rng.randn(2, 4800).astype(np.float32) * 0.1)
    raw = {"chunk": wav, "chunk_ctxt": wav, "chunk_rand": wav}
    for mask in ({"dist_mask": torch.tensor([0.0, 1.0])},
                 {"zs_mask": torch.tensor([1.0, 0.0])}):
        out = prepare({**raw, **mask}, torch.Generator().manual_seed(1))
        assert torch.equal(out["chunk"][0], wav[0])
        assert not torch.equal(out["chunk"][1], wav[1])
        assert (out["overlap"][0] == 0).all()
    clean = wav * 0.5
    gen = torch.Generator().manual_seed(2)
    assert prepare({**raw, "cchunk": clean}, gen)["cchunk"] is clean
    pcm = torch.from_numpy(rng.randint(-32768, 32767, (2, 4800)).astype(
        np.int16))
    out = prepare({**raw, "chunk_ctxt": pcm}, gen)
    assert torch.equal(out["chunk_ctxt"], pcm.float() / 32768)


def test_stats_pkl_round_trip(tmp_path):
    stats = {"mfcc": {"mean": np.arange(39, dtype=np.float32),
                      "std": np.ones(39, np.float32)}}
    jax_pipeline.save_stats_pkl(stats, str(tmp_path / "s.pkl"))
    got = pipeline.load_stats_pkl(str(tmp_path / "s.pkl"))
    np.testing.assert_array_equal(got["mfcc"]["mean"], stats["mfcc"]["mean"])
    assert got["mfcc"]["std"].dtype == np.float32


def _peak_hz(x, sr=16000):
    spec = np.abs(np.fft.rfft(x, axis=-1))
    spec[:, : int(60 * x.shape[-1] / sr)] = 0
    return spec.argmax(axis=-1) * sr / x.shape[-1]


def test_device_batcher_has_the_synthetic_statistics():
    """The device batcher draws the numpy batcher's signal family: the
    same level, a fundamental in [80, 260) Hz shared by chunk and
    chunk_ctxt, and fresh draws each batch."""
    dev = DeviceSyntheticBatcher(16, 16000, seed=1, device="cpu")
    host = JaxBatcher(16, 16000, seed=1)
    a, b = dev.make_batch(), dev.make_batch()
    ref = next(iter(host))
    for k in ("chunk", "chunk_ctxt", "chunk_rand"):
        x = a[k]
        assert x.shape == (16, 16000) and x.dtype == torch.float32
        assert x.device.type == "cpu" and bool(torch.isfinite(x).all())
        assert abs(x.mean().item()) < 0.01
        assert x.std().item() == pytest.approx(float(ref[k].std()), rel=0.2)
    f_chunk = _peak_hz(a["chunk"].numpy())
    f_ctxt = _peak_hz(a["chunk_ctxt"].numpy())
    assert np.all((f_chunk >= 79) & (f_chunk <= 261))
    np.testing.assert_allclose(f_chunk, f_ctxt, atol=2.0)
    assert not torch.equal(a["chunk"], b["chunk"])
    again = DeviceSyntheticBatcher(16, 16000, seed=1, device="cpu")
    assert torch.equal(again.make_batch()["chunk"], a["chunk"])
