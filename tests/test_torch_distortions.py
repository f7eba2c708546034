"""The port's distortion stack (pase_tpu_torch.data.distortions), its batch
preparation with distortions and its trainset statistics
(pase_tpu_torch.data.pipeline), and ``--dtrans_cfg`` of the training CLI,
against the JAX package on the CPU.

JAX's random streams cannot be reproduced in torch, so ``jax_draws``
rebuilds every draw the JAX ``apply_distortions`` takes from its key (the
same ``jax.random`` calls in the same split order) and hands them to the
port's deterministic ``apply_distortions``.

Bounds: stages through an FFT (reverb, overlap, noise, resample, bandrop,
downsample) and speed within 1e-5 of max|out| (float32 FFTs and sums in
another order); clip and chop exactly equal; the overlap label (a mean
of 160 zeros and ones) within 1e-7, one float32 rounding of the mean;
prepared targets within 1e-4 of their largest value (as
tests/test_torch_features.py); statistics within 1e-4 of their largest
value."""

import glob
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pase_tpu.data import distortions as JD
from pase_tpu.data import pipeline as jax_pipeline
from pase_tpu.data.dataset import SyntheticChunkBatcher as JaxBatcher
from pase_tpu.data.io import write_wav as jax_write_wav
from pase_tpu.model import parse_workers_cfg as jax_parse_workers
from pase_tpu_torch.data import distortions as D
from pase_tpu_torch.data import pipeline
from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
from pase_tpu_torch.data.io import write_wav
from pase_tpu_torch.model import parse_workers_cfg
from torch_port_common import rel_err
from torch_port_common import port_test_guard  # noqa: F401

B, T = 2, 4800
FFT_REL = 1e-5
REL = 1e-4
LABEL_ATOL = 1e-7


def _speech(b=B, t=T, seed=0):
    """Speech-like rows; row 1 has a near-silent stretch, which the chop
    stage's energy VAD marks as non-speech."""
    x = next(iter(JaxBatcher(b, t, seed=seed)))["chunk"].copy()
    x[1 % b, 2000:3000] = np.random.RandomState(1).randn(1000) * 1e-4
    return x


def _assets(t=T):
    rng = np.random.RandomState(0)
    ir = (rng.randn(2, 500) * np.exp(-np.arange(500) / 60.0) * 0.2
          ).astype(np.float32)
    ir[0, 0] = 1.0
    ir[1, 20] = 1.5                     # a delayed peak: pmax 20
    bandrop = rng.randn(2, 65).astype(np.float32)
    bandrop[1, 33:] = 0.0               # a shorter filter, zero-padded
    return D.DistortionAssets(
        ir_bank=torch.from_numpy(ir),
        ir_pmax=torch.from_numpy(np.argmax(np.abs(ir), 1).astype(np.int32)),
        noise_bank=torch.from_numpy(rng.randn(3, 2 * t).astype(np.float32)
                                    * 0.1),
        overlap_bank=torch.from_numpy(rng.randn(2, 2 * t).astype(np.float32)
                                      * 0.1),
        bandrop_bank=torch.from_numpy(bandrop),
        bandrop_lens=torch.tensor([65, 33], dtype=torch.int32),
        downsample_bank=torch.from_numpy(rng.randn(1, 101).astype(
            np.float32)),
        resample_filters=D.build_resample_filters((2, 4)))


def _jax_assets(assets):
    return JD.DistortionAssets(*(None if a is None else jnp.asarray(a.numpy())
                                 for a in assets))


def _jax_cfg(cfg):
    return JD.DistortionConfig(**cfg._asdict())


def jax_draws(key, b, t, cfg, assets):
    """The draws of the JAX ``apply_distortions(wav [b, t], key, cfg, ...)``
    as the port's ``DistortionDraws``: per-sample stage keys from
    ``split(key, b * 10).reshape(b, 10, 2)``, each stage's inner splits,
    and the gate ``uniform(fold_in(stage key, 7))``."""
    r = jax.random
    keys = r.split(key, b * 10).reshape(b, 10, 2)
    on = D.enabled_stages(cfg, assets)

    def per_sample(si, fn):
        return np.asarray(jax.vmap(fn)(keys[:, si]))

    d = {"gate": np.stack([per_sample(si, lambda k: r.uniform(r.fold_in(k, 7)))
                           for si in range(len(D.STAGES))], 1)}
    si = {s: i for i, s in enumerate(D.STAGES)}
    if on["reverb"]:
        n_ir = assets.ir_bank.shape[0]
        d["reverb_ir"] = per_sample(si["reverb"],
                                    lambda k: r.randint(k, (), 0, n_ir))
    if on["overlap"]:
        n_ov, nlen = assets.overlap_bank.shape
        limits = [(0, int(0.75 * t)), (0, n_ov), (0, max(nlen - t, 1)),
                  (0, len(cfg.overlap_snrs))]
        if cfg.overlap_reverb and assets.ir_bank is not None:
            limits.append((0, assets.ir_bank.shape[0]))
        names = ["overlap_shift", "overlap_row", "overlap_beg", "overlap_snr",
                 "overlap_ir"]
        for n, (i, (lo, hi)) in zip(names, enumerate(limits)):
            d[n] = per_sample(si["overlap"], lambda k, i=i, lo=lo, hi=hi:
                              r.randint(r.split(k, 5)[i], (), lo, hi))
    if on["noises"]:
        n_noise, nlen = assets.noise_bank.shape
        limits = [(0, n_noise), (0, max(nlen - t, 1)),
                  (0, len(cfg.noises_snrs))]
        for n, (i, (lo, hi)) in zip(["noise_row", "noise_beg", "noise_snr"],
                                    enumerate(limits)):
            d[n] = per_sample(si["noises"], lambda k, i=i, lo=lo, hi=hi:
                              r.randint(r.split(k, 3)[i], (), lo, hi))
    if on["speed"]:
        lo, hi = cfg.speed_range
        d["speed_warp"] = per_sample(si["speed"], lambda k: r.uniform(
            k, (), minval=lo, maxval=hi))
    if on["resample"]:
        d["resample_factor"] = per_sample(si["resample"], lambda k: r.randint(
            k, (), 0, len(cfg.resample_factors)))
    if on["clip"]:
        d["clip_factor"] = per_sample(si["clip"], lambda k: r.randint(
            k, (), 0, len(cfg.clip_factors)))
    if on["chop"]:
        m, nf = int(cfg.max_chops), t // D.VAD_WIN
        d["chop_n"] = per_sample(si["chop"], lambda k: r.randint(
            r.split(k, 4)[0], (), 1, m + 1))
        d["chop_u"] = per_sample(si["chop"], lambda k: r.uniform(
            r.split(k, 4)[1], (nf,), minval=1e-6, maxval=1 - 1e-6))
        d["chop_factor"] = per_sample(si["chop"], lambda k: r.randint(
            r.split(k, 4)[2], (m,), 0, len(cfg.chop_factors)))
        d["chop_normal"] = per_sample(si["chop"], lambda k: r.normal(
            r.split(k, 4)[3], (m,)))
    for stage in ("bandrop", "downsample"):
        if on[stage]:
            n_f = getattr(assets, f"{stage}_bank").shape[0]
            d[f"{stage}_filter"] = per_sample(si[stage], lambda k, n=n_f:
                                              r.randint(k, (), 0, n))
    return D.DistortionDraws(**{
        k: torch.from_numpy(np.array(v)).to(
            torch.float32 if v.dtype.kind == "f" else torch.long)
        for k, v in d.items()})


_jax_apply = jax.jit(JD.apply_distortions, static_argnums=(2, 4))

STAGE_CFGS = {
    "reverb": dict(reverb_p=1.0),
    "overlap": dict(overlap_p=1.0, overlap_snrs=(5.0, 7.5, 10.0)),
    "overlap_reverb": dict(overlap_p=1.0, overlap_reverb=True),
    "noises": dict(noises_p=1.0),
    "speed_slow": dict(speed_p=1.0, speed_range=(0.05, 0.15)),
    "speed_fast": dict(speed_p=1.0, speed_range=(-0.15, -0.05)),
    "resample": dict(resample_p=1.0, resample_factors=(2, 4)),
    "clip": dict(clip_p=1.0),
    "chop": dict(chop_p=1.0, chop_factors=((0.05, 0.025), (0.1, 0.05))),
    "bandrop": dict(bandrop_p=1.0),
    "downsample": dict(downsample_p=1.0),
}
EVERY = dict(reverb_p=1.0, overlap_p=1.0, overlap_reverb=True, noises_p=1.0,
             speed_p=1.0, speed_range=(-0.1, 0.1), resample_p=1.0,
             resample_factors=(2, 4), clip_p=1.0, chop_p=1.0, bandrop_p=1.0,
             downsample_p=1.0)
STAGE_CFGS["all"] = EVERY
STAGE_CFGS["all_gated"] = {k: (0.5 if k.endswith("_p") else v)
                           for k, v in EVERY.items()}


def _both(cfg, assets, wav, seed):
    key = jax.random.PRNGKey(seed)
    want_y, want_m = _jax_apply(jnp.asarray(wav), key, _jax_cfg(cfg),
                                _jax_assets(assets), 160)
    draws = jax_draws(key, wav.shape[0], wav.shape[1], cfg, assets)
    got_y, got_m = D.apply_distortions(torch.from_numpy(wav), draws, cfg,
                                       assets, 160)
    return (got_y.numpy(), got_m.numpy(), np.asarray(want_y),
            np.asarray(want_m), draws)


@pytest.mark.parametrize("stage", sorted(STAGE_CFGS))
def test_stage_matches_jax_given_its_draws(stage):
    cfg = D.DistortionConfig(**STAGE_CFGS[stage])
    wav = _speech()
    got, got_m, want, want_m, draws = _both(cfg, _assets(), wav, seed=3)
    assert got.shape == want.shape == wav.shape
    assert got_m.shape == want_m.shape == (B, T // 160)
    if stage in ("clip", "chop"):
        np.testing.assert_array_equal(got, want)
    else:
        assert rel_err(got, want) <= FFT_REL, rel_err(got, want)
    np.testing.assert_allclose(got_m, want_m, rtol=0, atol=LABEL_ATOL)
    gated = (draws.gate.numpy() < 0.5).any() if stage == "all_gated" else 1
    assert gated and np.abs(got - wav).max() > 1e-3, "nothing distorted"
    if stage.startswith("overlap"):
        assert (got_m[:, -1] == 1).all()
        assert (np.diff(got_m, axis=1) >= 0).all()


def test_chop_zeroes_speech_and_skips_silence():
    """Chopped samples are zero and the rest untouched; a row without
    speech frames (below -55 dB) stays as it is."""
    cfg = D.DistortionConfig(**STAGE_CFGS["chop"])
    wav = _speech()
    wav[1] = 1e-6
    got, _, want, _, _ = _both(cfg, _assets(), wav, seed=4)
    np.testing.assert_array_equal(got, want)
    cut = got != wav
    assert cut[0].any() and (got[cut] == 0).all()
    np.testing.assert_array_equal(got[1], wav[1])


def test_config_from_json_matches_jax_on_every_repo_cfg():
    paths = sorted(glob.glob("cfg/distortions/*.cfg"))
    assert len(paths) >= 10
    for path in paths:
        with open(path) as f:
            js = json.load(f)
        assert D.config_from_json(js)._asdict() == \
            JD.config_from_json(js)._asdict(), path


def test_config_from_json_rejects_unknown_keys():
    with pytest.raises(ValueError, match="unknown distortion cfg keys"):
        D.config_from_json({"reverb_p": 0.5, "chop_factros": [[0.05, 0.025]]})


def test_asset_loaders_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    irs = [rng.randn(n).astype(np.float32) for n in (300, 120, 40)]
    irs[1] = -np.abs(irs[1])            # no positive peak: left unscaled
    for i, ir in enumerate(irs[:2]):
        np.save(tmp_path / f"ir{i}.npy", ir)
    np.savetxt(tmp_path / "ir2.txt", irs[2])
    write_wav(str(tmp_path / "ir3.wav"), irs[0] * 0.1)
    for files, fmt in ((["ir0.npy", "ir1.npy"], "npy"), (["ir2.txt"], "txt"),
                       (["ir3.wav"], "wav")):
        got = D.load_ir_bank(files, str(tmp_path), fmt, max_len=200)
        want = JD.load_ir_bank(files, str(tmp_path), fmt, max_len=200)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    wavs = []
    for i, n in enumerate((5000, 1700)):
        wavs.append(str(tmp_path / f"n{i}.wav"))
        jax_write_wav(wavs[-1], rng.randn(n) * 0.2)
    np.testing.assert_array_equal(D.load_wav_bank(wavs, 4000).numpy(),
                                  np.asarray(JD.load_wav_bank(wavs, 4000)))
    np.testing.assert_array_equal(
        D.build_resample_filters((2, 3, 4)).numpy(),
        np.asarray(JD.build_resample_filters((2, 3, 4))))


def test_draws_have_the_stack_statistics():
    """The port's own draws: gate rates within 5 sigma of p, noise added at
    the drawn SNR with the input energy kept, the overlap label a step up
    to 1 at the onset."""
    b = 1024
    wav = torch.from_numpy(_speech(b, T, seed=5))
    assets = _assets()
    cfg = D.DistortionConfig(reverb_p=0.5, overlap_p=0.1, noises_p=0.4,
                             clip_p=0.2, chop_p=0.2)
    gen = torch.Generator().manual_seed(0)
    draws = D.draw_distortions(gen, b, T, cfg, assets)
    for stage, p in (("reverb", 0.5), ("overlap", 0.1), ("noises", 0.4),
                     ("clip", 0.2), ("chop", 0.2)):
        rate = (draws.gate[:, D.STAGES.index(stage)] < p).float().mean()
        assert abs(rate.item() - p) <= 5 * (p * (1 - p) / b) ** 0.5, stage
    assert set(draws.noise_snr.tolist()) == {0, 1, 2}
    assert 0 <= draws.overlap_shift.min() and \
        draws.overlap_shift.max() < int(0.75 * T)

    only_noise = D.DistortionConfig(noises_p=1.0)
    d = D.draw_distortions(gen, b, T, only_noise, assets)
    y, _ = D.apply_distortions(wav, d, only_noise, assets)
    ex = (wav.double() ** 2).sum(1)
    torch.testing.assert_close((y.double() ** 2).sum(1), ex, rtol=1e-4,
                               atol=0)
    # split the output into the scaled clean part and the rest
    g = (y.double() * wav.double()).sum(1) / ex
    noise = y.double() - g[:, None] * wav.double()
    snr = 10 * torch.log10(g ** 2 * ex / (noise ** 2).sum(1))
    want = torch.tensor(cfg.noises_snrs, dtype=torch.float64)[d.noise_snr]
    assert (snr - want).abs().max() < 0.5

    only_overlap = D.DistortionConfig(overlap_p=1.0)
    d = D.draw_distortions(gen, b, T, only_overlap, assets)
    y, mask = D.apply_distortions(wav, d, only_overlap, assets)
    torch.testing.assert_close((y.double() ** 2).sum(1), ex, rtol=1e-4,
                               atol=0)
    assert (mask[:, -1] == 1).all() and (mask.diff(dim=1) >= 0).all()
    onset_frame = (d.overlap_shift // 160).long()
    assert (mask[torch.arange(b), onset_frame] > 0).all()


def _overlap_workers():
    """Two targets and an overlap worker: the label the port emits."""
    return {"regr": [{"name": "fbank"}, {"name": "prosody"}],
            "cls": [{"name": "overlap", "loss": "BCEWithLogitsLoss"}]}


def test_prepare_with_distortions_matches_jax():
    """Targets and cchunk from the clean chunk, the distorted chunk given
    the JAX prepare's own draws, and the overlap label."""
    wk = _overlap_workers()
    cfg = D.DistortionConfig(**STAGE_CFGS["all_gated"])
    assets = _assets()
    rng = np.random.RandomState(5)
    stats = {"fbank": {"mean": rng.randn(120).astype(np.float32),
                       "std": rng.uniform(0.5, 2, 120).astype(np.float32)}}
    wav = _speech()
    raw = {"chunk": wav, "chunk_ctxt": wav[::-1].copy(), "chunk_rand": -wav}
    key = jax.random.PRNGKey(9)
    want = jax.jit(jax_pipeline.make_prepare_fn(
        jax_parse_workers(wk), stats=stats, dist_cfg=_jax_cfg(cfg),
        assets=_jax_assets(assets)))(
        {k: jnp.asarray(v) for k, v in raw.items()}, key)
    k_dist = jax.random.split(key, 3)[1]
    draws = jax_draws(k_dist, B, T, cfg, assets)
    got = pipeline.make_prepare_fn(parse_workers_cfg(wk), stats=stats,
                                   dist_cfg=cfg, assets=assets)(
        {k: torch.from_numpy(v) for k, v in raw.items()}, draws=draws)
    assert set(got) == set(want) == {"chunk", "chunk_ctxt", "chunk_rand",
                                     "cchunk", "fbank", "prosody", "overlap"}
    np.testing.assert_array_equal(got["cchunk"].numpy(), wav)
    for k in ("fbank", "prosody", "chunk_ctxt", "chunk_rand"):
        assert rel_err(got[k].numpy(), np.asarray(want[k])) <= REL, k
    assert rel_err(got["chunk"].numpy(), np.asarray(want["chunk"])) <= \
        FFT_REL
    assert np.abs(got["chunk"].numpy() - wav).max() > 1e-3
    np.testing.assert_allclose(got["overlap"].numpy(),
                               np.asarray(want["overlap"]), rtol=0,
                               atol=LABEL_ATOL)


def test_prepare_draws_from_its_generator():
    """Without draws the prepare draws from the generator: the same seed
    gives the same distorted chunk; another seed another one."""
    cfg = D.DistortionConfig(**STAGE_CFGS["all_gated"])
    prepare = pipeline.make_prepare_fn(parse_workers_cfg(_overlap_workers()),
                                       dist_cfg=cfg, assets=_assets())
    raw = {k: torch.from_numpy(_speech()) for k in ("chunk", "chunk_ctxt",
                                                     "chunk_rand")}
    a, b_, c = (prepare(raw, torch.Generator().manual_seed(s))["chunk"]
                for s in (1, 1, 2))
    assert torch.equal(a, b_) and not torch.equal(a, c)


def test_compute_stats_matches_jax():
    wk = "cfg/workers/workers+.cfg"
    want = jax_pipeline.compute_stats(JaxBatcher(2, T, seed=11),
                                      jax_parse_workers(wk), max_batches=2)
    got = pipeline.compute_stats(SyntheticChunkBatcher(2, T, seed=11),
                                 parse_workers_cfg(wk), max_batches=2,
                                 device="cpu")
    assert set(got) == set(want) and len(got) == 9
    for k in want:
        for m in ("mean", "std"):
            assert got[k][m].shape == want[k][m].shape
            assert rel_err(got[k][m], want[k][m]) <= REL, (k, m)


def test_stats_pkl_written_by_the_port_loads_in_jax(tmp_path):
    stats = {"mfcc": {"mean": np.arange(39, dtype=np.float32),
                      "std": np.ones(39, np.float32)}}
    pipeline.save_stats_pkl(stats, str(tmp_path / "s.pkl"))
    got = jax_pipeline.load_stats_pkl(str(tmp_path / "s.pkl"))
    np.testing.assert_array_equal(got["mfcc"]["mean"], stats["mfcc"]["mean"])


def _write_cfg(tmp_path, **extra):
    """A distortion cfg with every asset kind, written under tmp_path."""
    rng = np.random.RandomState(3)
    (tmp_path / "irs").mkdir()
    for i in range(2):
        ir = rng.randn(300).astype(np.float32) * np.exp(-np.arange(300) / 40)
        np.save(tmp_path / "irs" / f"ir{i}.npy", ir)
    for d in ("noise", "ov"):
        (tmp_path / d).mkdir()
        for i in range(2):
            write_wav(str(tmp_path / d / f"{i}.wav"), rng.randn(7000) * 0.1)
    with open(tmp_path / "ov.lst", "w") as f:
        f.write("0.wav\n1.wav\n")
    np.save(tmp_path / "filt.npy", rng.randn(65).astype(np.float32))
    js = {"reverb_data_root": str(tmp_path / "irs"), "reverb_fmt": "npy",
          "reverb_p": 0.5, "noises_dir": [str(tmp_path / "noise")],
          "noises_snrs": [0, 5, 10], "noises_p": 0.5,
          "overlap_dir": str(tmp_path / "ov"),
          "overlap_list": str(tmp_path / "ov.lst"), "overlap_p": 0.5,
          "overlap_reverb": True, "clip_factors": [0.1, 0.3, 0.5],
          "clip_p": 0.5, "chop_factors": [[0.05, 0.025]], "chop_p": 0.5,
          "bandrop_data_root": str(tmp_path), "bandrop_irfiles": ["filt.npy"],
          "bandrop_p": 0.5, "resample_factors": [2], "resample_p": 0.5,
          **extra}
    path = tmp_path / "dist.cfg"
    path.write_text(json.dumps(js))
    return str(path), js


def test_build_distortions_loads_every_asset(tmp_path):
    from pase_tpu_torch import train as port_train
    path, js = _write_cfg(tmp_path)
    opts = port_train.build_argparser().parse_args(
        ["--dtrans_cfg", "None", "--dtrans_cfg", path])
    cfg, assets = port_train.build_distortions(opts, 3000)
    assert cfg == D.config_from_json(js)
    on = D.enabled_stages(cfg, assets)
    assert [s for s in D.STAGES if on[s]] == [
        "reverb", "overlap", "noises", "resample", "clip", "chop", "bandrop"]
    assert tuple(assets.noise_bank.shape) == (2, 6000)
    assert tuple(assets.overlap_bank.shape) == (2, 6000)
    assert tuple(assets.ir_bank.shape) == (2, 300)
    opts = port_train.build_argparser().parse_args(["--dtrans_cfg", "None"])
    assert port_train.build_distortions(opts, 3000) == (None, None)


def test_host_distortion_stage_refuses(tmp_path):
    from pase_tpu_torch import train as port_train
    path, _ = _write_cfg(tmp_path, codec2_p=0.3)
    opts = port_train.build_argparser().parse_args(["--dtrans_cfg", path])
    with pytest.raises(NotImplementedError, match="ROADMAP.*host distortion"):
        port_train.build_distortions(opts, 3000)


def test_train_cli_with_dtrans_cfg(tmp_path, monkeypatch):
    """python -m pase_tpu_torch.train --synthetic --device cpu --dtrans_cfg
    at a tiny size: two steps and one eval batch, every logged loss
    finite, the encoder checkpoint written."""
    from pase_tpu_torch import train as port_train
    from test_torch_train import SMALL_FE, small_workers
    path, _ = _write_cfg(tmp_path)
    for name, cfg in (("fe.cfg", SMALL_FE), ("wk.cfg", small_workers())):
        (tmp_path / name).write_text(json.dumps(cfg))
    monkeypatch.setattr(port_train, "SYNTHETIC_BPE", 2)
    out = tmp_path / "run"
    tr = port_train.main([
        "--synthetic", "--device", "cpu", "--net_cfg",
        str(tmp_path / "wk.cfg"), "--fe_cfg", str(tmp_path / "fe.cfg"),
        "--batch_size", "2", "--chunk_size", "4800", "--epoch", "1",
        "--log_freq", "1", "--save_path", str(out), "--dtrans_cfg", path])
    assert tr.step == 2
    with open(out / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["split"] for r in recs] == ["train", "train", "perf", "eval"]
    for r in recs:
        assert all(np.isfinite(v) for k, v in r.items()
                   if isinstance(v, float)), r
    assert (out / "FE_e0.npz").is_file()


def test_overlap_head_still_refuses():
    """The prepare emits the overlap label, and the head that reads it is
    ported now (an MLP on the chunk stream, held to the JAX step by
    tests/test_torch_overlap.py): the bank builds with it, and with the
    contrastive heads beside it, SPC and Gap (tests/test_torch_spc_gap.py).
    A dropin MLP head still refuses, naming its ROADMAP item."""
    from pase_tpu_torch.model import build_pase
    from torch_port_common import NARROW_CFG
    wk = {"regr": [], "cls": [dict(_overlap_workers()["cls"][0],
                                   num_outputs=1)]}
    model, _ = build_pase(NARROW_CFG, wk)
    assert "overlap" in model.workers
    heads = [dict(wk["cls"][0], name=name) for name in ("spc", "gap")]
    model, _ = build_pase(NARROW_CFG, dict(wk, cls=wk["cls"] + heads))
    assert {"overlap", "spc", "gap"} <= set(model.workers)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md, queue 1: off-path"):
        build_pase(NARROW_CFG,
                   dict(wk, cls=[dict(wk["cls"][0], name="mi",
                                      dropin=0.5)]))
