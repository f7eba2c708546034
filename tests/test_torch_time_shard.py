"""The port's time-sharded encoder (pase_tpu_torch/parallel/sp.py) against
the JAX package's (pase_tpu/parallel/sp.py) and against the port's
offline forward, on the CPU: D shards on ["cpu"] * D (the port's
controller takes a list of devices, repeats allowed), the JAX side on a
D-device slice of the 8-device CPU mesh of tests/conftest.py, the same
weights (tests/torch_port_common.py's randomized BatchNorm and PReLU
state).

Bounds are JAX's (tests/test_sequence_parallel.py): the sharded forward
within atol = rtol = 2e-5 of the offline one and of JAX's sharded
forward; gradients of a fixed linear loss within atol 1e-5, rtol 1e-4 of
the offline gradients.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pase_tpu import frontend as jax_frontend
from pase_tpu.parallel import sp as jax_sp
from pase_tpu.parallel.mesh import get_mesh
from pase_tpu_torch import frontend, serving
from pase_tpu_torch.checkpoint import variables_to_state_dict
from pase_tpu_torch.data.io import write_wav
from pase_tpu_torch.parallel import sp
from torch_port_common import (NARROW_CFG, PASEP_CFG, flat_variables,
                               jax_variables)
from torch_port_common import port_test_guard  # noqa: F401

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
# tests/test_sequence_parallel.py's narrow cfgs
CFGS = {
    "two_layers": {"kwidths": [65, 10, 5, 5], "strides": [1, 10, 4, 4],
                   "fmaps": [16, 16, 32, 32], "emb_dim": 32,
                   "norm_out": True, "rnn_pool": True, "rnn_dim": 32,
                   "rnn_layers": 2, "denseskips": True},
    "grad": {"kwidths": [65, 10, 4, 4], "strides": [1, 10, 4, 4],
             "fmaps": [16, 16, 24, 24], "emb_dim": 24, "norm_out": True,
             "rnn_pool": True, "rnn_dim": 24, "denseskips": True},
    "resblocks": {"kwidths": [65, 21, 11, 11], "strides": [1, 10, 4, 4],
                  "fmaps": [16, 16, 24, 24], "emb_dim": 24,
                  "norm_out": True, "rnn_pool": True, "rnn_dim": 24,
                  "denseskips": True, "resblocks": True, "vq_K": 16},
    "vq": {"kwidths": [65, 10, 4, 4], "strides": [1, 10, 4, 4],
           "fmaps": [16, 16, 24, 24], "emb_dim": 24, "rnn_pool": True,
           "rnn_dim": 24, "vq_K": 16},
}


def _pair(cfg, t, seed=0):
    """(JAX module, its variables, the port's WaveFe with them, eval)."""
    cfg = jax_frontend.load_cfg(cfg)
    jm = jax_frontend.build_wavefe(dict(cfg, qrnn_impl="scan"))
    variables = jax_variables(jm, t, seed=seed)
    port = frontend.build_wavefe(cfg).eval()
    sd = variables_to_state_dict(flat_variables(variables))
    port.load_state_dict(dict(port.state_dict(), **sd), strict=True)
    return jm, variables, port


def _length(module, D):
    """tests/test_sequence_parallel.py's T: D x 3200, or longer where the
    halo needs it, on the D x 160 grid."""
    H = sp.time_shard_halo(module)
    T = D * max(3200, 2 * H // max(D - 1, 1) + 320)
    return (T // (D * 160)) * (D * 160)


def _jax_sharded(jm, variables, wav, D):
    mesh = get_mesh(devices=jax.devices()[:D])
    fn = jax.jit(lambda v, x: jax_sp.time_sharded_apply(jm, v, x, mesh))
    return np.asarray(jax.device_get(fn(variables, jnp.asarray(wav))))


@pytest.mark.parametrize("name", ["pase_plus", "narrow"] + sorted(CFGS))
def test_time_shard_halo_equals_jax(name):
    cfg = {"pase_plus": PASEP_CFG, "narrow": NARROW_CFG}.get(name,
                                                              CFGS.get(name))
    want = jax_sp.time_shard_halo(jax_frontend.build_wavefe(
        jax_frontend.load_cfg(cfg)))
    got = sp.time_shard_halo(frontend.build_wavefe(cfg))
    assert got == want
    assert serving.time_shard_halo is sp.time_shard_halo
    if name == "pase_plus":
        assert got == 2560


def test_pase_plus_full_width_matches_jax_and_offline():
    D, T = 4, 16000
    jm, variables, port = _pair(PASEP_CFG, T, seed=2)
    wav = (np.random.RandomState(0).randn(2, T) * 0.2).astype(np.float32)
    got = sp.encode_time_sharded(port, wav, ["cpu"] * D).numpy()
    want = _jax_sharded(jm, variables, wav, D)
    with torch.no_grad():
        offline = port(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == offline.shape == (2, 100, 256)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, offline, **TOL)


@pytest.mark.parametrize("name", ["two_layers", "resblocks", "vq"])
def test_narrow_cfgs_match_offline_and_jax(name):
    """Two QRNN layers (the boundary frame across shards), the residual
    trunk with VQ, VQ's straight-through forward; D = 4."""
    D = 4
    probe = frontend.build_wavefe(CFGS[name])
    T = _length(probe, D)
    jm, variables, port = _pair(CFGS[name], T, seed=1)
    wav = (np.random.RandomState(3).randn(1, T) * 0.2).astype(np.float32)
    got = sp.encode_time_sharded(port, wav, ["cpu"] * D).numpy()
    with torch.no_grad():
        offline = port(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, offline, **TOL)
    np.testing.assert_allclose(got, _jax_sharded(jm, variables, wav, D),
                               **TOL)


@pytest.mark.parametrize("name", ["grad", "vq", "two_layers"])
def test_gradients_match_offline(name):
    """Gradients of a fixed linear loss through the sharded forward (the
    carry's dc0 through the seeded pass, the window slices, the
    straight-through VQ) against the offline forward's."""
    D = 4
    port = frontend.build_wavefe(CFGS[name],
                                 torch.Generator().manual_seed(5)).eval()
    T = _length(port, D)
    rng = np.random.RandomState(2)
    wav = torch.from_numpy((rng.randn(1, T) * 0.2).astype(np.float32))
    w = torch.from_numpy(rng.randn(1, T // 160, port.output_dim).astype(
        np.float32))
    params = [p for p in port.parameters()]

    def grads(y):
        return torch.autograd.grad((y * w).mean(), params, allow_unused=True)

    g_sp = grads(sp.time_sharded_apply(port, wav, ["cpu"] * D))
    g_off = grads(port(wav))
    assert port.training is False
    n = 0
    for (k, _), a, b in zip(port.named_parameters(), g_sp, g_off):
        if b is None:
            assert a is None or not a.any(), k
            continue
        n += 1
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=k,
                                   **GRAD_TOL)
    assert n > 10


def test_one_shard_is_the_offline_forward():
    port = frontend.build_wavefe(CFGS["two_layers"]).eval()
    wav = torch.from_numpy((np.random.RandomState(4).randn(2, 4800) * 0.2)
                           .astype(np.float32))
    got = sp.encode_time_sharded(port, wav, ["cpu"])
    with torch.no_grad():
        np.testing.assert_allclose(got.numpy(), port(wav).numpy(), **TOL)


@pytest.mark.parametrize("case", ["divide", "too_short", "inorm",
                                  "inorm_out", "lstm", "tdnn",
                                  "even_resblock"])
def test_guards_are_jaxs(case):
    D = 4
    narrow = {"kwidths": [65, 10, 4, 4], "strides": [1, 10, 4, 4],
              "fmaps": [16, 16, 24, 24], "emb_dim": 24}
    err, match, cfg, T = ValueError, None, narrow, D * 3200
    if case == "divide":
        cfg, T, match = PASEP_CFG, D * 160 + 1, "divide"
    elif case == "too_short":
        cfg, T, match = PASEP_CFG, D * 160, "too short"
    elif case == "inorm":
        cfg = dict(narrow, norm_type="inorm")
        err, match = NotImplementedError, "InstanceNorm"
    elif case == "inorm_out":
        cfg = dict(narrow, norm_type="lnorm", norm_out=True)
        err, match = NotImplementedError, "InstanceNorm norm_out"
    elif case == "lstm":
        cfg = dict(narrow, rnn_pool=True, rnn_type="lstm", rnn_dim=24)
        err, match = NotImplementedError, "rnn_type='lstm'"
    elif case == "tdnn":
        cfg = "cfg/frontend/TDNN.cfg"
        err, match = TypeError, "WaveFe"
    else:
        # the port's FeResBlock refuses an even kwidth when it is built;
        # JAX's time_shard_halo refuses the trunk
        cfg = {"kwidths": [65, 20, 11, 11], "strides": [1, 10, 4, 4],
               "fmaps": [16, 16, 24, 24], "emb_dim": 24, "resblocks": True}
        with pytest.raises(ValueError, match="even"):
            frontend.build_wavefe(cfg)
        with pytest.raises(ValueError, match="even resblock"):
            jax_sp.time_shard_halo(jax_frontend.build_wavefe(cfg))
        return
    module = frontend.build_frontend_module(cfg).eval()
    with pytest.raises(err, match=match):
        sp.encode_time_sharded(module, np.zeros((1, T), np.float32),
                               ["cpu"] * D)


@pytest.mark.parametrize("n", [32000, 30001])
def test_forward_chunk_time_shard_writes_the_offline_frames(tmp_path, n):
    """forward-chunk --time_shard --device cpu (D = 1: the CPU once): the
    wav zero-padded to the 160 grid, one forward, the frames trimmed to
    len // 160; the same as the offline encoder on the padded wav."""
    from pase_tpu_torch import util_scripts as port_cli
    cfg = tmp_path / "fe.cfg"
    cfg.write_text(json.dumps(CFGS["two_layers"]))
    x = (np.random.RandomState(0).randn(n) * 0.1).astype(np.float32)
    write_wav(str(tmp_path / "a.wav"), x)
    port_cli.main(["forward-chunk", "--device", "cpu", "--time_shard",
                   "--fe_cfg", str(cfg), "--in_wav", str(tmp_path / "a.wav"),
                   "--out_file", str(tmp_path / "a.npy")])
    got = np.load(tmp_path / "a.npy")
    from pase_tpu_torch.data.io import read_wav
    wav, _ = read_wav(str(tmp_path / "a.wav"))
    pad = -(-n // 160) * 160
    enc = frontend.wf_builder(str(cfg), device="cpu")
    want = enc(np.pad(wav, (0, pad - n))[None, None])[0, :, :n // 160]
    assert got.shape == (32, n // 160)
    np.testing.assert_allclose(got, want.numpy(), **TOL)
