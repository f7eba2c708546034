"""The port's serving artifacts (pase_tpu_torch.serving, ``torch.export``)
on the CPU, with buckets (1600, 3200) of a narrow encoder.

Held against the port's offline encoder windowed at the largest bucket
(atol 2e-5, as tests/test_serving.py holds the JAX artifact), against the
JAX package's ServingEncoder of the same weights (1e-5), and against the
in-process streaming encoder (bit for bit: the same operations on the same
shapes). Also: the CLI round trip, bf16 weights, a consumer process that
imports no model code, and ``torch.library.opcheck`` of the registered
QRNN operator.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pase_tpu import frontend as jax_frontend
from pase_tpu.checkpoint import save_variables as jax_save_variables
from pase_tpu.data.io import write_wav
from pase_tpu_torch import frontend, serving, streaming
from pase_tpu_torch import util_scripts as port_cli
from pase_tpu_torch.checkpoint import variables_to_state_dict
from pase_tpu_torch.ops import cuda_qrnn
from torch_port_common import flat_variables, jax_variables
from torch_port_common import port_test_guard  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {"kwidths": [65, 10, 4, 4], "strides": [1, 10, 4, 4],
       "fmaps": [16, 16, 24, 24], "emb_dim": 24, "norm_out": True,
       "rnn_pool": True, "rnn_dim": 24, "denseskips": True}
BUCKETS = (1600, 3200)
CHUNK = 1600


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """JAX weights (seeded, BatchNorm and PReLU randomized) in a native
    npz, the port's encoder with them, and its artifact (buckets and the
    streaming programs at CHUNK)."""
    root = tmp_path_factory.mktemp("serving")
    module = jax_frontend.build_wavefe(dict(CFG, qrnn_impl="scan"))
    variables = jax_variables(module, 3200, seed=2)
    jax_save_variables(str(root / "FE.npz"), variables)
    with open(root / "fe.cfg", "w") as f:
        json.dump(CFG, f)
    enc = frontend.wf_builder(CFG, device="cpu")
    sd = variables_to_state_dict(flat_variables(variables))
    enc.module.load_state_dict(dict(enc.module.state_dict(), **sd))
    out = str(root / "artifact")
    torch.set_num_threads(1)
    serving.export_encoder(enc, out, chunk_sizes=BUCKETS)
    serving.export_streaming_encoder(enc, out, chunk=CHUNK)
    return root, module, variables, enc, out


def _wav(n, seed):
    return (np.random.RandomState(seed).randn(n) * 0.2).astype(np.float32)


def _offline_windowed(enc, wav, big):
    """forward-chunk's windows: the largest bucket, the tail zero-padded,
    frames trimmed to len // 160."""
    outs = []
    for beg in range(0, len(wav), big):
        piece = wav[beg:beg + big]
        pad = big - len(piece)
        y = enc(np.pad(piece, (0, pad))[None, None])[0].numpy()
        outs.append(y[:, :(big - pad) // 160])
    return np.concatenate(outs, axis=1)


def test_meta_and_weights_layout(art):
    """meta.json names the format, the buckets, the halo and the device;
    params.npz holds the JAX variables layout (the keys of
    pase_tpu.checkpoint.save_variables)."""
    root, _, variables, _, out = art
    srv = serving.ServingEncoder(out)
    assert srv.meta["format"] == "pase_tpu_torch.serving/1"
    assert srv.buckets == list(BUCKETS) and srv.hop == 160
    assert srv.meta["device"] == "cpu" and srv.meta["emb_dim"] == 24
    assert srv.halo is not None and srv.halo % 160 == 0
    with np.load(os.path.join(out, "params.npz")) as got, \
            np.load(root / "FE.npz") as want:
        keys = set(want.files) - {"__meta__"}
        assert set(got.files) - {"__meta__"} == keys
        for k in keys:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("n", [3200, 2000, 7000, 500])
def test_encode_matches_windowed_offline(art, n):
    """Exact bucket, a padded tail, several windows with a ragged tail,
    under the halo."""
    enc, out = art[3], art[4]
    wav = _wav(n, seed=n)
    got = serving.ServingEncoder(out).encode(wav)
    ref = _offline_windowed(enc, wav, BUCKETS[-1])
    assert got.shape == ref.shape == (24, n // 160)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def test_matches_the_jax_artifact(art, tmp_path):
    """The JAX ServingEncoder of the same weights (1e-5); and the JAX
    artifact's params.npz, dropped into the port's artifact, serves the
    same frames."""
    from pase_tpu.serving import ServingEncoder as JaxServing
    from pase_tpu.serving import export_encoder as jax_export

    class _Enc:
        module, variables, cfg = art[1], art[2], dict(CFG, qrnn_impl="scan")

    jout = str(tmp_path / "jax")
    jax_export(_Enc(), jout, chunk_sizes=BUCKETS, platforms=("cpu",))
    wav = _wav(7000, seed=3)
    want = np.asarray(JaxServing(jout).encode(wav))
    got = serving.ServingEncoder(art[4]).encode(wav)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    mixed = str(tmp_path / "mixed")
    os.makedirs(mixed)
    for name in os.listdir(art[4]):
        src = os.path.join(jout if name == "params.npz" else art[4], name)
        os.symlink(src, os.path.join(mixed, name))
    np.testing.assert_array_equal(serving.ServingEncoder(mixed).encode(wav),
                                  got)


def test_encode_batch_equals_encode(art):
    srv = serving.ServingEncoder(art[4])
    lens = [800, 960, 3200, 2000, 7000]       # two buckets + windowed
    wavs = [_wav(n, seed=n + 1) for n in lens]
    for w, o, n in zip(wavs, srv.encode_batch(wavs), lens):
        assert o.shape == (24, n // 160)
        np.testing.assert_array_equal(o, srv.encode(w))
    with pytest.raises(ValueError, match="wav 0"):
        srv.encode_batch([np.zeros((2, 1600), np.float32)])


def test_bf16_weights(art, tmp_path):
    """weights_dtype='bfloat16': params.npz holds bf16 values as float32,
    the programs take bf16 weights and compute in float32, so the frames
    are the encoder's with its weights rounded to bf16."""
    enc = art[3]
    out = str(tmp_path / "bf16")
    serving.export_encoder(enc, out, chunk_sizes=(1600,),
                           weights_dtype="bfloat16")
    srv = serving.ServingEncoder(out)
    assert srv.meta["weights_dtype"] == "bfloat16"
    assert all(v.dtype == torch.bfloat16 for v in srv.params.values())
    with np.load(os.path.join(out, "params.npz")) as data:
        k = next(k for k in data.files if k.endswith("conv/kernel"))
        arr = data[k]
        assert arr.dtype == np.float32
        np.testing.assert_array_equal(
            torch.from_numpy(arr).to(torch.bfloat16).float().numpy(), arr)
    rounded = frontend.wf_builder(CFG, device="cpu")
    rounded.module.load_state_dict(
        {k: v.to(torch.bfloat16).float() if v.is_floating_point() else v
         for k, v in enc.module.state_dict().items()})
    wav = _wav(1600, seed=4)
    np.testing.assert_allclose(srv.encode(wav),
                               rounded(wav[None, None])[0].numpy(),
                               atol=2e-5, rtol=2e-5)


def test_streaming_artifact_is_the_stream(art):
    """prime / step / flush emissions equal the in-process stream fed the
    same chunks, bit for bit; the frame counts are meta's. A stream of one
    row runs as two rows with a zero row (serving.MIN_BATCH), so it is
    held to the in-process stream of that batch."""
    enc, out = art[3], art[4]
    srv = serving.ServingStreamingEncoder(out)
    assert srv.meta["format"] == "pase_tpu_torch.serving.streaming/1"
    for b in (1, 3):
        wav = np.stack([_wav(4 * CHUNK, seed=10 + i) for i in range(b)])
        srv.reset()
        ys = [srv.push(wav[:, i:i + CHUNK])
              for i in range(0, wav.shape[1], CHUNK)] + [srv.flush()]
        assert [y.shape[2] for y in ys] == (
            [srv.meta["prime_frames"]] + [srv.meta["step_frames"]] * 3
            + [srv.meta["flush_frames"]])
        rows = np.concatenate([wav, np.zeros_like(wav)])[:max(b, 2)]
        st = streaming.StreamingEncoder(enc)
        want = [st.push(rows[:, i:i + CHUNK])
                for i in range(0, wav.shape[1], CHUNK)] + [st.flush()]
        np.testing.assert_array_equal(
            np.concatenate(ys, axis=2),
            torch.cat([y for y in want if y is not None], 2).numpy()[:b])
    with pytest.raises(ValueError, match="batch"):
        srv.reset()
        srv.push(wav[:, :CHUNK])
        srv.push(wav[:1, CHUNK:2 * CHUNK])


def test_too_small_a_streaming_chunk_raises(art, tmp_path):
    with pytest.raises(ValueError, match="too small"):
        serving.export_streaming_encoder(art[3], str(tmp_path / "s"),
                                         chunk=160)
    with pytest.raises(ValueError, match="multiple"):
        serving.export_streaming_encoder(art[3], str(tmp_path / "s"),
                                         chunk=1000)


def test_export_serve_encode_cli_round_trip(art, tmp_path):
    """export -> serve-encode (single, --batch_size 2, --streaming) against
    forward-chunk --chunk_size of the largest bucket, all on the CPU."""
    root = art[0]
    lens = {"a": 2500, "b": 7000, "c": 1600}
    for k, n in lens.items():
        write_wav(str(tmp_path / f"{k}.wav"), _wav(n, seed=n))
    (tmp_path / "list.txt").write_text("".join(f"{k}.wav\n" for k in lens))
    common = ["--fe_cfg", str(root / "fe.cfg"), "--fe_ckpt",
              str(root / "FE.npz")]
    out = str(tmp_path / "art")
    port_cli.main(["export", "--device", "cpu", "--out_dir", out,
                   "--chunk_sizes", "1600,3200", "--streaming_chunk", "1600"]
                  + common)
    port_cli.main(["forward-chunk", "--device", "cpu", "--chunk_size",
                   "3200", "--wav_list", str(tmp_path / "list.txt"),
                   "--files_root", str(tmp_path), "--out_dir",
                   str(tmp_path / "fc")] + common)
    port_cli.main(["forward-chunk", "--device", "cpu", "--streaming",
                   "--chunk_size", "1600", "--wav_list",
                   str(tmp_path / "list.txt"), "--files_root",
                   str(tmp_path), "--out_dir", str(tmp_path / "fcs")]
                  + common)
    for mode, flags in (("single", []), ("batch", ["--batch_size", "2"]),
                        ("stream", ["--streaming"])):
        argv = ["serve-encode", "--export_dir", out, "--wav_list",
                str(tmp_path / "list.txt"), "--files_root", str(tmp_path),
                "--out_dir", str(tmp_path / mode)] + flags
        if mode != "single":
            port_cli.main(argv)
            continue
        # a process of its own: the CLI registers the operator itself
        proc = subprocess.run(
            [sys.executable, "-m", "pase_tpu_torch.util_scripts"] + argv,
            cwd=REPO, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
        assert proc.returncode == 0, proc.stderr
    for k, n in lens.items():
        want = np.load(tmp_path / "fc" / f"{k}.npy")
        assert want.shape == (24, n // 160)
        for mode in ("single", "batch"):
            np.testing.assert_allclose(np.load(tmp_path / mode / f"{k}.npy"),
                                       want, atol=2e-5, rtol=2e-5)
        # the streaming artifact: the file's zero-padded tail is streamed
        # too, so its frames are those of the streamed padded file
        got = np.load(tmp_path / "stream" / f"{k}.npy")
        stream = np.load(tmp_path / "fcs" / f"{k}.npy")
        assert got.shape == stream.shape == want.shape
        np.testing.assert_allclose(got[:, :-8], stream[:, :-8], atol=2e-5,
                                   rtol=2e-5)


def test_consumer_needs_no_model_code(art, tmp_path):
    """A fresh process with torch, numpy and the registered operator
    (pase_tpu_torch.ops.cuda_qrnn) alone loads the artifact and gets the
    loader's frames; no module of the model is imported."""
    out = art[4]
    wav = np.stack([_wav(1600, seed=21), _wav(1600, seed=22)])
    np.save(tmp_path / "wav.npy", wav)
    want = serving.ServingEncoder(out)._call(1600, wav)
    code = (
        "import json, os, sys\n"
        "import numpy as np, torch\n"
        "import pase_tpu_torch.ops.cuda_qrnn\n"
        "out, wavp, outp = sys.argv[1:4]\n"
        "meta = json.load(open(os.path.join(out, 'meta.json')))\n"
        "data = np.load(os.path.join(out, 'params.npz'))\n"
        "params = {}\n"
        "for name, key, perm in meta['inputs']:\n"
        "    a = data[key]\n"
        "    if perm is not None: a = np.ascontiguousarray(a.transpose(perm))\n"
        "    params[name] = torch.from_numpy(a)\n"
        "T = meta['buckets'][0]\n"
        "prog = torch.export.load(os.path.join(out, f'encoder_T{T}.pt2'))\n"
        "with torch.no_grad():\n"
        "    y = prog.module()(params, torch.from_numpy(np.load(wavp)))\n"
        "np.save(outp, y.numpy())\n"
        "bad = [m for m in sys.modules if m.startswith('pase_tpu')\n"
        "       and not m.startswith('pase_tpu_torch.ops')\n"
        "       and m != 'pase_tpu_torch']\n"
        "assert not bad, bad\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, out, str(tmp_path / "wav.npy"),
         str(tmp_path / "y.npy")], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), want)


@pytest.mark.parametrize("seeded", [False, True])
def test_qrnn_operator_opcheck(seeded):
    """The registered operator's schema, fake (shape) implementation and
    dispatch, on the CPU; its CPU result is the plain version's."""
    from pase_tpu_torch.ops import qrnn as plain
    g = torch.Generator().manual_seed(3)
    y = torch.randn(2, 7, 12, generator=g)
    c0 = torch.randn(2, 4, generator=g) if seeded else None
    op = torch.ops.pase_tpu_torch.qrnn_pool_fwd.default
    torch.library.opcheck(op, (y, c0))
    h, c_last = op(y, c0)
    hp, cp = plain.qrnn_pool(y, c0)
    assert torch.equal(h, hp) and torch.equal(c_last, cp)
    assert torch.equal(cuda_qrnn.qrnn_pool_fwd(y, c0)[0], hp)


@pytest.mark.parametrize("cfg", ["cfg/frontend/PASE+.cfg",
                                 "cfg/frontend/PASE.cfg", CFG],
                         ids=["pase_plus", "pase", "narrow"])
def test_halo_is_the_jax_halo(cfg):
    """The port's copy of the trunk's receptive halo equals
    pase_tpu/parallel/sp.py's time_shard_halo."""
    from pase_tpu.parallel.sp import time_shard_halo as jax_halo
    module = frontend.build_frontend_module(cfg)
    assert serving.time_shard_halo(module) == jax_halo(
        jax_frontend.build_wavefe(jax_frontend.load_cfg(cfg)))
