"""The whole serving slice: ``python -m pase_tpu_torch.util_scripts
forward-chunk --device cpu`` against the JAX ``util_scripts.forward_chunk``
on the same wav list and the same npz weights (bound: 1e-4 of the largest
output, float32 convolutions summed in different orders), and the port's
import isolation from JAX."""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from pase_tpu import frontend as jax_frontend
from pase_tpu.checkpoint import save_variables
from pase_tpu.data.io import read_wav as jax_read_wav
from pase_tpu.data.io import write_wav as jax_write_wav
from pase_tpu_torch import util_scripts as port_cli
from pase_tpu_torch.data import io as port_io
from torch_port_common import NARROW_CFG, jax_variables, rel_err
from torch_port_common import port_test_guard  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the narrow encoder at PASE+'s 160x frame rate
FC_CFG = dict(NARROW_CFG, strides=[1, 10, 4, 4])
CHUNK = 8000
# ragged: under one window, exactly one, several with a short tail
LENGTHS = {"spk1/a": 5000, "spk1/b": 8000, "spk2/a": 17123}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("fc")
    rng = np.random.RandomState(4)
    for name, n in LENGTHS.items():
        (root / name).parent.mkdir(exist_ok=True)
        jax_write_wav(str(root / f"{name}.wav"),
                      (rng.randn(n) * 0.1).astype(np.float32))
    (root / "list.txt").write_text(
        "".join(f"{name}.wav\n" for name in LENGTHS))
    with open(root / "fe.cfg", "w") as f:
        json.dump(FC_CFG, f)
    module = jax_frontend.build_wavefe(FC_CFG)
    save_variables(str(root / "FE_e0.npz"), jax_variables(module, CHUNK, 6))
    return root


def test_forward_chunk_matches_jax(corpus):
    import util_scripts
    util_scripts.forward_chunk(argparse.Namespace(
        fe_cfg=str(corpus / "fe.cfg"), fe_ckpt=str(corpus / "FE_e0.npz"),
        in_wav=None, out_file=None, wav_list=str(corpus / "list.txt"),
        files_root=str(corpus), out_dir=str(corpus / "out_jax"),
        chunk_size=CHUNK))
    proc = subprocess.run(
        [sys.executable, "-m", "pase_tpu_torch.util_scripts",
         "forward-chunk", "--device", "cpu",
         "--fe_cfg", str(corpus / "fe.cfg"),
         "--fe_ckpt", str(corpus / "FE_e0.npz"),
         "--wav_list", str(corpus / "list.txt"),
         "--files_root", str(corpus), "--out_dir", str(corpus / "out_port"),
         "--chunk_size", str(CHUNK)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for name, n in LENGTHS.items():
        want = np.load(corpus / "out_jax" / f"{name}.npy")
        got = np.load(corpus / "out_port" / f"{name}.npy")
        assert got.shape == want.shape == (8, n // 160)
        assert rel_err(got, want) <= 1e-4, (name, rel_err(got, want))


def test_single_file_equals_list_entry(corpus, tmp_path):
    """--in_wav/--out_file gives the same array as the --wav_list run."""
    common = ["forward-chunk", "--device", "cpu",
              "--fe_cfg", str(corpus / "fe.cfg"),
              "--fe_ckpt", str(corpus / "FE_e0.npz"),
              "--chunk_size", str(CHUNK)]
    port_cli.main(common + ["--wav_list", str(corpus / "list.txt"),
                            "--files_root", str(corpus),
                            "--out_dir", str(tmp_path / "list")])
    port_cli.main(common + ["--in_wav", str(corpus / "spk2/a.wav"),
                            "--out_file", str(tmp_path / "one.npy")])
    np.testing.assert_array_equal(np.load(tmp_path / "one.npy"),
                                  np.load(tmp_path / "list/spk2/a.npy"))


def test_forward_chunk_streaming_matches_jax(corpus):
    """--streaming: each wav through the online encoder in pieces of
    --chunk_size, against the JAX CLI's --streaming on the same list."""
    import util_scripts
    util_scripts.forward_chunk(argparse.Namespace(
        fe_cfg=str(corpus / "fe.cfg"), fe_ckpt=str(corpus / "FE_e0.npz"),
        in_wav=None, out_file=None, wav_list=str(corpus / "list.txt"),
        files_root=str(corpus), out_dir=str(corpus / "out_jax_stream"),
        chunk_size=CHUNK, streaming=True))
    port_cli.main(["forward-chunk", "--device", "cpu", "--streaming",
                   "--fe_cfg", str(corpus / "fe.cfg"),
                   "--fe_ckpt", str(corpus / "FE_e0.npz"),
                   "--wav_list", str(corpus / "list.txt"),
                   "--files_root", str(corpus),
                   "--out_dir", str(corpus / "out_port_stream"),
                   "--chunk_size", str(CHUNK)])
    for name, n in LENGTHS.items():
        want = np.load(corpus / "out_jax_stream" / f"{name}.npy")
        got = np.load(corpus / "out_port_stream" / f"{name}.npy")
        assert got.shape == want.shape == (8, n // 160)
        assert rel_err(got, want) <= 1e-4, (name, rel_err(got, want))


@pytest.mark.parametrize("flag", ["--time_shard"])
def test_later_slices_raise(corpus, tmp_path, flag):
    """--time_shard runs (tests/test_torch_time_shard.py); what it cannot
    shard exactly raises as in JAX: here a bidirectional LSTM context
    layer."""
    cfg = tmp_path / "lstm.cfg"
    cfg.write_text(json.dumps(dict(FC_CFG, rnn_pool=True, rnn_type="lstm",
                                   rnn_dim=16)))
    with pytest.raises(NotImplementedError, match="rnn_type='lstm'"):
        port_cli.main(["forward-chunk", "--device", "cpu", flag,
                       "--fe_cfg", str(cfg),
                       "--in_wav", str(corpus / "spk1/a.wav"),
                       "--out_file", str(tmp_path / "x.npy")])


def test_wav_io_matches_jax(tmp_path):
    x = (np.random.RandomState(0).randn(3001) * 0.3).astype(np.float32)
    port_io.write_wav(str(tmp_path / "p.wav"), x)
    jax_write_wav(str(tmp_path / "j.wav"), x)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    got, sr = port_io.read_wav(str(tmp_path / "p.wav"))
    want, jsr = jax_read_wav(str(tmp_path / "p.wav"))
    assert sr == jsr == 16000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_port_imports_no_jax():
    """Importing every pase_tpu_torch module (the encoders of
    pase_tpu_torch.encoders, parallel.mesh, parallel.sp, parallel.tp,
    data.device_corpus, data.host_distortions and decoders among them)
    loads no jax, flax or pase_tpu module (the card's host has no JAX)."""
    code = (
        "import pkgutil, importlib, sys, pase_tpu_torch\n"
        "for m in pkgutil.walk_packages(pase_tpu_torch.__path__, "
        "'pase_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'pase_tpu')]\n"
        "assert 'pase_tpu_torch.encoders' in sys.modules\n"
        "for m in ('parallel.mesh', 'parallel.sp', 'parallel.tp',\n"
        "          'data.device_corpus',\n"
        "          'data.host_distortions', 'decoders'):\n"
        "    assert 'pase_tpu_torch.' + m in sys.modules, m\n"
        "print(len([m for m in sys.modules if m.startswith('pase_tpu_torch')]))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 25


def _port_sources():
    root = os.path.join(REPO, "pase_tpu_torch")
    out = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(root):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_sources_import_no_jax(path):
    """No import statement anywhere in the port or chip_smoke.py, lazy
    ones inside functions included, names jax, jaxlib, flax, optax or the
    JAX package."""
    import ast
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in
           ("jax", "jaxlib", "flax", "optax", "pase_tpu")]
    assert not bad, bad


def test_entry_points_default_to_the_card():
    """forward-chunk, export, wf_builder and the trainer CLI run on the
    card unless the caller asks for the CPU; without one they refuse, never
    fall back. serve-encode serves the device its artifact was exported
    on."""
    import inspect
    from pase_tpu_torch import frontend
    from pase_tpu_torch import train as port_train
    opts = port_cli.build_parser().parse_args(
        ["forward-chunk", "--fe_cfg", "x.cfg", "--in_wav", "a.wav",
         "--out_file", "a.npy"])
    assert opts.device == "cuda"
    opts = port_cli.build_parser().parse_args(
        ["export", "--fe_cfg", "x.cfg", "--out_dir", "art"])
    assert opts.device == "cuda"
    assert inspect.signature(frontend.wf_builder).parameters[
        "device"].default == "cuda"
    assert port_train.build_argparser().parse_args([]).device == "cuda"
