"""The port's transfer gate (pase_tpu_torch/transfer_gate.py) against
experiments/transfer_gate.py: the same configs and CLI defaults, the
probe corpus (wavs and lists) byte for byte, the pretraining batches bit
for bit; a tiny run of the CLI on the CPU (its JSON has the JAX record's
keys); and, marked slow as the JAX gate test is, the slimmed gate run:
pretraining must improve the speaker-ID probe over a random-init
encoder."""

import ast
import faulthandler
import filecmp
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from pase_tpu_torch import transfer_gate as port_tg
from torch_port_common import port_test_guard  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EXP = os.path.join(REPO, "experiments", "transfer_gate.py")
JAX_RECORD = os.path.join(REPO, "benchmarks", "transfer_gate_r5.json")


@pytest.fixture(scope="module")
def jax_tg():
    spec = importlib.util.spec_from_file_location("jax_transfer_gate",
                                                  JAX_EXP)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_cli_defaults():
    """{dest: default} of the add_argument calls in the JAX main()."""
    tree = ast.parse(open(JAX_EXP).read())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                  if k.arg == "default"}
            out[node.args[0].value.lstrip("-")] = kw.get("default")
    return out


def test_configs_and_cli_defaults_are_the_jax_experiments(jax_tg):
    assert port_tg.FE_CFG == jax_tg.FE_CFG
    assert port_tg.WORKERS_CFG == jax_tg.WORKERS_CFG
    port = {a.dest: a.default for a in port_tg.build_argparser()._actions
            if a.dest != "help"}
    assert {k: v for k, v in port.items() if k != "device"} == \
        _jax_cli_defaults()
    assert port["device"] == "cuda"


@pytest.mark.parametrize("kw", [
    dict(n_spk=3, n_train=2, n_test=2, seed=100),
    dict(n_spk=2, n_train=1, n_test=3, utt_sec=0.7, seed=5)])
def test_probe_corpus_is_byte_equal(jax_tg, tmp_path, kw):
    jax_tg.build_probe_corpus(str(tmp_path / "j"), **kw)
    port_tg.build_probe_corpus(str(tmp_path / "p"), **kw)
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "p"))
    assert len(files) == kw["n_spk"] * (kw["n_train"] + kw["n_test"]) + 2
    for f in files:
        assert filecmp.cmp(tmp_path / "j" / f, tmp_path / "p" / f,
                           shallow=False), f


def test_batcher_is_the_jax_batcher(jax_tg):
    want = iter(jax_tg.SpeakerFamilyBatcher(3, 4000, seed=9))
    got = iter(port_tg.SpeakerFamilyBatcher(3, 4000, seed=9))
    try:
        for _ in range(3):
            w, g = next(want), next(got)
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype == np.float32
                np.testing.assert_array_equal(g[k], w[k])
    finally:
        got.close()


def test_tiny_gate_run_on_the_cpu(tmp_path):
    """1 epoch x 4 steps on a 4-speaker corpus: the CLI runs end to end
    on the CPU and writes the JAX record's keys (the margin of so short a
    run is not checked)."""
    out = tmp_path / "gate.json"
    proc = subprocess.run(
        [sys.executable, "-m", "pase_tpu_torch.transfer_gate", "--device",
         "cpu", "--epochs", "1", "--bpe", "4", "--batch_size", "2",
         "--chunk_size", "8000", "--n_spk", "4", "--n_train", "3",
         "--n_test", "2", "--probe_epochs", "2", "--workdir",
         str(tmp_path / "work"), "--json", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=280)
    assert proc.returncode in (0, 1), proc.stderr[-2000:]
    got = json.loads(out.read_text())
    with open(JAX_RECORD) as f:
        want = json.load(f)
    assert set(got) == set(want)
    assert set(got["curve"][0]) == set(want["curve"][0])
    assert got["ok"] == (proc.returncode == 0)
    assert got["n_speakers"] == 4 and len(got["curve"]) == 1
    for k in ("random_encoder_acc", "mfcc_baseline_acc",
              "pretrained_final_acc"):
        assert 0.0 <= got[k] <= 1.0
    assert os.path.exists(tmp_path / "work" / "pretrain" / "FE_e0.npz")
    assert "[transfer] PASS" in proc.stdout or "[transfer] FAIL" in \
        proc.stdout


@pytest.mark.slow
def test_pretraining_beats_random_encoder(tmp_path):
    """The JAX gate test's slimmed run (2 epochs x 200 steps at batch 16
    x 8000, 25 speakers of 8 / 4 utterances, 8 probe epochs) with this
    package's Trainer on the CPU: the random encoder's probe is below 1
    and pretraining strictly improves it."""
    import torch
    from pase_tpu_torch.checkpoint import save_variables_npz
    from pase_tpu_torch.data.pipeline import compute_stats
    from pase_tpu_torch.model import parse_workers_cfg
    from pase_tpu_torch.trainer import Trainer
    # a run of several minutes on the CPU: past the guard's stall limit
    faulthandler.dump_traceback_later(3600, exit=True)
    torch.set_num_threads(4)
    corpus = str(tmp_path / "probe_corpus")
    port_tg.build_probe_corpus(corpus, n_spk=25, n_train=8, n_test=4,
                               seed=100)
    epochs, bpe, bsz, chunk = 2, 200, 16, 8000
    save_path = str(tmp_path / "pretrain")
    wk = json.loads(json.dumps(port_tg.WORKERS_CFG))
    stats = compute_stats(port_tg.SpeakerFamilyBatcher(16, chunk, seed=7),
                          parse_workers_cfg(json.loads(json.dumps(wk))),
                          max_batches=4, device="cpu")
    cfg = dict(backprop_mode="base", hop=160, bpe=bpe, epoch=epochs,
               batch_size=bsz, chunk_size=chunk, log_freq=bpe,
               fe_lr=5e-4, min_lr=5e-4, lr_mode="poly",
               save_path=save_path, seed=1)
    tr = Trainer(dict(port_tg.FE_CFG), wk, cfg, stats=stats, device="cpu")
    rand_ckpt = str(tmp_path / "FE_random.npz")
    save_variables_npz(rand_ckpt, tr.model.frontend.state_dict(), 0)
    tr.train_(port_tg.SpeakerFamilyBatcher(bsz, chunk, seed=9),
              epochs=epochs, resume=False)
    tr.logger.close()
    acc_rand = port_tg.probe_acc(rand_ckpt, corpus, epochs=8, device="cpu")
    acc_pre = port_tg.probe_acc(
        os.path.join(save_path, f"FE_e{epochs - 1}.npz"), corpus,
        epochs=8, device="cpu")
    assert acc_rand < 1.0, acc_rand
    assert acc_pre > acc_rand, (acc_pre, acc_rand)
