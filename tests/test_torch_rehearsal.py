"""The production rehearsal through the port's CLIs
(``pase_tpu_torch/recipes/rehearsal.sh``) and the corpus it trains on
(``python -m pase_tpu_torch.make_bench_corpus``), on the CPU.

  * Both corpus scripts (the root ``experiments/make_bench_corpus.py`` and
    the port's) write the same files from the same seed, byte for byte,
    ``dist.cfg``'s ``_source`` note aside; each writes into the same
    directory in turn, since the cfgs hold its paths.
  * The script parses (``bash -n``) and runs only the port's CLIs: no root
    script, no ``experiments/`` file, no module of the JAX package.
  * The script itself, whole, at a narrow cfg (RUN_FE / RUN_WK: PASE+'s
    layer kinds at widths 32-64 with mfcc and mi heads) on the CPU: a
    corpus of two speakers' 1 s utterances (written first by
    make_bench_corpus at --seg_s 1, which the script keeps), 2 steps an epoch at 16
    x 16000, 3 epochs; run B really killed (-9) in epoch 2 and resumed in
    a new process; every assertion of the script holds there (A and B
    bit for bit, serve-encode against forward-chunk, the probe fired, at
    or above chance + 0.15 and the random-init encoder). The transfer
    margin is small at this size (the random-init probe reads 1.0 on two
    speakers, so only "not worse" binds); ``chip_smoke.py`` phase 28
    holds it at PASE+ width on the card.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from torch_port_common import port_test_guard  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "pase_tpu_torch", "recipes", "rehearsal.sh")
RUN_FE = {"kwidths": [65, 10, 5, 5], "strides": [1, 10, 4, 4],
          "fmaps": [16, 16, 32, 32], "emb_dim": 32, "norm_out": True,
          "rnn_pool": True, "rnn_dim": 32, "denseskips": True}
RUN_WK = {"regr": [{"num_outputs": 39, "dropout": 0, "hidden_size": 64,
                    "hidden_layers": 1, "name": "mfcc", "r": 1,
                    "loss": "MSELoss", "skip": False}],
          "cls": [{"num_outputs": 1, "dropout": 0, "hidden_size": 64,
                   "hidden_layers": 1, "name": "mi",
                   "loss": "BCEWithLogitsLoss", "skip": False}]}
# two speakers of 40 one-second utterances: speaker 100 the valid split,
# 101 the train split (40 s: 2 steps of 16 x 16000 an epoch)
RUN_CORPUS = ["--hours", "0.0223", "--seg_s", "1"]
RUN_ENV = {"HOURS": "0.0223", "EPOCHS": "3", "BATCH": "16",
           "CHUNK": "16000", "DEVICE": "cpu"}


def _env():
    """The children's environment: the script's ``python`` is this
    interpreter."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env["PATH"] = os.pathsep.join([os.path.dirname(sys.executable),
                                   env.get("PATH", "")])
    env.pop("PYTEST_CURRENT_TEST", None)
    return env


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _build(argv, out_root):
    proc = subprocess.run(argv + ["--out_root", out_root, "--hours", "0.03",
                                  "--seg_s", "2", "--seed", "7"],
                          cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_corpus_scripts_write_the_same_bytes(tmp_path):
    """54 utterances of 2 s from seed 7 (two speakers), the data cfg, the
    noises, IRs, FIR, overlap list and dist.cfg of both scripts."""
    root = str(tmp_path / "corpus")
    said_jax = _build([sys.executable, os.path.join(
        REPO, "experiments", "make_bench_corpus.py")], root)
    want = _tree(root)
    shutil.rmtree(root)
    said = _build([sys.executable, "-m", "pase_tpu_torch.make_bench_corpus"],
                  root)
    got = _tree(root)
    assert said == said_jax
    assert sorted(got) == sorted(want)
    assert len([k for k in got if k.startswith("wavs" + os.sep)]) == 54
    for name in ("noises", "irs", "filters"):
        assert any(k.startswith(name + os.sep) for k in got), name
    for k, v in want.items():
        if k != "dist.cfg":
            assert got[k] == v, k
    mine, theirs = (json.loads(t) for t in (got["dist.cfg"],
                                             want["dist.cfg"]))
    assert mine.pop("_source") != theirs.pop("_source")
    assert mine == theirs
    strip = [re.sub(rb'"_source": "[^"]*"', b"", t)
             for t in (got["dist.cfg"], want["dist.cfg"])]
    assert strip[0] == strip[1]


def test_script_parses_and_runs_only_port_clis():
    """``bash -n`` passes; every ``python`` command of the script is
    ``python -m pase_tpu_torch.<module>`` (a module of the port) or an
    inline ``python -`` check; no root script, experiments/ file or JAX
    package module is named."""
    proc = subprocess.run(["bash", "-n", SCRIPT], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    with open(SCRIPT) as f:
        text = f.read()
    code = "\n".join(line for line in text.splitlines()
                     if not line.lstrip().startswith("#"))
    calls = re.findall(r"\bpython\s+(-m\s+)?(\S+)", code)
    modules = [m for flag, m in calls if flag]
    assert sorted(set(modules)) == [
        "pase_tpu_torch.make_bench_corpus",
        "pase_tpu_torch.make_trainset_statistics",
        "pase_tpu_torch.run_probe", "pase_tpu_torch.train",
        "pase_tpu_torch.util_scripts"]
    for m in modules:
        assert os.path.isfile(os.path.join(REPO, *m.split(".")) + ".py"), m
    assert {m for flag, m in calls if not flag} == {"-"}
    assert "experiments/" not in code
    assert not re.search(r"\bpase_tpu\b(?!_torch)", code)
    assert not re.search(r"\b(train|run_probe|util_scripts|data_prep|"
                         r"make_trainset_statistics)\.py\b", code)


def test_rehearsal_script_on_the_cpu(tmp_path):
    """The whole script at RUN_ENV on the narrow cfg: it exits 0 after
    every step's PASS line; run B was killed in epoch 2 (a logged step
    past epoch 1's last, and no FE_e2.npz yet) and resumed to the same
    bits as run A."""
    fe, wk = tmp_path / "fe.cfg", tmp_path / "wk.cfg"
    fe.write_text(json.dumps(RUN_FE))
    wk.write_text(json.dumps(RUN_WK))
    work = tmp_path / "work"
    proc = subprocess.run(
        [sys.executable, "-m", "pase_tpu_torch.make_bench_corpus",
         "--out_root", str(work / "corpus")] + RUN_CORPUS, cwd=REPO,
        env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    env = dict(_env(), **RUN_ENV, FE_CFG=str(fe), WK_CFG=str(wk))
    proc = subprocess.run(["bash", SCRIPT, str(work)], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=600)
    log = (work / "rehearsal.log").read_text()
    assert proc.returncode == 0, proc.stdout[-3000:] + log[-3000:]
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("[rehearsal]")]
    assert any("bitwise equal across kill -9 + resume" in ln for ln in lines)
    assert any("serve-encode == forward-chunk" in ln for ln in lines)
    assert any("PASS: probe ran (2 firings)" in ln for ln in lines)
    assert lines[-1].endswith("all assertions passed")
    killed = next(ln for ln in lines if "killed (-9)" in ln)
    step = int(re.search(r"logged step (\d+)", killed).group(1))
    assert 2 * 2 < step <= 3 * 2         # in epoch 2 (2 steps an epoch)
    for e in range(3):
        assert (work / "runA" / f"FE_e{e}.npz").is_file()
        assert (work / "runB" / f"FE_e{e}.npz").is_file()
    with open(work / "runB" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    steps = [r["step"] for r in rows if r["split"] == "train"]
    # the resumed process logs epoch 2 again from its first step
    assert steps.count(5) == 2 and steps[-1] == 6
    for e in (1, 2):
        with open(work / "runB" / "sup_aux" / f"probe_{e}.json") as f:
            assert 0.0 <= json.load(f)["test_sentence_acc"] <= 1.0


@pytest.mark.parametrize("script", ["sbatch_writer.py",
                                    "experiments/make_bench_corpus.py"])
def test_root_scripts_have_port_modules(script):
    """Each root script the rehearsal needs has its port module, with
    the same flags (argparse option strings)."""
    import argparse
    import ast
    with open(os.path.join(REPO, script)) as f:
        tree = ast.parse(f.read())
    flags = {a.value for node in ast.walk(tree)
             if isinstance(node, ast.Call)
             and getattr(node.func, "attr", "") == "add_argument"
             for a in node.args if isinstance(a, ast.Constant)}
    name = os.path.splitext(os.path.basename(script))[0]
    module = __import__(f"pase_tpu_torch.{name}", fromlist=["x"])
    parser = module.build_argparser()
    assert isinstance(parser, argparse.ArgumentParser)
    mine = {s for a in parser._actions for s in a.option_strings} - {
        "-h", "--help"}
    assert mine == flags
