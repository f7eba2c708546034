"""The port's Slurm writer (``python -m pase_tpu_torch.sbatch_writer``)
against the root ``sbatch_writer.py``: both writers run as processes from
the same directory with the same flags; every file they write is the same
line for line, the job's command line aside, where the port's runs ``python
-m pase_tpu_torch.run_probe`` in place of ``python run_probe.py`` with the
same flags; each emitted command parses under the port's probe CLI. The
root writer imports only argparse and os, so it runs here without JAX."""

import os
import shlex
import subprocess
import sys

import pytest

from pase_tpu_torch import sbatch_writer
from pase_tpu_torch.run_probe import build_argparser as probe_argparser
from torch_port_common import port_test_guard  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PROBE, PORT_PROBE = "python run_probe.py", sbatch_writer.PROBE

FLAGS = {
    "defaults": [],
    "options": ["--data_root", "probe_data", "--partition", "gpu",
                "--time", "02:30:00", "--cpus", "16",
                "--extra", "#SBATCH --gres=gpu:1",
                "--tasks", "spk_id", "timit_fer"],
}


def _write(cwd, argv):
    """({file name: its lines}, the 'wrote' lines) of one writer run from
    ``cwd``; the output directory is removed after reading."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(argv, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = os.path.join(cwd, "sb")
    files = {}
    for name in sorted(os.listdir(out)):
        with open(os.path.join(out, name)) as f:
            files[name] = f.read().splitlines()
        os.remove(os.path.join(out, name))
    os.rmdir(out)
    return files, proc.stdout.splitlines()


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_port_writer_writes_the_root_writers_files(tmp_path, flags):
    common = ["--fe_cfg", "cfg/frontend/PASE+.cfg", "--fe_ckpt",
              "ckpt/FE_e399.npz", "--out_dir", "sb"] + FLAGS[flags]
    want, want_said = _write(tmp_path, [sys.executable, os.path.join(
        REPO, "sbatch_writer.py")] + common)
    got, said = _write(tmp_path, [sys.executable, "-m",
                                  "pase_tpu_torch.sbatch_writer"] + common)
    tasks = FLAGS[flags][FLAGS[flags].index("--tasks") + 1:] if (
        "--tasks" in FLAGS[flags]) else list(sbatch_writer.TASKS)
    assert sorted(got) == sorted(f"{t}.sbatch" for t in tasks)
    assert said == want_said == [f"wrote sb/{t}.sbatch" for t in tasks]
    for name, lines in want.items():
        assert len(got[name]) == len(lines), name
        commands = 0
        for mine, theirs in zip(got[name], lines):
            if theirs.startswith(JAX_PROBE):
                commands += 1
                assert mine == PORT_PROBE + theirs[len(JAX_PROBE):]
            else:
                assert mine == theirs
        assert commands == 1, name
    assert f"cd {tmp_path}" in got[f"{tasks[0]}.sbatch"]


def test_every_emitted_command_parses_under_the_port_probe_cli(
        tmp_path, monkeypatch):
    """Each task's command names the port's probe CLI and its flags parse
    there to the task's mode, lists, checkpoint and options."""
    monkeypatch.chdir(tmp_path)
    paths = sbatch_writer.main(["--fe_cfg", "fe.cfg", "--fe_ckpt", "FE.npz",
                                "--out_dir", "sb", "--data_root", "d"])
    assert len(paths) == len(sbatch_writer.TASKS)
    for path in paths:
        task = os.path.basename(path)[:-len(".sbatch")]
        with open(path) as f:
            cmd = f.read().splitlines()[-1]
        argv = shlex.split(cmd)
        assert argv[:3] == ["python", "-m", "pase_tpu_torch.run_probe"]
        opts = probe_argparser().parse_args(argv[3:])
        mode, _ = sbatch_writer.TASKS[task]
        assert opts.task == mode
        assert (opts.fe_cfg, opts.fe_ckpt) == ("fe.cfg", "FE.npz")
        assert opts.train_list == f"d/{task}_train.lst"
        assert opts.test_list == f"d/{task}_test.lst"
        assert opts.out == f"sb/{task}_metrics.json"
        assert opts.device == "cuda"
        if mode == "frames":
            assert (opts.num_classes, opts.hidden) == (48, [1024])
        else:
            assert (opts.mode, opts.hidden) == ("avg_concat", [256])
