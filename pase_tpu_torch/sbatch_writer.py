"""Slurm submission scripts for the downstream evaluation fan-out: one
sbatch file per probe task (TIMIT FER, speaker ID, language ID, emotion)
for a pretrained checkpoint, each running the port's probe CLI.

  python -m pase_tpu_torch.sbatch_writer --fe_cfg cfg/frontend/PASE+.cfg \\
      --fe_ckpt ckpt/FE_e399.npz --out_dir sbatch/ \\
      --partition gpu --time 12:00:00

The flags, the template and the tasks of the root ``sbatch_writer.py``;
each job runs ``python -m pase_tpu_torch.run_probe {mode} ...`` with the
same flags, from the directory the writer ran in. There is no
``--device`` flag: the probe CLI's default (the card) decides where a job
runs.
"""

import argparse
import os

TEMPLATE = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --partition={partition}
#SBATCH --time={time}
#SBATCH --output={out_dir}/{name}.%j.out
#SBATCH --cpus-per-task={cpus}
{extra}
cd {workdir}
{cmd}
"""

TASKS = {
    "timit_fer": ("frames", "--num_classes 48 --hidden 1024"),
    "spk_id": ("utt", "--mode avg_concat --hidden 256"),
    "lang_id": ("utt", "--mode avg_concat --hidden 256"),
    "emorec": ("utt", "--mode avg_concat --hidden 256"),
}

PROBE = "python -m pase_tpu_torch.run_probe"


def build_argparser():
    p = argparse.ArgumentParser(prog="python -m pase_tpu_torch.sbatch_writer")
    p.add_argument("--fe_cfg", required=True)
    p.add_argument("--fe_ckpt", required=True)
    p.add_argument("--out_dir", default="sbatch")
    p.add_argument("--data_root", default="data")
    p.add_argument("--partition", default="compute")
    p.add_argument("--time", default="12:00:00")
    p.add_argument("--cpus", type=int, default=8)
    p.add_argument("--extra", default="")
    p.add_argument("--tasks", nargs="+", default=list(TASKS))
    return p


def probe_command(opts, task):
    """The probe job's command line for ``task``."""
    mode, args = TASKS[task]
    return (f"{PROBE} {mode} --fe_cfg {opts.fe_cfg} "
            f"--fe_ckpt {opts.fe_ckpt} "
            f"--train_list {opts.data_root}/{task}_train.lst "
            f"--test_list {opts.data_root}/{task}_test.lst "
            f"--data_root {opts.data_root} {args} "
            f"--out {opts.out_dir}/{task}_metrics.json")


def main(argv=None):
    """Write ``{task}.sbatch`` under --out_dir for each of --tasks; returns
    the paths written."""
    opts = build_argparser().parse_args(argv)
    os.makedirs(opts.out_dir, exist_ok=True)
    workdir = os.getcwd()
    paths = []
    for task in opts.tasks:
        script = TEMPLATE.format(name=f"pase_{task}",
                                 partition=opts.partition, time=opts.time,
                                 out_dir=opts.out_dir, cpus=opts.cpus,
                                 extra=opts.extra, workdir=workdir,
                                 cmd=probe_command(opts, task))
        path = os.path.join(opts.out_dir, f"{task}.sbatch")
        with open(path, "w") as f:
            f.write(script)
        print(f"wrote {path}")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
