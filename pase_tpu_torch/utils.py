"""Misc utilities: the AuxiliarSuperviser (asynchronous downstream probes
launched after selected epochs) and class-stratified k-fold splits.

The port of ``pase_tpu/utils.py``'s ``AuxiliarSuperviser`` and
``kfold_data`` (numpy only: the same seed gives the same splits).
"""

import subprocess

import numpy as np


class AuxiliarSuperviser:
    """After selected epochs, substitute $model / $cfg / $iteration /
    $save_path into the command templates of ``cmd_file`` (one per line;
    blank lines and ``#`` comments skipped) and spawn each with
    ``Popen(shell=True)``.

    Finished children are reaped on each call (their return codes kept in
    ``finished``); ``procs`` holds the running ones, and ``wait`` waits
    for them all."""

    def __init__(self, cmd_file, save_path="."):
        self.cmd_file = cmd_file
        self.save_path = save_path
        with open(cmd_file) as f:
            self.cmds = [l.rstrip() for l in f
                         if l.strip() and not l.lstrip().startswith("#")]
        self.procs = []
        self.finished = []          # [(command, returncode)]

    def _reap(self):
        live = []
        for p in self.procs:
            if p.poll() is None:
                live.append(p)
            else:
                self.finished.append((p.args, p.returncode))
        self.procs = live

    def __call__(self, iteration, ckpt_path, cfg_path):
        # reap finished children: unreaped Popen handles accumulate
        # zombies over a run of hundreds of epochs
        self._reap()
        for cmd in self.cmds:
            sub = cmd.replace("$model", ckpt_path)
            sub = sub.replace("$cfg", cfg_path)
            sub = sub.replace("$iteration", str(iteration))
            sub = sub.replace("$save_path", self.save_path)
            self.procs.append(subprocess.Popen(sub, shell=True))

    def wait(self, timeout=None):
        """Wait for every running child; returns [(command, returncode)]
        of every child launched so far, the earliest reaped first."""
        for p in self.procs:
            p.wait(timeout=timeout)
        self._reap()
        return list(self.finished)


def kfold_data(data_list, utt2class, folds=10, valid_p=0.1, seed=0):
    """Class-stratified sliding-window k-fold splits: shuffle within each
    class, slide a 1/folds test window per class, carve a valid split out
    of the remaining train items (disjoint from train). Returns
    [[train, valid, test], ...] x folds."""
    rng = np.random.RandomState(seed)
    classes = sorted(set(utt2class.values()))
    items = {k: [d for d in data_list if utt2class[d] == k]
             for k in classes}
    for k in classes:
        items[k] = [items[k][i] for i in rng.permutation(len(items[k]))]
    test_n = {k: max(int((1.0 / folds) * len(items[k])), 1)
              for k in classes}
    lists = []
    for fi in range(folds):
        train_split, valid_split, test_split = [], [], []
        for k in classes:
            data = items[k]
            beg = (fi * test_n[k]) % max(len(data), 1)
            te = data[beg:beg + test_n[k]]
            rest = data[:beg] + data[beg + test_n[k]:]
            nv = int(valid_p * len(rest))
            valid_split += rest[:nv]
            train_split += rest[nv:]
            test_split += te
        lists.append([train_split, valid_split, test_split])
    return lists
