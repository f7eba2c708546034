"""Metrics logging: JSONL scalars, echoed to stderr.

The port of ``pase_tpu/log.py``: one JSON object per line in
``<save_path>/metrics.jsonl``, {"t", "split", "step", <scalars>}; the
'perf' split carries steps_per_sec and audio_sec_per_sec. A value with
elements (a histogram row) is written as a JSON list. In a multi-process
run only rank 0 writes the file; another rank prints each record on
stderr as ``[rank r] <the JSON object>`` instead (its rows are the global
batch's, the same as rank 0's).
"""

import json
import os
import sys
import time


class MetricLogger:

    def __init__(self, save_path, fname="metrics.jsonl", echo=True, rank=0):
        self.save_path = save_path
        self.rank = rank
        os.makedirs(save_path, exist_ok=True)
        self.path = os.path.join(save_path, fname)
        self.echo = echo
        self._f = None

    def log(self, split, step, scalars):
        rec = {"t": time.time(), "split": split, "step": int(step)}
        for k, v in scalars.items():
            if isinstance(v, (list, tuple)) or getattr(v, "ndim", 0) > 0:
                rec[k] = [float(x) for x in v]
            else:
                rec[k] = float(v)
        if self.rank != 0:
            print(f"[rank {self.rank}] {json.dumps(rec)}", file=sys.stderr,
                  flush=True)
            return
        if self._f is None:
            self._f = open(self.path, "a")
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.echo:
            msg = " ".join(f"{k}={v:.4f}" for k, v in rec.items()
                           if k not in ("t", "split", "step")
                           and isinstance(v, float))
            print(f"[{split} @ {step}] {msg}", file=sys.stderr)

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
