"""Metrics logging: JSONL scalars, echoed to stderr.

The port of ``pase_tpu/log.py``: one JSON object per line in
``<save_path>/metrics.jsonl``, {"t", "split", "step", <scalars>}; the
'perf' split carries steps_per_sec and audio_sec_per_sec.
"""

import json
import os
import sys
import time


class MetricLogger:

    def __init__(self, save_path, fname="metrics.jsonl", echo=True):
        self.save_path = save_path
        os.makedirs(save_path, exist_ok=True)
        self.path = os.path.join(save_path, fname)
        self.echo = echo
        self._f = None

    def log(self, split, step, scalars):
        rec = {"t": time.time(), "split": split, "step": int(step)}
        for k, v in scalars.items():
            rec[k] = float(v)
        if self._f is None:
            self._f = open(self.path, "a")
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.echo:
            msg = " ".join(f"{k}={v:.4f}" for k, v in rec.items()
                           if k not in ("t", "split", "step"))
            print(f"[{split} @ {step}] {msg}", file=sys.stderr)

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
