"""pase_tpu_torch.bench, bench.py's step in the port, on the CPU at a tiny
size (test_torch_train's small model, batch 2 x 4800, 1 warm-up step and
2 trials of 2 steps, set through the module's constants): one parseable
JSON line on stdout with bench.py's
keys, ``vs_baseline`` null (never a silent 0.0) and the reason on
stderr."""

import json

import pytest
import torch

from pase_tpu_torch import bench
from torch_port_common import port_test_guard  # noqa: F401


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bench_prints_one_json_line(tmp_path, capsys, monkeypatch, dtype):
    from test_torch_train import SMALL_FE, small_workers
    fe, net = tmp_path / "fe.cfg", tmp_path / "net.cfg"
    fe.write_text(json.dumps(SMALL_FE))
    net.write_text(json.dumps(small_workers()))
    for name, value in (("FE_CFG", str(fe)), ("NET_CFG", str(net)),
                        ("B", 2), ("T", 4800), ("N_WARM", 1),
                        ("N_MEAS", 2), ("N_TRIALS", 2)):
        monkeypatch.setattr(bench, name, value)
    bench.main(["--device", "cpu", "--compute_dtype", dtype])
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 1, out
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["vs_baseline"] is None
    assert '"vs_baseline": null' in lines[0]
    assert rec["value"] > 0 and dtype in rec["metric"]
    assert rec["metric"].startswith("PASE+ self-sup train steps/sec (batch 2,")
    assert rec["unit"].startswith("steps/sec (1 x cpu); audio-sec/sec=")
    assert "vs_baseline is null" in err


def test_bench_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the bench would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
