"""The JAX Trainer's observability and head-fusion keys in the port's
Trainer (``log_histograms``, ``log_grad_norms``, ``fused_heads``): one
step of each package from the same weights on the same batch, on the CPU.

The bank is small (SMALL_FE of tests/test_torch_train.py; lps, which
the default fuses with its loss, mfcc and mi at hidden 32), and the
batch carries its regression targets, so both steps read the same
labels. Bounds:
  * a histogram row's lo and hi: 1e-5 relative to max(|lo|, |hi|); its
    24 counts equal JAX's but for values within 1e-5 (hi - lo) of a bin
    edge, each of which may move one count between two neighbouring
    bins (the test counts them and bounds them at 1 % of the values);
  * grad norms: 1e-5 relative;
  * losses with ``fused_heads=False``: 1e-5 relative to the fused step's
    and to JAX's (float32 sums in another order).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pase_tpu.optim import build_optimizer
from pase_tpu.parallel.mesh import get_mesh
from pase_tpu.trainer import Trainer as JaxTrainer
from pase_tpu_torch import trainer as port_trainer
from pase_tpu_torch.checkpoint import load_model_variables
from pase_tpu_torch.data.pipeline import make_prepare_fn
from pase_tpu_torch.model import parse_workers_cfg
from pase_tpu_torch.trainer import Trainer
from test_torch_train import (BATCH, CHUNK, SMALL_FE, _fresh, _init_state,
                              _np_tree)
from pase_tpu.data.dataset import SyntheticChunkBatcher as JaxBatcher
from torch_port_common import port_test_guard  # noqa: F401

REL = 1e-5
EDGE_REL = 1e-5
NEAR_SHARE = 0.01
BINS = 24


def bank():
    with open("cfg/workers/workers+.cfg") as f:
        wk = json.load(f)
    keep = {"lps", "mfcc", "mi"}
    out = {g: [dict(e, hidden_size=32) for e in wk[g] if e["name"] in keep]
           for g in ("regr", "cls")}
    return out


def _cfg(tmp, **extra):
    return dict(backprop_mode="base", hop=160, bpe=100, epoch=10,
                batch_size=BATCH, chunk_size=CHUNK, log_freq=1, fe_lr=5e-4,
                min_lr=5e-4, lr_mode="poly", save_path=str(tmp), **extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """For fused_heads True and False: the JAX step's losses (with the
    histogram and grad-norm rows) and the port's, from one JAX init, on
    one batch; the port's histogram inputs recorded."""
    tmp = tmp_path_factory.mktemp("logs")
    raw = next(iter(JaxBatcher(BATCH, CHUNK, seed=3)))
    # both steps read the same regression targets (the prepare passes a
    # batch's targets through): the lps target, a log of near-zero STFT
    # power, differs between the packages by up to 1e-4 of its largest
    # value (tests/test_torch_features.py), which the rows would show
    with torch.no_grad():
        prepared = make_prepare_fn(parse_workers_cfg(bank()))(
            {k: torch.from_numpy(v) for k, v in raw.items()})
    raw.update({n: prepared[n].numpy() for n in ("lps", "mfcc")})
    out = {}
    state = flat = None
    for fused in (True, False):
        keys = dict(log_histograms=True, log_grad_norms=True,
                    fused_heads=fused)
        jtr = JaxTrainer(SMALL_FE, bank(), _cfg(tmp / f"j{fused}", **keys),
                         mesh=get_mesh(devices=jax.devices()[:1]))
        if state is None:
            state = _init_state(jtr)
            flat = {f"params/{k}": v for k, v in
                    _np_tree(state.params).items()}
            flat.update({f"batch_stats/{k}": v for k, v in
                         _np_tree(state.batch_stats).items()})
        else:                      # the same init, this trainer's optimizer
            cfg = jtr.cfg
            jtr._tx, jtr._scheds = build_optimizer(
                state.params, fe_lr=cfg["fe_lr"], min_lr=cfg["min_lr"],
                lr_mode=cfg["lr_mode"], epochs=jtr.epochs, bpe=jtr.bpe)
        _, jl = jtr._make_train_step()(
            _fresh(state), {k: jnp.asarray(v) for k, v in raw.items()})
        jl = {k: np.asarray(v) for k, v in jax.device_get(jl).items()}
        tr = Trainer(SMALL_FE, bank(), _cfg(tmp / f"p{fused}", **keys),
                     device="cpu")
        load_model_variables(tr.model, flat)
        seen = []
        orig = port_trainer.hist_row

        def recording(x, bins=BINS):
            seen.append(x.detach().reshape(-1).double().numpy())
            return orig(x, bins)

        port_trainer.hist_row = recording
        try:
            pl = tr.train_step(raw)
        finally:
            port_trainer.hist_row = orig
        out[fused] = (jl, {k: v.numpy() for k, v in pl.items()}, seen, tr)
    return out


def _names(tr):
    return [f"{p}{n}" for n in tr.ordered_names
            for p in ("hist/", "hist/gtruth_")]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_histogram_rows_match_jax(runs, fused):
    jl, pl, seen, tr = runs[fused]
    names = _names(tr)
    assert len(seen) == len(names) == 6
    for name, values in zip(names, seen):
        got, want = pl[name], jl[name]
        assert got.shape == want.shape == (BINS + 2,), name
        lo, hi = want[0], want[1]
        scale = max(abs(lo), abs(hi))
        assert abs(got[0] - lo) <= REL * scale, (name, got[0], lo)
        assert abs(got[1] - hi) <= REL * scale, (name, got[1], hi)
        assert got[2:].sum() == want[2:].sum() == values.size, name
        edges = lo + (hi - lo + 1e-9) * np.arange(BINS + 1) / BINS
        near = int((np.abs(values[:, None] - edges[None, 1:-1])
                    <= EDGE_REL * (hi - lo)).any(axis=1).sum())
        assert near <= NEAR_SHARE * values.size, (name, near)
        assert np.abs(got[2:] - want[2:]).sum() <= 2 * near, (
            name, got[2:], want[2:], near)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_grad_norm_rows_match_jax(runs, fused):
    jl, pl, _, _ = runs[fused]
    want = {k for k in jl if k.startswith("grad_norm/")}
    assert want == {k for k in pl if k.startswith("grad_norm/")} == {
        "grad_norm/frontend", "grad_norm/lps", "grad_norm/mfcc",
        "grad_norm/mi"}
    for k in want:
        assert abs(float(pl[k]) - float(jl[k])) <= REL * float(jl[k]), k


def test_unfused_losses_match_fused_and_jax(runs):
    fused, unfused = runs[True], runs[False]
    assert fused[3].model.fused_min_ch == 4096
    assert unfused[3].model.fused_min_ch == 0
    for name in unfused[3].ordered_names + ["total"]:
        got = float(unfused[1][name])
        for want in (float(fused[1][name]), float(unfused[0][name]),
                     float(fused[0][name])):
            assert abs(got - want) <= REL * abs(want), (name, got, want)


def test_fused_heads_false_materializes_the_lps_head(tmp_path):
    """With fused_heads=False the lps head's prediction is the [B, F, D]
    tensor (no ('linear', ...) tuple), as JAX's fused_mse_min_ch=0."""
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    raw = next(iter(SyntheticChunkBatcher(BATCH, CHUNK, seed=1)))
    for fused, want in ((True, tuple), (False, torch.Tensor)):
        tr = Trainer(SMALL_FE, bank(), _cfg(tmp_path / str(fused),
                                            fused_heads=fused),
                     device="cpu")
        with torch.no_grad():
            _, _, preds, _ = tr.model(tr.prepare(tr.ready(raw),
                                                 tr.prep_generator))
        assert isinstance(preds["lps"], want)
        assert isinstance(preds["mfcc"], torch.Tensor)


def test_logged_rows_are_json_lists(runs, tmp_path):
    """The training loop logs a histogram row as a JSON list of 26 and a
    grad norm as a number (tests/test_cli_scripts.py's
    test_histogram_logging)."""
    from pase_tpu_torch.data.dataset import DeviceSyntheticBatcher
    cfg = dict(_cfg(tmp_path, log_histograms=True, log_grad_norms=True),
               bpe=1, va_bpe=1, epoch=1)
    tr = Trainer(SMALL_FE, bank(), cfg, device="cpu")
    tr.train_(DeviceSyntheticBatcher(BATCH, CHUNK, seed=1, device="cpu"))
    tr.logger.close()
    with open(tmp_path / "metrics.jsonl") as f:
        rec = [json.loads(ln) for ln in f][0]
    assert rec["split"] == "train"
    for name in _names(tr):
        assert isinstance(rec[name], list) and len(rec[name]) == BINS + 2
        assert sum(rec[name][2:]) > 0
    assert isinstance(rec["grad_norm/frontend"], float)


def test_hist_row_edges():
    """hist_row on known values: lo, hi and the right-closed bins."""
    x = torch.tensor([0.0, 1.0, 2.0, 3.0, 24.0, 24.0])
    row = port_trainer.hist_row(x).numpy()
    assert row[0] == 0.0 and row[1] == 24.0
    counts = row[2:]
    assert counts.sum() == 6 and counts[0] == 1 and counts[1] == 1 \
        and counts[2] == 1 and counts[3] == 1 and counts[-1] == 2
