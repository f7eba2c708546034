"""The port's weight bridge (pase_tpu_torch.checkpoint) against the JAX
package's checkpoints: a native .npz written by
``pase_tpu.checkpoint.save_variables`` and the reference-layout .ckpt
written by ``util_scripts.py export-torch`` both load strictly, with
equal arrays after the layout transposes, and the port's own .npz writer
produces a file the JAX package loads."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pase_tpu import frontend as jax_frontend
from pase_tpu.checkpoint import load_variables, save_variables
from pase_tpu_torch import wf_builder
from pase_tpu_torch.checkpoint import (load_variables_npz,
                                       save_variables_npz,
                                       state_dict_to_variables,
                                       variables_to_state_dict)
from torch_port_common import (NARROW_CFG, PASEP_CFG, flat_variables,
                               jax_variables, rel_err)
from torch_port_common import port_test_guard  # noqa: F401


@pytest.fixture(scope="module")
def narrow_npz(tmp_path_factory):
    """A native FE npz of the narrow encoder with non-trivial stats."""
    module = jax_frontend.build_wavefe(NARROW_CFG)
    variables = jax_variables(module, 4000, seed=2)
    path = str(tmp_path_factory.mktemp("ckpt") / "FE_e0.npz")
    save_variables(path, variables, step=0)
    return path, flat_variables(variables)


def _assert_same_arrays(port_state_dict, jax_flat):
    got = state_dict_to_variables(port_state_dict)
    assert sorted(got) == sorted(jax_flat)
    for k, v in jax_flat.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_native_npz_loads_strict_and_equal(narrow_npz):
    path, flat = narrow_npz
    enc = wf_builder(NARROW_CFG, device="cpu", seed=5)
    enc.load_pretrained(path)
    _assert_same_arrays(enc.module.state_dict(), flat)
    # the layouts: conv kernel [K, Cin, Cout] -> [Cout, Cin, K]
    np.testing.assert_array_equal(
        enc.module.state_dict()["blocks.1.conv.weight"].numpy(),
        flat["params/blocks_1/conv/kernel"].transpose(2, 1, 0))
    np.testing.assert_array_equal(
        enc.module.state_dict()["rnn.layers.0.linear.weight"].numpy(),
        flat["params/rnn/layers_0_linear/kernel"].T)


def test_export_torch_ckpt_loads_strict(narrow_npz, tmp_path):
    """The reference-layout state dict of util_scripts.export_torch loads
    into the port with strict=True: the port's names are the reference's."""
    import util_scripts
    path, flat = narrow_npz
    ckpt = str(tmp_path / "FE_e0.ckpt")
    util_scripts.export_torch(argparse.Namespace(in_ckpt=path,
                                                 out_ckpt=ckpt))
    exported = torch.load(ckpt, weights_only=True)
    enc = wf_builder(NARROW_CFG, device="cpu", seed=5)
    assert sorted(exported) == sorted(enc.module.state_dict())
    enc.load_pretrained(ckpt)
    _assert_same_arrays(enc.module.state_dict(), flat)


def test_port_npz_loads_in_jax(tmp_path):
    """save_variables_npz (the port's writer) -> the JAX package's
    load_variables reads it, and its Encoder computes what the port
    computes."""
    enc = wf_builder(NARROW_CFG, device="cpu", seed=9)
    path = save_variables_npz(str(tmp_path / "FE_port.npz"),
                              enc.module.state_dict())
    jenc = jax_frontend.wf_builder(NARROW_CFG)
    jenc.variables, meta = load_variables(path)
    assert meta == {"step": 0}
    x = (np.random.RandomState(0).randn(1, 1, 4000) * 0.1).astype(np.float32)
    y_jax = np.asarray(jenc(x))
    y = enc(x).numpy()
    assert y.shape == y_jax.shape == (1, 8, 100)
    assert rel_err(y, y_jax) <= 1e-4


def test_pase_plus_keys_cover_both_ways():
    """Every variable of the JAX PASE+ encoder maps onto the port's state
    dict and back (strict load, identical key sets)."""
    module = jax_frontend.build_wavefe(PASEP_CFG)
    variables = jax.jit(module.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((1, 1600)), train=False)
    flat = flat_variables(variables)
    enc = wf_builder(PASEP_CFG, device="cpu")
    sd = variables_to_state_dict(flat)
    missing = set(enc.module.state_dict()) - set(sd)
    assert all(k.endswith("num_batches_tracked") for k in missing)
    enc.module.load_state_dict(dict(enc.module.state_dict(), **sd), strict=True)
    _assert_same_arrays(enc.module.state_dict(), flat)


def test_load_variables_npz_skips_meta(narrow_npz):
    path, flat = narrow_npz
    got = load_variables_npz(path)
    assert "__meta__" not in got and sorted(got) == sorted(flat)


# ---------------------------------------------------------------------------
# full train-state checkpoints: Saver, resume, both packages' layouts
# ---------------------------------------------------------------------------

def _small_trainer(save_path, **over):
    from test_torch_train import SMALL_FE, _cfg, small_workers
    from pase_tpu_torch.trainer import Trainer
    cfg = dict(_cfg(save_path), bpe=2, log_freq=1, **over)
    return Trainer(SMALL_FE, small_workers(), cfg, device="cpu",
                   dist_cfg=_DCFG, dist_assets=_assets())


def _assets(t=4800):
    from pase_tpu_torch.data.distortions import DistortionAssets
    rng = np.random.RandomState(0)
    ir = np.zeros((2, 1000), np.float32)
    ir[:, 0] = 1.0
    ir[0, 300] = 0.4
    return DistortionAssets(
        ir_bank=torch.from_numpy(ir), ir_pmax=torch.zeros(2, dtype=torch.int32),
        noise_bank=torch.from_numpy(rng.randn(3, 2 * t).astype(np.float32)
                                    * 0.1))


def _dcfg():
    from pase_tpu_torch.data.distortions import DistortionConfig
    return DistortionConfig(reverb_p=0.5, noises_p=0.5, clip_p=0.3,
                            chop_p=0.3)


_DCFG = _dcfg()


def _train_losses(path):
    import json
    with open(path / "metrics.jsonl") as f:
        return {r["step"]: r for r in map(json.loads, f)
                if r["split"] == "train"}


def _opt_state(tr):
    return {n: {k: v.clone() for k, v in tr.opt.state[p].items()}
            for n, p in tr.model.named_parameters()}


def test_resume_is_bit_identical_to_the_uninterrupted_run(tmp_path):
    """2 steps, save, a new Trainer resumes, 2 more steps == 4 steps in one
    run: the logged losses of steps 3-4, every parameter and buffer and
    Adam's state bit for bit (device batches and distortion draws derive
    from (seed, step), the rest is in the checkpoint)."""
    from pase_tpu_torch.data.dataset import DeviceSyntheticBatcher

    def batcher():
        return DeviceSyntheticBatcher(2, 4800, seed=1, device="cpu")

    whole = _small_trainer(tmp_path / "whole", epoch=2)
    whole.train_(batcher())
    first = _small_trainer(tmp_path / "cut", epoch=2)
    first.train_(batcher(), epochs=1)         # cut after the first epoch
    assert first.step == 2
    # another seed: the checkpoint's torch/seed keeps the saved run's
    # draws, and its weights replace the fresh init
    resumed = _small_trainer(tmp_path / "cut", epoch=2, seed=99)
    resumed.train_(batcher())
    assert resumed.step == whole.step == 4
    for tr in (whole, resumed):
        tr.logger.close()
    want, got = _train_losses(tmp_path / "whole"), _train_losses(
        tmp_path / "cut")
    for step in (3, 4):
        for k, v in want[step].items():
            if k != "t":
                assert got[step][k] == v, (step, k)
    for k, v in whole.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(resumed.model.state_dict()[k], v), k
    w_opt, r_opt = _opt_state(whole), _opt_state(resumed)
    for n, st in w_opt.items():
        for k, v in st.items():
            assert torch.equal(r_opt[n][k], v), (n, k)


def test_saver_retention_and_write_order(tmp_path, monkeypatch):
    import json
    from pase_tpu_torch import checkpoint as ck
    saver = ck.Saver(str(tmp_path), max_ckpts=2, prefix="PASE-")
    for step in (1, 2, 3):
        saver.save("m", {"step": np.asarray(step, np.int32)}, step)
    files = sorted(p.name for p in tmp_path.glob("weights_*"))
    assert files == ["weights_PASE-m-2.npz", "weights_PASE-m-3.npz"]
    with open(tmp_path / "PASE-checkpoints") as f:
        index = json.load(f)
    assert index == {"latest": ["PASE-m-2.npz", "PASE-m-3.npz"],
                     "current": "PASE-m-3.npz"}
    flat, meta = saver.load_weights()
    assert meta == {"step": 3} and int(flat["step"]) == 3

    def fail(*a, **k):
        raise OSError("disk full")

    # a failed weights write leaves the index and the kept files alone
    monkeypatch.setattr(ck, "save_variables", fail)
    with pytest.raises(OSError):
        saver.save("m", {}, 4)
    with open(tmp_path / "PASE-checkpoints") as f:
        assert json.load(f) == index
    assert sorted(p.name for p in tmp_path.glob("weights_*")) == files


def test_saver_index_write_cut_short_keeps_the_old_index(tmp_path,
                                                         monkeypatch):
    """A process that dies while the index is written (here: before the
    rename of its new copy) leaves the previous index whole, naming the
    previous checkpoint, and the next save completes over it."""
    import json
    from pase_tpu_torch import checkpoint as ck
    saver = ck.Saver(str(tmp_path), max_ckpts=5, prefix="PASE-")
    saver.save("m", {"step": np.asarray(1, np.int32)}, 1)
    with open(tmp_path / "PASE-checkpoints") as f:
        index = json.load(f)

    def killed(*a, **k):
        raise KeyboardInterrupt

    with monkeypatch.context() as m:
        m.setattr(ck.os, "replace", killed)
        with pytest.raises(KeyboardInterrupt):
            saver.save("m", {"step": np.asarray(2, np.int32)}, 2)
    with open(tmp_path / "PASE-checkpoints") as f:
        assert json.load(f) == index
    assert saver.load_weights()[1] == {"step": 1}
    saver.save("m", {"step": np.asarray(3, np.int32)}, 3)
    assert saver.load_weights()[1] == {"step": 3}


def test_legacy_weights_only_checkpoint_warns(tmp_path, capsys):
    from pase_tpu_torch.checkpoint import model_state_dict_to_variables
    from pase_tpu_torch.trainer import NAME
    src = _small_trainer(tmp_path / "src", seed=4)
    flat = model_state_dict_to_variables(src.model.state_dict())
    tr = _small_trainer(tmp_path)
    tr.saver.save(NAME, flat, 5)
    assert tr.try_resume() == 5
    assert "legacy checkpoint without optimizer state" in \
        capsys.readouterr().err
    assert tr.step == 5 and tr.opt_count == 0 and not tr.opt.state
    for k, v in src.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(tr.model.state_dict()[k], v), k


def test_step_mismatch_and_missing_leaves_raise(tmp_path):
    from pase_tpu_torch.checkpoint import train_state_to_tree
    from pase_tpu_torch.trainer import NAME
    tr = _small_trainer(tmp_path)
    flat = train_state_to_tree(tr)
    tr.saver.save(NAME, flat, 7)          # the state's own step is 0
    with pytest.raises(ValueError, match="step mismatch"):
        tr.try_resume()
    flat.pop("opt_state/inner_states/minion/inner_state/0/count")
    tr.saver.save(NAME, flat, 0)
    with pytest.raises(ValueError, match="missing TrainState leaves"):
        tr.try_resume()


def test_load_last_false_skips_the_last_two_entries(narrow_npz, tmp_path):
    import util_scripts
    path, flat = narrow_npz
    ckpt = str(tmp_path / "FE_e0.ckpt")
    util_scripts.export_torch(argparse.Namespace(in_ckpt=path,
                                                 out_ckpt=ckpt))
    exported = torch.load(ckpt, weights_only=True)
    enc = wf_builder(NARROW_CFG, device="cpu", seed=5)
    fresh = {k: v.clone() for k, v in enc.module.state_dict().items()}
    enc.load_pretrained(ckpt, load_last=False)
    keys = list(exported)
    for k in keys[:-2]:
        assert torch.equal(enc.module.state_dict()[k], exported[k]), k
    for k in keys[-2:]:
        assert torch.equal(enc.module.state_dict()[k], fresh[k]), k
    # a native .npz loads whole whatever load_last says
    enc.load_pretrained(path, load_last=False)
    _assert_same_arrays(enc.module.state_dict(), flat)


def test_pretrained_ckpt_warm_starts_the_encoder(tmp_path):
    src = _small_trainer(tmp_path / "src", seed=8)
    npz = src.save(0)
    tr = _small_trainer(tmp_path / "dst", pretrained_ckpt=npz)
    for k, v in src.model.frontend.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(tr.model.frontend.state_dict()[k], v), k


@pytest.fixture(scope="module")
def jax_small(tmp_path_factory):
    """The JAX Trainer of test_torch_train's small model (no distortions),
    its initial state, its compiled step and three batches."""
    from pase_tpu.data.dataset import SyntheticChunkBatcher as JaxBatcher
    from pase_tpu.parallel.mesh import get_mesh
    from pase_tpu.trainer import Trainer as JaxTrainer
    from test_torch_train import SMALL_FE, _cfg, _init_state, small_workers
    tmp = tmp_path_factory.mktemp("jaxckpt")
    jtr = JaxTrainer(SMALL_FE, small_workers(), _cfg(tmp),
                     mesh=get_mesh(devices=jax.devices()[:1]))
    state = _init_state(jtr)
    it = iter(JaxBatcher(2, 4800, seed=3))
    return jtr, state, jtr._make_train_step(), [next(it) for _ in range(3)]


def test_jax_checkpoint_resumes_in_the_port(jax_small, tmp_path):
    """A JAX Trainer's checkpoint after 2 steps resumes in the port: Adam
    moments within 1e-6 after the bridge, and the port's step 3 within
    1e-3 relative of JAX's step 3 per worker."""
    from flax.traverse_util import flatten_dict
    from pase_tpu_torch.checkpoint import model_state_dict_to_variables
    from pase_tpu_torch.trainer import Trainer
    from test_torch_train import SMALL_FE, _cfg, small_workers
    jtr, state, step, batches = jax_small
    jtr.save_path = str(tmp_path)
    jtr.saver.save_path = str(tmp_path)
    jtr.saver.index_path = str(tmp_path / "PASE-checkpoints")
    state = jax.tree.map(lambda a: jnp.array(a, copy=True), state)
    for raw in batches[:2]:
        state, _ = step(state, {k: jnp.asarray(v) for k, v in raw.items()})
    jtr.save(state, 0)
    tr = Trainer(SMALL_FE, small_workers(), _cfg(tmp_path), device="cpu")
    assert tr.try_resume() == 2 and tr.opt_count == 2
    for group, gst in state.opt_state.inner_states.items():
        adam = gst.inner_state[0]
        for leaf, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            want = {k: np.asarray(v) for k, v in flatten_dict(
                getattr(adam, leaf), sep="/").items()
                if isinstance(v, jax.Array)}
            got = model_state_dict_to_variables(
                {n: tr.opt.state[p][key]
                 for n, p in tr.model.named_parameters()})
            for k, w in want.items():
                err = np.abs(got["params/" + k] - w).max()
                assert err <= 1e-6, (group, leaf, k, err)
    state, jlosses = step(state, {k: jnp.asarray(v)
                                  for k, v in batches[2].items()})
    losses = tr.train_step(batches[2])
    for name in tr.ordered_names:
        got, want = float(losses[name]), float(jlosses[name])
        assert abs(got - want) <= 1e-3 * abs(want), (name, got, want)


def test_port_checkpoint_passes_the_jax_strict_restore(jax_small, tmp_path):
    """The port's train-state file after one step loads with the JAX
    package's load_variables and restore_train_state (strict) into the
    JAX Trainer's TrainState, with the port's numbers."""
    from flax.traverse_util import flatten_dict
    from pase_tpu.checkpoint import restore_train_state
    from pase_tpu_torch.checkpoint import model_state_dict_to_variables
    jtr, state, _, batches = jax_small
    from pase_tpu_torch.trainer import Trainer
    from test_torch_train import SMALL_FE, _cfg, small_workers
    tr = Trainer(SMALL_FE, small_workers(), _cfg(tmp_path), device="cpu")
    tr.train_step(batches[0])
    tr.save(0)
    tree, meta = load_variables(
        str(tmp_path / "weights_PASE-Pase_base-1.npz"))
    assert meta == {"step": 1}
    restored = restore_train_state(jax.device_get(state), tree)
    assert int(restored.step) == 1
    got = {"params/" + k: np.asarray(v) for k, v in
           flatten_dict(restored.params, sep="/").items()}
    want = model_state_dict_to_variables(tr.model.state_dict())
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    for gst in restored.opt_state.inner_states.values():
        assert int(gst.inner_state[0].count) == 1
        assert int(gst.inner_state[1].count) == 1


def test_train_cli_resumes_keeps_max_ckpts_and_starts_afresh(tmp_path,
                                                             monkeypatch):
    """python -m pase_tpu_torch.train at 2 steps an epoch, bf16 on the CPU:
    a second call with --epoch 2 resumes at step 2; --max_ckpts 1 keeps
    one train-state file; --no_continue True starts from step 0."""
    import json
    from pase_tpu_torch import train as port_train
    from test_torch_train import SMALL_FE, small_workers
    monkeypatch.setattr(port_train, "SYNTHETIC_BPE", 2)
    fe, net = tmp_path / "fe.cfg", tmp_path / "net.cfg"
    fe.write_text(json.dumps(SMALL_FE))
    net.write_text(json.dumps(small_workers()))
    save = tmp_path / "run"

    def run(*flags):
        tr = port_train.main([
            "--synthetic", "--device", "cpu", "--net_cfg", str(net),
            "--fe_cfg", str(fe), "--batch_size", "2", "--chunk_size",
            "4800", "--save_path", str(save), "--compute_dtype",
            "bfloat16", "--max_ckpts", "1", "--log_freq", "1"] + list(flags))
        tr.logger.close()
        return tr

    assert run("--epoch", "1").step == 2
    tr = run("--epoch", "2")
    assert tr.step == 4 and tr.opt_count == 4
    assert sorted(p.name for p in save.glob("weights_*")) == [
        "weights_PASE-Pase_base-4.npz"]
    assert run("--epoch", "1", "--no_continue", "True").step == 2
