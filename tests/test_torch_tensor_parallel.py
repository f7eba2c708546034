"""The port's column-parallel compute (``--n_model``: parallel/mesh.py's
grid and shard_rule, parallel/tp.py's routes, the trainer's and the
checkpoint's parts) against the JAX package, on the CPU with gloo ranks
(tests/torch_port_ranks.py: a process per rank on a free loopback port).

The cfg has widths the rule shards (tests/test_cli_scripts.py's
--n_model epoch: fmaps 64-128, emb 128) with a QRNN of 128 lanes, dense
skips and norm_out, an mfcc head, a cchunk decoder head and an mi head
(hidden 128), at a global batch of 4 x 8000 with the JAX weights bridged
(BatchNorm affine params and PReLU slopes randomized). Each grid, (1 x
2), (2 x 2) and (1 x 4), is held to the JAX package's single-process step
on the global batch, which JAX's own test equates with its model-sharded
step (tests/test_graft_entry.py). Bounds, tests/test_torch_parallel.py's:
  * per-worker losses of the first step within 1e-5 relative, of the
    second within 1e-3;
  * BatchNorm running stats within 1e-6;
  * every rank's losses equal bit for bit;
  * the first step's gradients, gathered whole, within 1e-4 x max|g| per
    leaf of the port's one-process step (the biases before a BatchNorm,
    exactly 0 in exact arithmetic, below 1e-4 of the encoder's largest
    gradient on both sides, as test_torch_parallel.py bounds them against
    the port's one process); the heads' within 1e-4 x max|g| per leaf of
    JAX's, and the encoder's within 1e-3 of the encoder's largest
    gradient of JAX's (test_torch_parallel.py's bound, PERF.md section 2).
The encoder's PReLU sides are forced in the first step, on the grid and
in the port's one process, to those of the port's float64 step on the
same weights and batch (``grad_parity.prelu_signs``). A PReLU input a few
ulps from 0 takes either side of the kink at float32 rounding: unforced,
one such input of blocks.2 moves the lower encoder's gradients by up to
6e-3 of a leaf's largest away from JAX's, a kink flip, not a limit of the
arithmetic. Only the encoder's PReLUs are forced: forcing the heads' too
moves the cchunk decoder's last bias, whose L1 sum cancels, by 1.9e-4 of
its largest.
The route-3 kinds the CLI reaches (the VQ-EMA codebook, an lstm context)
are held to the port's one-process step by the same bounds.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from pase_tpu.optim import build_optimizer
from pase_tpu.parallel.mesh import get_mesh, state_shardings
from pase_tpu.scheduling import init_policy_state
from pase_tpu.trainer import Trainer as JaxTrainer
from pase_tpu.trainer import TrainState
from pase_tpu_torch.parallel import mesh, tp
from torch_port_common import port_test_guard  # noqa: F401
from torch_port_ranks import rank_rows, run_cli_ranks, run_ranks, train_steps

FE = {"kwidths": [65, 10, 5, 5], "strides": [1, 10, 4, 4],
      "fmaps": [64, 64, 128, 128], "emb_dim": 128, "norm_out": True,
      "rnn_pool": True, "rnn_dim": 128, "denseskips": True}
WORKERS = {"regr": [{"num_outputs": 39, "dropout": 0, "hidden_size": 128,
                     "hidden_layers": 1, "name": "mfcc", "r": 1,
                     "loss": "MSELoss", "skip": False},
                    {"num_outputs": 1, "dropout": 0, "hidden_layers": 1,
                     "name": "cchunk", "type": "decoder",
                     "hidden_size": 128, "fmaps": [128, 128, 64],
                     "strides": [4, 4, 10], "kwidths": [30, 30, 30],
                     "loss": "L1Loss"}],
           "cls": [{"num_outputs": 1, "dropout": 0, "hidden_size": 128,
                    "hidden_layers": 1, "name": "mi",
                    "loss": "BCEWithLogitsLoss", "skip": False}]}
BATCH, CHUNK = 4, 8000
NAMES = ["mfcc", "cchunk", "mi", "total"]
# conv biases before a BatchNorm: gradient 0 but for rounding
BN_CANCELLED = {"frontend/blocks_1/conv/bias", "frontend/blocks_2/conv/bias",
                "frontend/blocks_3/conv/bias", "frontend/W/bias"}
PASEP_FE, PASEP_WK = "cfg/frontend/PASE+.cfg", "cfg/workers/workers+.cfg"


def _cfg(save_path, n_model=1, **kw):
    return dict(dict(backprop_mode="base", hop=160, bpe=100, epoch=10,
                     batch_size=BATCH, chunk_size=CHUNK, log_freq=2,
                     fe_lr=5e-4, min_lr=5e-4, lr_mode="poly",
                     n_model=n_model, save_path=str(save_path)), **kw)


def _batches(n=2, seed=5):
    rng = np.random.RandomState(seed)
    return [{k: rng.randn(BATCH, CHUNK).astype(np.float32) * 0.1
             for k in ("chunk", "chunk_ctxt", "chunk_rand")}
            for _ in range(n)]


def _np_tree(tree):
    return {k: np.array(v) for k, v in
            flatten_dict(unfreeze(tree), sep="/").items()}


@pytest.fixture(scope="module")
def f64_sides(jax_run):
    """{encoder PReLU: the global batch's bool mask of its input's sign}
    in the port's float64 step on the first batch from the JAX weights
    (``grad_parity.step_grads``)."""
    from pase_tpu_torch.checkpoint import load_model_variables
    from pase_tpu_torch.grad_parity import step_grads
    from pase_tpu_torch.model import build_pase
    model, meta = build_pase(FE, WORKERS,
                             generator=torch.Generator().manual_seed(0))
    load_model_variables(model, jax_run[0])
    record = {}
    step_grads(model, meta, _batches()[0], "cpu", torch.float64,
               signs=record)
    return {k: (x > 0).numpy() for k, x in record.items()
            if k.startswith("frontend.")}


@pytest.fixture(scope="module")
def port_one(tmp_path_factory, jax_run, f64_sides):
    """The port's one-process step on the global batch from the same
    weights, the encoder's PReLU sides forced to the float64 step's
    (tests/torch_port_ranks.py's train_steps)."""
    tmp = tmp_path_factory.mktemp("tp_one")
    return train_steps(0, 1, FE, WORKERS,
                       _cfg(tmp / "one", log_grad_norms=True), jax_run[0],
                       _batches(), sides=f64_sides)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer's two steps on the global batch from randomized
    weights: (variables, [losses], first step's gradients, its BatchNorm
    stats)."""
    tmp = tmp_path_factory.mktemp("tp_jax")
    jtr = JaxTrainer(FE, WORKERS, _cfg(tmp / "jax"),
                     mesh=get_mesh(devices=jax.devices()[:1]))
    key = jax.random.PRNGKey(0)
    dummy = {k: jnp.zeros((2, CHUNK))
             for k in ("chunk", "chunk_ctxt", "chunk_rand")}
    prepared = jax.jit(jtr.prepare)(dummy, key)
    variables = jax.jit(lambda r, b: jtr.model.init(r, b, train=False))(
        {"params": key, "sample": key, "dropout": key}, prepared)
    params = _np_tree(variables["params"])
    rng = np.random.RandomState(7)
    for k, v in params.items():
        if k.endswith("norm/weight"):
            params[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("norm/bias"):
            params[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("act/weight"):
            params[k] = rng.uniform(0.0, 0.3, v.shape).astype(np.float32)
    p_tree = unflatten_dict({k: jnp.asarray(v) for k, v in params.items()},
                            sep="/")
    cfg = jtr.cfg
    jtr._tx, jtr._scheds = build_optimizer(
        p_tree, fe_lr=cfg["fe_lr"], min_lr=cfg["min_lr"],
        lr_mode=cfg["lr_mode"], epochs=jtr.epochs, bpe=jtr.bpe)
    state = TrainState(
        params=p_tree, batch_stats=variables["batch_stats"],
        opt_state=jtr._tx.init(p_tree),
        policy_state=init_policy_state(jtr.num_workers),
        alpha=jnp.ones((jtr.num_workers,)), rng=key,
        step=jnp.zeros((), jnp.int32))
    flat = {f"params/{k}": v for k, v in params.items()}
    flat.update({f"batch_stats/{k}": v for k, v in
                 _np_tree(state.batch_stats).items()})
    step = jtr._make_train_step()
    losses, grads, stats = [], None, None
    import optax
    for i, raw in enumerate(_batches()):
        state, out = step(state, {k: jnp.asarray(v) for k, v in raw.items()})
        losses.append({k: float(v) for k, v in out.items()})
        if i == 0:
            stats = _np_tree(state.batch_stats)
            grads = {}
            for group in state.opt_state.inner_states.values():
                adam = group.inner_state[0]
                for k, mu in flatten_dict(unfreeze(adam.mu),
                                          sep="/").items():
                    if not isinstance(mu, optax.MaskedNode):
                        grads[k] = np.asarray(mu, np.float64) / (1.0 - 0.9)
    return flat, losses, grads, stats


def _check_losses(got, want, names, rel):
    for n in names:
        g, w = float(got[n]), float(want[n])
        assert abs(g - w) <= rel * abs(w), (n, g, w)


def _check_grads(got, want, cancelled=BN_CANCELLED, noise=1e-5,
                 fe_max=None):
    if fe_max is None:
        fe_max = max(np.abs(g).max() for k, g in want.items()
                     if k.startswith("frontend/"))
    for k, g in want.items():
        mine = got["params/" + k] if "params/" + k in got else got[k]
        assert mine.shape == g.shape, k
        if k in cancelled:
            assert np.abs(g).max() <= noise * fe_max, k
            assert np.abs(mine).max() <= noise * fe_max, k
            continue
        err = np.abs(mine - g).max()
        assert err <= 1e-4 * np.abs(g).max(), (k, err, np.abs(g).max())


def _check_encoder_grads(got, want, bound=1e-3):
    """Every encoder leaf of ``got`` within ``bound`` of the encoder's
    largest gradient of ``want`` (the group's bound of
    test_torch_parallel.py)."""
    enc = {k: g for k, g in want.items() if k.startswith("frontend/")}
    fe_max = max(np.abs(g).max() for g in enc.values())
    assert len(enc) > 20
    for k, g in enc.items():
        mine = got["params/" + k] if "params/" + k in got else got[k]
        err = np.abs(mine - g).max()
        assert err <= bound * fe_max, (k, err, fe_max)


def _ranks_equal(outs):
    for o in outs[1:]:
        for a, b in zip(outs[0]["losses"], o["losses"]):
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# the grid and the rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("processes,n_model,want", [
    (1, 1, (1, 1)), (2, 2, (1, 2)), (4, 2, (2, 2)), (4, 4, (1, 4)),
    (8, 2, (4, 2))])
def test_grid_shape(processes, n_model, want):
    assert mesh.grid_shape(processes, n_model) == want


@pytest.mark.parametrize("processes,n_model", [(1, 2), (3, 2), (2, 4)])
def test_grid_that_does_not_divide_raises(processes, n_model):
    with pytest.raises(ValueError, match="must divide the number of "
                                         "processes"):
        mesh.grid_shape(processes, n_model)


def test_grid_groups_and_collectives(tmp_path):
    """Four gloo ranks at 2 x 2: rank r is (i_data, i_model) = divmod(r,
    2); the data helpers reduce over the data group (the ranks of one
    i_model), the model group gathers the ranks of one i_data; the rows
    are the data index's."""
    outs = run_ranks(tmp_path, "grid_collectives", {"n_model": 2}, world=4)
    for r, o in enumerate(outs):
        assert o["place"] == [2, 2, r // 2, r % 2]
        assert o["rows"] == [2 * (r // 2), 2 * (r // 2) + 2]
        # data group: the ranks of one i_model (r % 2), i_data = 0, 1
        assert o["data_sum"] == 10 * (r % 2) * 2 + 0 + 1
        assert o["data_gather"] == [10 * (r % 2), 10 * (r % 2) + 1]
        assert o["model_gather"] == [10 * 0 + r // 2, 10 * 1 + r // 2]


@pytest.mark.parametrize("n_model", [2, 4])
def test_shard_rule_is_jaxs_state_shardings_on_pase_plus(n_model):
    """mesh.shard_rule on every leaf of the PASE+ / workers+ model (its
    JAX shape through checkpoint.jax_leaf_layout) shards exactly the JAX
    leaves ``state_shardings`` puts on the 'model' axis of JAX's 8-device
    CPU mesh (no compile: the init's shapes)."""
    from pase_tpu_torch.checkpoint import model_state_dict_to_variables
    from pase_tpu_torch.model import build_pase
    jtr = JaxTrainer(PASEP_FE, PASEP_WK, _cfg("unused"),
                     mesh=get_mesh(devices=jax.devices()[:1]))
    key = jax.random.PRNGKey(0)
    dummy = {k: jnp.zeros((2, 32000))
             for k in ("chunk", "chunk_ctxt", "chunk_rand")}
    prepared = jax.eval_shape(jtr.prepare, dummy, key)
    shapes = jax.eval_shape(lambda r, b: jtr.model.init(r, b, train=False),
                            {"params": key, "sample": key, "dropout": key},
                            prepared)
    jmesh = get_mesh(n_data=8 // n_model, n_model=n_model)
    want = {}
    for col in ("params", "batch_stats"):
        sh = state_shardings(shapes[col], jmesh)
        for k, s in flatten_dict(unfreeze(sh), sep="/").items():
            want[f"{col}/{k}"] = "model" in tuple(s.spec)
    model, _ = build_pase(PASEP_FE, PASEP_WK,
                          generator=torch.Generator().manual_seed(0))
    sharded = tp.rule_sharded(model, n_model)
    got = {}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        (jkey, arr), = model_state_dict_to_variables({name: t}).items()
        assert arr.shape == tuple(
            flatten_dict(unfreeze(shapes), sep="/")[jkey].shape), jkey
        got[jkey] = name in sharded
    assert got == want
    assert sum(want.values()) > 100


PASEP_ROUTES = {
    "frontend": "column", "frontend.rnn": "lanes",
    **{f"frontend.blocks.{i}": "column" for i in range(8)},
    **{f"workers.cchunk.blocks.{i}": "column" for i in range(4)},
}


@pytest.mark.parametrize("n_model", [2, 4])
def test_pase_plus_routes_and_parts(n_model):
    """The route of every PASE+ / workers+ layer at n_model 2 and 4: the
    encoder's blocks and output column-parallel, the QRNN by lanes, every
    MLP block and decoder block column-parallel, a head's final conv
    column-parallel where the rule shards its width (fbank 840, mfcc_long
    420, prosody 84 at n_model 2 and 4; mfcc 273 and the fused lps heads'
    21525 do not divide: replicated), no layer gathered (route 3); each
    part holds 1 / n_model of its leaf, every other leaf is whole. The
    layout cuts the seeded init without a process group (the grid's
    place given)."""
    from pase_tpu_torch.model import build_pase
    gen = torch.Generator().manual_seed(0)
    full, _ = build_pase(PASEP_FE, PASEP_WK, generator=gen)
    model, meta = build_pase(PASEP_FE, PASEP_WK,
                             generator=torch.Generator().manual_seed(0))
    sharded = tp.rule_sharded(model, n_model)
    grid = mesh.Grid(1, n_model, 0, n_model - 1, None, None)
    routes = tp.shard_model(model, grid)
    want = dict(PASEP_ROUTES)
    for e in meta["regr"] + meta["cls"]:
        name = e["name"]
        if name != "cchunk":
            want[f"workers.{name}.blocks.0"] = "column"
        width = e["num_outputs"] * e.get("r", 1)
        if mesh.shard_rule((width,), n_model) and name != "cchunk":
            want[f"workers.{name}.W"] = "column"
    assert routes == want
    assert "gathered" not in routes.values()
    part = dict(model.state_dict())
    specs = tp.leaf_specs(model)
    assert set(specs) == set(sharded)
    for k, v in full.state_dict().items():
        if k in specs:
            assert part[k].numel() * n_model == v.numel(), k
            torch.testing.assert_close(
                part[k], tp.own(v, specs[k], n_model, n_model - 1),
                rtol=0, atol=0)
        else:
            assert torch.equal(part[k], v), k


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


GRIDS = {"1x2": (2, 2), "2x2": (4, 2), "1x4": (4, 4)}


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_grid_step_matches_the_jax_global_step(tmp_path, jax_run, port_one,
                                               f64_sides, grid):
    """Each rank of the grid holds its parts and computes its channels,
    the encoder's PReLU sides forced to the float64 step's (the rank's
    rows and channels of each mask); the losses and the BatchNorm stats
    are the JAX step's on the global batch, the gradients (gathered
    whole) JAX's, the heads' per leaf and the encoder's against its
    largest, and every gradient the port's one process's, and so the
    ``grad_norm/*`` rows (the parts' squares summed over the model group)
    within 1e-5 relative; every rank's losses the same bits; the
    parameters and Adam moments per rank 1 / n_model of the sharded
    leaves plus the whole replicated ones."""
    world, n_model = GRIDS[grid]
    variables, jlosses, jgrads, jstats = jax_run
    one = {k[len("params/"):]: v for k, v in port_one["grads"].items()}
    _check_encoder_grads(port_one["grads"], jgrads)
    outs = run_ranks(tmp_path, "train_steps", dict(
        fe_cfg=FE, wk_cfg=WORKERS,
        cfg=_cfg(tmp_path / "port", n_model, log_grad_norms=True),
        variables=variables, batches=_batches(), sides=f64_sides),
        world=world)
    _ranks_equal(outs)
    _check_losses(outs[0]["losses"][0], jlosses[0], NAMES, 1e-5)
    _check_losses(outs[0]["losses"][1], jlosses[1], NAMES, 1e-3)
    norms = [k for k in port_one["losses"][0] if k.startswith("grad_norm/")]
    assert len(norms) == 4
    _check_losses(outs[0]["losses"][0], port_one["losses"][0], norms, 1e-5)
    for o in outs:
        _check_grads(o["grads"], one, noise=1e-4)
        _check_grads(o["grads"], {k: g for k, g in jgrads.items()
                                  if not k.startswith("frontend/")},
                     fe_max=1.0)
        _check_encoder_grads(o["grads"], jgrads)
        for k, v in jstats.items():
            err = np.abs(o["state"]["batch_stats/" + k] - v).max()
            assert err <= 1e-6, (k, err)
        assert o["routes"]["frontend.rnn"] == "lanes"
        assert "gathered" not in o["routes"].values()
    # the elements a rank holds: the sharded leaves' parts and the rest
    whole = {k: np.asarray(v).size for k, v in variables.items()
             if k.startswith("params/")}
    n_sharded = sum(n for k, n in whole.items()
                    if mesh.shard_rule(np.shape(variables[k]), n_model))
    want = sum(whole.values()) - n_sharded + n_sharded // n_model
    assert all(o["params"] == want for o in outs)
    assert all(o["moments"] == 2 * want for o in outs)


ROUTE3 = {
    "vq": dict(FE, vq_K=64),
    "lstm": dict(FE, rnn_type="lstm"),
}


@pytest.mark.parametrize("variant", sorted(ROUTE3))
def test_route3_step_matches_the_one_process_step(tmp_path, variant):
    """The route-3 kinds the CLI reaches: the VQ-EMA codebook and EMA
    state ([K, D] with D = 128, held as parts, gathered for the
    quantizer, the EMA update written back) and the lstm context (its
    torch-layout leaves [4H, in] sharded on in), on two model ranks,
    against the port's one process on the global batch (the codebook
    within 1e-5 of its largest)."""
    fe = ROUTE3[variant]
    kw = dict(fe_cfg=fe, wk_cfg=WORKERS, variables=None, batches=_batches())
    one = train_steps(0, 1, cfg=_cfg(tmp_path / "one"), **kw)
    outs = run_ranks(tmp_path, "train_steps",
                     dict(kw, cfg=_cfg(tmp_path / "tp", 2)), world=2)
    _ranks_equal(outs)
    names = list(one["losses"][0])
    _check_losses(outs[0]["losses"][0], one["losses"][0], names, 1e-5)
    _check_losses(outs[0]["losses"][1], one["losses"][1], names, 1e-3)
    host = "frontend.quantizer" if variant == "vq" else "frontend.rnn"
    assert outs[0]["routes"][host] == "gathered"
    _check_grads(outs[0]["grads"],
                 {k[len("params/"):]: v for k, v in one["grads"].items()},
                 noise=1e-4)
    for k, v in one["state"].items():
        err = np.abs(outs[0]["state"][k] - v).max()
        bound = 1e-6 if "/norm" in k else 1e-5 * max(np.abs(v).max(), 1.0)
        assert err <= bound, (k, err)


# ---------------------------------------------------------------------------
# the state: checkpoints in the n_model = 1 layout
# ---------------------------------------------------------------------------


def test_checkpoint_of_two_model_ranks_resumes_in_one_process(tmp_path):
    """A train state saved by two model ranks (each gathering its parts,
    rank 0 writing) is the gathered parts bit for bit, and one process
    resumes from it to the same tree; that process's checkpoint resumes
    at n_model 2, each rank taking its parts, to the same tree again."""
    from pase_tpu_torch.trainer import Trainer
    save = tmp_path / "run"
    outs = run_ranks(tmp_path, "tp_checkpoint", dict(
        fe_cfg=FE, wk_cfg=WORKERS, cfg=_cfg(save, 2), batches=_batches(1),
        resume=False), world=2)
    tree = outs[0]["tree"]
    assert all(np.array_equal(outs[1]["tree"][k], v) for k, v in tree.items())
    one = Trainer(FE, WORKERS, _cfg(save), device="cpu")
    assert one.try_resume() == 1
    from pase_tpu_torch.checkpoint import train_state_to_tree
    mine = train_state_to_tree(one)
    assert mine.keys() == tree.keys()
    for k, v in tree.items():
        assert np.array_equal(np.asarray(mine[k]), v), k
    # one process steps on and saves; two model ranks resume from it
    one.train_step(_batches(1, seed=9)[0])
    one.save(1)
    want = {k: np.asarray(v) for k, v in train_state_to_tree(one).items()}
    outs = run_ranks(tmp_path, "tp_checkpoint", dict(
        fe_cfg=FE, wk_cfg=WORKERS, cfg=_cfg(save, 2), batches=[],
        resume=True), world=2)
    for o in outs:
        assert o["step"] == 2
        for k, v in want.items():
            assert np.array_equal(o["tree"][k], v), k


def test_train_cli_n_model_2_epoch(tmp_path):
    """Two gloo ranks of the training CLI at --n_model 2 (a 1 x 2 grid)
    train a cut --synthetic epoch (3 steps and an eval batch): rank 0
    prints the grid and writes FE_e0.npz (the n_model = 1 layout, which
    a one-process encoder loads) and metrics.jsonl, rank 1's rows equal
    them bit for bit."""
    from pase_tpu_torch.frontend import wf_builder
    fe, wk = tmp_path / "fe.cfg", tmp_path / "wk.cfg"
    fe.write_text(json.dumps(FE))
    wk.write_text(json.dumps(WORKERS))
    run = tmp_path / "run"
    outs = run_cli_ranks(lambda r, n, port: [
        "torch_port_ranks", "--cli", "3", "--synthetic", "--device", "cpu",
        "--fe_cfg", str(fe), "--net_cfg", str(wk), "--batch_size", "4",
        "--chunk_size", "4800", "--epoch", "1", "--log_freq", "1",
        "--n_model", "2", "--save_path", str(run),
        "--coordinator_address", f"127.0.0.1:{port}",
        "--num_processes", str(n), "--process_id", str(r)])
    assert "mesh: {'data': 1, 'model': 2}" in outs[0]
    assert os.path.isfile(run / "FE_e0.npz")
    enc = wf_builder(str(fe), device="cpu")
    enc.load_pretrained(str(run / "FE_e0.npz"))
    with open(run / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    strip = [{k: v for k, v in r.items() if k != "t"} for r in rows
             if r["split"] in ("train", "eval")]
    ours = [{k: v for k, v in r.items() if k != "t"}
            for r in rank_rows(outs[1], 1) if r["split"] in ("train", "eval")]
    assert len(strip) == 4 and strip == ours
    assert all(np.isfinite(v) for r in strip for v in r.values()
               if isinstance(v, float))
