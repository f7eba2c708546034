"""Multi-process harness of the port's data-parallel tests: gloo ranks on
the CPU, each a Python process of its own, joined on a free loopback
port.

``run_ranks(tmp, fn, kwargs, world)`` runs ``fn(rank, world, **kwargs)``
(a function of this module, so a rank imports no JAX) in ``world``
processes after ``init_distributed`` and returns each rank's result;
``run_cli_ranks(tmp, argv_of, world)`` runs ``python -m`` command lines,
one per rank. A rank that exits non-zero or outlives ``timeout`` fails
the test with its output.

    python tests/torch_port_ranks.py SPEC RANK WORLD PORT OUT

is a rank's own entry point; ``python -m torch_port_ranks --cli STEPS
ARGS`` runs the training CLI with STEPS steps a --synthetic epoch.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
# a rank that runs this long has hung: the test fails, the ranks are killed
RANK_TIMEOUT = 240


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, HERE] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                        if p])
    env["OMP_NUM_THREADS"] = "1"
    return env


def _wait(procs, timeout, what):
    import pytest
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"{what}: a rank did not finish in {timeout} s")
        outs.append((p.returncode, out))
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"{what}: rank {r} exited {rc}:\n{out[-4000:]}"
    return [out for _, out in outs]


def run_ranks(tmp, fn, kwargs, world=2, timeout=RANK_TIMEOUT):
    """[fn's result on each rank] of ``world`` gloo ranks on the CPU."""
    tmp = str(tmp)
    spec = os.path.join(tmp, f"{fn}.spec.pkl")
    with open(spec, "wb") as f:
        pickle.dump({"fn": fn, "kwargs": kwargs}, f)
    port = str(free_port())
    outs = [os.path.join(tmp, f"{fn}.rank{r}.pkl") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), spec, str(r), str(world),
         port, outs[r]], cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    _wait(procs, timeout, fn)
    results = []
    for path in outs:
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results


def run_cli_ranks(argv_of, world=2, timeout=RANK_TIMEOUT):
    """Each rank's (stdout + stderr) of ``python -m <argv_of(rank,
    world, port)>``."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m"] + argv_of(r, world, port), cwd=REPO,
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    return _wait(procs, timeout, "CLI ranks")


def rank_rows(text, rank):
    """The metric records a rank > 0 printed (``log.MetricLogger``)."""
    import json
    tag = f"[rank {rank}] "
    return [json.loads(line[len(tag):]) for line in text.splitlines()
            if line.startswith(tag)]


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------


def _np(t):
    """A tensor (or an array) as a float64 numpy array."""
    if isinstance(t, np.ndarray):
        return t.astype(np.float64)
    return t.detach().double().cpu().numpy()


def rank_sides(model, force, batch, rows):
    """This rank's part of each global PReLU mask of ``force`` ({module
    name: bool array [k * batch, C, ...]}, k blocks of the global batch's
    rows side by side: the encoder's chunk, ctxt and rand): its ``rows``
    of each block and, in a layer that computes column-parallel, its
    model index's channels (axis 1)."""
    import torch
    mods = dict(model.named_modules())
    out = {}
    for name, mask in force.items():
        k = mask.shape[0] // batch
        part = np.concatenate([mask[s * batch + rows.start:
                                    s * batch + rows.stop]
                               for s in range(k)])
        parents = [name.rsplit(".", i)[0] for i in range(1, name.count(".")
                                                         + 1)]
        grid = next((mods[p].tp_column for p in parents
                     if getattr(mods[p], "tp_column", None) is not None),
                    None)
        if grid is not None:
            c = part.shape[1] // grid.n_model
            part = part[:, grid.i_model * c:(grid.i_model + 1) * c]
        out[name] = torch.from_numpy(np.ascontiguousarray(part))
    return out


def train_steps(rank, world, fe_cfg, wk_cfg, cfg, variables, batches,
                gan_cfg=None, draws=None, device="cpu", sides=None):
    """Trainer steps on this rank's rows of each global batch, from the
    JAX-layout ``variables`` ({'params/...', 'batch_stats/...'}; None
    keeps the seeded init); ``cfg['n_model']`` lays the ranks out as a
    grid (the rows are the data index's). ``draws``: per step,
    {'z_real': global array} sliced to the rank's rows. Returns the
    losses of every step, and the gradients (JAX layout, leaves held as
    parts gathered whole), the BatchNorm / VQ state and the policy's
    alpha after the first, the routes and the elements this rank holds
    (parameters, Adam moments). ``device``: the ranks' (gloo on the
    card's tensors too). ``sides``: {PReLU module name: the global batch's
    bool mask of its input} forced in the first step (``rank_sides``,
    ``grad_parity.prelu_signs``); the other PReLUs keep their own."""
    import torch
    from pase_tpu_torch.checkpoint import (load_model_variables,
                                           model_state_dict_to_variables)
    from pase_tpu_torch.grad_parity import prelu_signs
    from pase_tpu_torch.parallel import tp
    from pase_tpu_torch.parallel.mesh import host_batch_slice
    from pase_tpu_torch.trainer import Trainer
    torch.set_num_threads(1)
    tr = Trainer(fe_cfg, wk_cfg, cfg, device=device, gan_cfg=gan_cfg)
    if variables is not None:
        load_model_variables(tr.model, variables)
    sl = (host_batch_slice(cfg["batch_size"]) if world > 1
          else slice(0, cfg["batch_size"]))
    specs = tp.leaf_specs(tr.model)
    force = (rank_sides(tr.model, sides, cfg["batch_size"], sl) if sides
             else None)
    losses, grads = [], None
    for i, raw in enumerate(batches):
        extra = {k: v[sl] for k, v in (draws[i] if draws else {}).items()}
        with prelu_signs(tr.model, force=force if i == 0 else None):
            out = tr.train_step({k: v[sl] for k, v in raw.items()},
                                **extra)
        losses.append({k: _np(v) for k, v in out.items()})
        if i == 0:
            grads = {k: _np(v) for k, v in model_state_dict_to_variables(
                tp.full_tensors({n: p.grad for n, p in
                                 tr.model.named_parameters()
                                 if p.grad is not None}, specs)).items()}
            if tr.discriminator is not None:
                d_specs = tp.leaf_specs(tr.discriminator)
                grads.update({f"d/{n}": _np(g) for n, g in tp.full_tensors(
                    {n: p.grad for n, p in
                     tr.discriminator.named_parameters()}, d_specs).items()})
            state = {k: _np(v) for k, v in model_state_dict_to_variables(
                tp.full_tensors({k: b for k, b in tr.model.state_dict().items()
                                 if "running" in k or "ema" in k
                                 or k.endswith(".emb")}, specs)).items()}
            alpha = _np(tr.alpha)
    moments = sum(st["exp_avg"].numel() + st["exp_avg_sq"].numel()
                  for st in tr.opt.state.values() if "exp_avg" in st)
    return {"losses": losses, "grads": grads, "state": state,
            "alpha": alpha, "routes": dict(tr.model.tp_routes),
            "params": sum(p.numel() for p in tr.model.parameters()),
            "moments": moments}


def collectives(rank, world):
    """The mesh helpers' results on this rank (global_mean of its two
    rows of a 4-row batch, within and outside a row_shard)."""
    import torch
    from pase_tpu_torch.parallel import mesh
    x = torch.arange(3, dtype=torch.float32) + 10 * rank
    s = [x.clone(), torch.full((2, 2), float(rank))]
    mesh.all_reduce_(s)
    m = [x.clone()]
    mesh.all_reduce_(m, "mean")
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(rank)
    mesh.replicate(lin)
    g = mesh.RowShard(2 * rank, 2 * rank + 2, 4)
    rows = torch.arange(8, dtype=torch.float32).view(4, 2)[2 * rank:
                                                            2 * rank + 2]
    with mesh.row_shard(g):
        gmean = mesh.global_mean(rows)
    return {"global_mean": _np(gmean), "local_mean": _np(
        mesh.global_mean(rows)), "sum": _np(s[0]), "sum2": _np(s[1]),
            "mean": _np(m[0]),
            "gather": _np(mesh.gather(x)), "world": mesh.world(),
            "rank": mesh.rank(), "replicated": _np(lin.weight),
            "dict": {k: float(v) for k, v in mesh.all_reduce_dict(
                {"a": torch.tensor(float(rank)),
                 "b": torch.tensor(2.0 * rank)}).items()}}


def grid_collectives(rank, world, n_model):
    """This rank's place in the grid of ``n_model``, its rows of a batch
    of 4, and the data- and model-group collectives of x = 10 i_model +
    i_data."""
    import torch
    from pase_tpu_torch.parallel import mesh
    g = mesh.set_grid(n_model)
    x = torch.tensor([10.0 * g.i_model + g.i_data])
    s = [x.clone()]
    mesh.all_reduce_(s)
    sl = mesh.host_batch_slice(4)
    return {"place": [g.n_data, g.n_model, g.i_data, g.i_model],
            "rows": [sl.start, sl.stop], "data_sum": float(s[0][0]),
            "data_gather": mesh.gather(x)[:, 0].tolist(),
            "model_gather": mesh.gather(x, g.model_group)[:, 0].tolist()}


def tp_checkpoint(rank, world, fe_cfg, wk_cfg, cfg, batches, resume):
    """A Trainer of ``cfg`` (its n_model): with ``resume`` from the latest
    checkpoint of its save_path, else the steps of ``batches`` and a
    save; returns its train state tree (gathered: the n_model = 1
    layout) and step."""
    import torch
    from pase_tpu_torch.checkpoint import train_state_to_tree
    from pase_tpu_torch.parallel.mesh import host_batch_slice
    from pase_tpu_torch.trainer import Trainer
    torch.set_num_threads(1)
    tr = Trainer(fe_cfg, wk_cfg, cfg, device="cpu")
    if resume:
        tr.try_resume()
    sl = host_batch_slice(cfg["batch_size"])
    for raw in batches:
        tr.train_step({k: v[sl] for k, v in raw.items()})
    if not resume:
        tr.save(0)
    return {"tree": {k: np.asarray(v) for k, v in
                     train_state_to_tree(tr).items()}, "step": tr.step}


def batchnorm(rank, world, x, weight, bias, dy, dtype="float32"):
    """The port's BatchNorm1d in train mode on this rank's rows of x
    (global [B, C, T]): its output, input and parameter gradients under
    the cotangent dy, and its running stats."""
    import torch
    from pase_tpu_torch.nn import BatchNorm1d
    from pase_tpu_torch.parallel.mesh import host_batch_slice
    sl = host_batch_slice(x.shape[0], rank, world)
    bn = BatchNorm1d(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(weight))
        bn.bias.copy_(torch.as_tensor(bias))
    xt = torch.as_tensor(x[sl]).to(getattr(torch, dtype)).requires_grad_()
    y = bn.train()(xt)
    y.float().backward(torch.as_tensor(dy[sl]))
    return {"y": _np(y), "dx": _np(xt.grad), "dw": _np(bn.weight.grad),
            "db": _np(bn.bias.grad), "mean": _np(bn.running_mean),
            "var": _np(bn.running_var)}


def _main(spec, rank, world, port, out):
    import torch
    from pase_tpu_torch.parallel.mesh import init_distributed
    torch.set_num_threads(1)
    from pase_tpu_torch.precision import full_precision
    # float32 without TF32 on a card, as the tests' one process runs
    full_precision()
    with open(spec, "rb") as f:
        spec = pickle.load(f)
    assert init_distributed(f"127.0.0.1:{port}", world, rank,
                            device=spec["kwargs"].get("device", "cpu"),
                            backend="gloo")
    result = globals()[spec["fn"]](rank, world, **spec["kwargs"])
    import torch.distributed as dist
    dist.barrier()
    with open(out, "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()


def _cli(steps, argv):
    """The training CLI with ``steps`` steps a --synthetic epoch."""
    import torch
    from pase_tpu_torch import train
    torch.set_num_threads(1)
    train.SYNTHETIC_BPE = steps
    train.main(argv)


if __name__ == "__main__":
    if sys.argv[1] == "--cli":
        _cli(int(sys.argv[2]), sys.argv[3:])
    else:
        _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
              sys.argv[5])
