"""The port's data parallelism (pase_tpu_torch/parallel/mesh.py, the global
BatchNorm and VQ-EMA statistics of nn.py, the trainer's global step)
against the JAX package's single-process step on the global batch, on the
CPU with two gloo ranks (tests/torch_port_ranks.py: a process per rank on
a free loopback port, a timeout per run).

The narrow cfg is tests/test_multihost.py's (FeBlocks with BatchNorm and
norm_out, an mfcc and an mi worker), at a global batch of 8 x 4800 with
the JAX weights bridged (BatchNorm affine params and PReLU slopes
randomized). Bounds, as tests/test_torch_train.py's:
  * per-worker losses of the first step: 1e-5 relative; of the second:
    1e-3 (Adam's first steps are near sign(g): rounding-level gradient
    differences, as those of the biases before a BatchNorm, move a weight
    by up to 2 lr);
  * the first step's gradients: 1e-4 x max|g| per leaf (a bias before a
    BatchNorm has gradient 0: both sides below 1e-5 of the encoder's
    largest against JAX; 1e-4 against the port's one process, where
    MGD's alpha scales the encoder's gradient and its noise);
  * BatchNorm running stats after the first step: 1e-6 absolute;
  * the two ranks' losses: equal bit for bit (JAX's property,
    tests/test_multihost.py).
The VQ-EMA encoder, the MGD policy and a z-GAN worker (each with
random_scale, so the step draws gains and the z prior for the global
batch) are held to the port's one-process step on the global batch by
the same bounds (the VQ codebook state within 1e-5 of its largest).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from pase_tpu.optim import build_optimizer
from pase_tpu.parallel.mesh import get_mesh
from pase_tpu.parallel.mesh import host_batch_slice as jax_host_batch_slice
from pase_tpu.scheduling import init_policy_state
from pase_tpu.trainer import Trainer as JaxTrainer
from pase_tpu.trainer import TrainState
from pase_tpu_torch.data.pipeline import (ZeroSpeechDraws, draw_zero_speech,
                                          norm_and_scale)
from pase_tpu_torch.parallel import mesh
from torch_port_common import port_test_guard  # noqa: F401
from torch_port_ranks import run_ranks, train_steps

FE = {"kwidths": [65, 10, 5, 5], "strides": [1, 10, 4, 4],
      "fmaps": [16, 16, 32, 32], "emb_dim": 32, "norm_out": True}
WORKERS = {"regr": [{"num_outputs": 39, "dropout": 0, "hidden_size": 32,
                     "hidden_layers": 1, "name": "mfcc", "r": 1,
                     "loss": "MSELoss", "skip": False}],
           "cls": [{"num_outputs": 1, "dropout": 0, "hidden_size": 32,
                    "hidden_layers": 1, "name": "mi",
                    "loss": "BCEWithLogitsLoss", "skip": False}]}
BATCH, CHUNK = 8, 4800
BN_CANCELLED = {"frontend/blocks_1/conv/bias", "frontend/blocks_2/conv/bias",
                "frontend/blocks_3/conv/bias", "frontend/W/bias"}


def _cfg(save_path, **kw):
    return dict(dict(backprop_mode="base", hop=160, bpe=100, epoch=10,
                     batch_size=BATCH, chunk_size=CHUNK, log_freq=2,
                     fe_lr=5e-4, min_lr=5e-4, lr_mode="poly",
                     save_path=str(save_path)), **kw)


def _batches(n=2, seed=5):
    rng = np.random.RandomState(seed)
    return [{k: rng.randn(BATCH, CHUNK).astype(np.float32) * 0.1
             for k in ("chunk", "chunk_ctxt", "chunk_rand")}
            for _ in range(n)]


def _np_tree(tree):
    return {k: np.array(v) for k, v in
            flatten_dict(unfreeze(tree), sep="/").items()}


# ---------------------------------------------------------------------------
# slices, draws, collectives
# ---------------------------------------------------------------------------


def test_host_batch_slice_math():
    rows = []
    for pid in range(4):
        sl = mesh.host_batch_slice(32, process_index=pid, process_count=4)
        assert sl == jax_host_batch_slice(32, process_index=pid,
                                          process_count=4)
        rows.extend(range(sl.start, sl.stop))
    assert rows == list(range(32))
    with pytest.raises(ValueError, match="not divisible"):
        mesh.host_batch_slice(30, process_index=0, process_count=4)
    assert mesh.host_batch_slice(8) == slice(0, 8)    # no process group


def test_init_distributed_noop_single_process():
    assert mesh.init_distributed(None, None, None) is False
    assert mesh.init_distributed(None, 1, 0) is False
    assert mesh.world() == 1 and mesh.rank() == 0
    with pytest.raises(ValueError, match="coordinator_address"):
        mesh.init_distributed(None, 2, 0, device="cpu")


def test_rank_device():
    assert mesh.rank_device("cpu") == torch.device("cpu")
    assert mesh.rank_device("cuda:1") == torch.device("cuda", 1)


@pytest.mark.parametrize("k,dim", [(1, 0), (3, 0), (2, 0), (1, 1)],
                         ids=["rows", "three_streams", "two_streams",
                              "pairs_axis1"])
def test_draw_rows_keeps_the_global_draws_rows(k, dim):
    """Under a row_shard each rank's draw is its rows of the one-process
    draw (per stream where k streams sit side by side), and the generator
    advances as in one process."""
    total, per = 8, 4

    def draw(gen, m):
        shape = (m, 5) if dim == 0 else (2, m)
        return torch.rand(shape, generator=gen)

    gen = torch.Generator().manual_seed(3)
    want = draw(gen, k * total)
    after = torch.rand(3, generator=gen)
    for r in range(2):
        gen = torch.Generator().manual_seed(3)
        rows = mesh.RowShard(r * per, (r + 1) * per, total)
        with mesh.row_shard(rows):
            got = mesh.draw_rows(lambda m: draw(gen, m), k * per, dim=dim)
        parts = [want.narrow(dim, s * total + r * per, per)
                 for s in range(k)]
        assert torch.equal(got, torch.cat(parts, dim))
        assert torch.equal(torch.rand(3, generator=gen), after)
    # outside the block the draw is the one-process draw again
    gen = torch.Generator().manual_seed(3)
    assert torch.equal(mesh.draw_rows(lambda m: draw(gen, m), k * total,
                                      dim=dim), want)
    with pytest.raises(ValueError, match="whole number"):
        with mesh.row_shard(mesh.RowShard(0, 3, 6)):
            mesh.draw_rows(lambda m: torch.zeros(m), 4)


def test_prepare_draws_follow_the_row():
    """norm_and_scale's gains and the zero-speech draws (a NamedTuple) of
    a rank's rows are the one-process draws of those rows."""
    wav = torch.from_numpy(_batches(1)[0]["chunk"])
    bank = torch.randn(5, 20000, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(11)
    want_scaled = norm_and_scale(wav, gen)
    want_zs = draw_zero_speech(gen, BATCH, CHUNK, bank, (0, 5, 10))
    for r in range(2):
        sl = mesh.host_batch_slice(BATCH, r, 2)
        gen = torch.Generator().manual_seed(11)
        with mesh.row_shard(mesh.RowShard(sl.start, sl.stop, BATCH)):
            scaled = norm_and_scale(wav[sl], gen)
            zs = mesh.draw_rows(lambda m: draw_zero_speech(
                gen, m, CHUNK, bank, (0, 5, 10)), sl.stop - sl.start)
        assert torch.equal(scaled, want_scaled[sl])
        assert isinstance(zs, ZeroSpeechDraws)
        for a, b in zip(zs, want_zs):
            assert torch.equal(a, b[sl])


def test_two_rank_collectives(tmp_path):
    """all_reduce_ (sum, mean, buckets), gather, all_reduce_dict,
    replicate, and global_mean (the global batch's within a row_shard,
    the rank's rows outside one) under two gloo ranks."""
    outs = run_ranks(tmp_path, "collectives", {})
    x = [np.arange(3) + 10 * r for r in range(2)]
    for r, o in enumerate(outs):
        assert o["world"] == 2 and o["rank"] == r
        np.testing.assert_array_equal(o["sum"], x[0] + x[1])
        np.testing.assert_array_equal(o["sum2"], np.full((2, 2), 1.0))
        np.testing.assert_array_equal(o["mean"], (x[0] + x[1]) / 2)
        np.testing.assert_array_equal(o["gather"], np.stack(x))
        np.testing.assert_array_equal(o["replicated"], np.zeros((2, 3)))
        assert o["dict"] == {"a": 0.5, "b": 1.0}
        np.testing.assert_array_equal(o["global_mean"], [[3.0, 4.0]])
        np.testing.assert_array_equal(o["local_mean"],
                                      [[1.0 + 4 * r, 2.0 + 4 * r]])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_batchnorm_is_the_one_process_layer(tmp_path, dtype):
    """BatchNorm1d in train mode on two ranks' halves of a batch: the
    output rows, the input gradient rows, the summed weight / bias
    gradients and the running stats are the one-process layer's on the
    whole batch (bf16: within its rounding, the statistics in
    float32)."""
    from pase_tpu_torch.nn import BatchNorm1d
    rng = np.random.RandomState(0)
    x = (rng.randn(8, 6, 50) * 2 + 1).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    b = (rng.randn(6) * 0.1).astype(np.float32)
    dy = rng.randn(8, 6, 50).astype(np.float32)
    outs = run_ranks(tmp_path, "batchnorm", dict(x=x, weight=w, bias=b,
                                                 dy=dy, dtype=dtype))
    bn = BatchNorm1d(6)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    y = bn.train()(xt)
    y.float().backward(torch.from_numpy(dy))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7

    def close(got, want, what):
        want = want.detach().double().numpy()
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
        assert err <= tol, (what, err)

    close(np.concatenate([o["y"] for o in outs]), y, "y")
    close(np.concatenate([o["dx"] for o in outs]), xt.grad, "dx")
    close(outs[0]["dw"] + outs[1]["dw"], bn.weight.grad, "dw")
    close(outs[0]["db"] + outs[1]["db"], bn.bias.grad, "db")
    for o in outs:
        np.testing.assert_allclose(o["mean"], bn.running_mean.numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(o["var"], bn.running_var.numpy(),
                                   rtol=1e-5)
    assert np.array_equal(outs[0]["mean"], outs[1]["mean"])


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer's two steps on the global batch from randomized
    weights: (variables, [losses], first step's gradients, its BatchNorm
    stats)."""
    return _jax_steps(tmp_path_factory.mktemp("dp_jax"), {})


def _jax_steps(tmp, extra):
    """The JAX Trainer of ``_cfg(**extra)``, two steps on the global
    batch from randomized weights (an attention block's running_dist a
    random distribution)."""
    jtr = JaxTrainer(FE, WORKERS, _cfg(tmp / "jax", **extra),
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
    bstats = _np_tree(variables["batch_stats"])
    for k, v in bstats.items():
        if k.endswith("running_dist"):
            d = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            bstats[k] = d / d.sum()
    variables = {"params": variables["params"],
                 "batch_stats": unflatten_dict(
                     {k: jnp.asarray(v) for k, v in bstats.items()},
                     sep="/")}
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


def _check_grads(got, want, noise=1e-5):
    """Each leaf within 1e-4 of its largest; the biases before a BatchNorm
    (exactly 0) below ``noise`` of the encoder's largest gradient."""
    fe_max = max(np.abs(g).max() for k, g in want.items()
                 if k.startswith("frontend/"))
    for k, g in want.items():
        mine = got["params/" + k] if "params/" + k in got else got[k]
        if k in BN_CANCELLED:
            assert np.abs(g).max() <= noise * fe_max, k
            assert np.abs(mine).max() <= noise * fe_max, k
            continue
        err = np.abs(mine - g).max()
        assert err <= 1e-4 * np.abs(g).max(), (k, err, np.abs(g).max())


def _ranks_equal(outs):
    for a, b in zip(outs[0]["losses"], outs[1]["losses"]):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def test_two_rank_step_matches_the_jax_global_step(tmp_path, jax_run):
    variables, jlosses, jgrads, jstats = jax_run
    outs = run_ranks(tmp_path, "train_steps", dict(
        fe_cfg=FE, wk_cfg=WORKERS, cfg=_cfg(tmp_path / "port"),
        variables=variables, batches=_batches()))
    _ranks_equal(outs)
    names = ["mfcc", "mi", "total"]
    _check_losses(outs[0]["losses"][0], jlosses[0], names, 1e-5)
    _check_losses(outs[0]["losses"][1], jlosses[1], names, 1e-3)
    _check_grads(outs[0]["grads"], jgrads)
    for k, v in jstats.items():
        for o in outs:
            err = np.abs(o["state"]["batch_stats/" + k] - v).max()
            assert err <= 1e-6, (k, err)


ATT_CFGS = {mode: {"K": 8, "avg_factor": 0.3, "att_mode": mode,
                   "hidden": [16]}
            for mode in ("avg_time", "avg_time_batch")}


@pytest.mark.parametrize("mode", sorted(ATT_CFGS))
def test_two_rank_attention_step_matches_the_jax_global_step(tmp_path,
                                                            mode):
    """The attention variant on two ranks (its batch means, the running
    distribution's update and avg_time_batch's pooled view, over the
    global batch) against the JAX step on the global batch: losses of
    step 1 within 1e-5 relative (step 2: 1e-3), the gradients within
    1e-4 of each leaf's largest (the scoring MLPs' exactly 0: the mask is
    not differentiated), the running distributions within 1e-6, the
    ranks' losses bit for bit."""
    att = ATT_CFGS[mode]
    variables, jlosses, jgrads, jstats = _jax_steps(tmp_path,
                                                    {"att_cfg": att})
    assert any(k.endswith("running_dist") for k in jstats)
    outs = run_ranks(tmp_path, "train_steps", dict(
        fe_cfg=FE, wk_cfg=WORKERS, cfg=_cfg(tmp_path / "port", att_cfg=att),
        variables=variables, batches=_batches()))
    _ranks_equal(outs)
    names = ["mfcc", "mi", "total"]
    _check_losses(outs[0]["losses"][0], jlosses[0], names, 1e-5)
    _check_losses(outs[0]["losses"][1], jlosses[1], names, 1e-3)
    att_grads = {k for k in jgrads if k.startswith("att_")}
    assert att_grads
    for k in att_grads:
        # the port's scoring MLPs get no gradient at all (grad None)
        assert not np.any(jgrads[k]) and not np.any(
            outs[0]["grads"].get("params/" + k, 0.0)), k
    _check_grads(outs[0]["grads"], {k: g for k, g in jgrads.items()
                                    if k not in att_grads})
    for k, v in jstats.items():
        for o in outs:
            err = np.abs(o["state"]["batch_stats/" + k] - v).max()
            assert err <= 1e-6, (k, err)


VARIANTS = {
    "vq": (dict(FE, rnn_pool=True, rnn_dim=16, vq_K=16), {}, None),
    "mgd": (FE, {"backprop_mode": "MGD"}, None),
    "gan": (FE, {}, {"type": "z", "loss": "LSGAN", "lr": 4e-4}),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_two_rank_step_matches_the_one_process_step(tmp_path, variant):
    """VQ-EMA (its counts and code sums all-reduced), MGD (the Gram matrix
    of the per-worker gradients summed over the ranks) and the z GAN (D's
    gradients averaged, the z prior drawn for the global batch), each with
    random_scale: two ranks against the port's one process on the global
    batch."""
    fe, extra, gan = VARIANTS[variant]
    cfg = _cfg(tmp_path / "port", random_scale=True, **extra)
    kw = dict(fe_cfg=fe, wk_cfg=WORKERS, cfg=cfg, variables=None,
              batches=_batches(), gan_cfg=gan)
    one = train_steps(0, 1, **dict(kw, cfg=dict(cfg, save_path=str(
        tmp_path / "one"))))
    outs = run_ranks(tmp_path, "train_steps", kw)
    _ranks_equal(outs)
    names = list(one["losses"][0])
    _check_losses(outs[0]["losses"][0], one["losses"][0], names, 1e-5)
    _check_losses(outs[0]["losses"][1], one["losses"][1], names, 1e-3)
    # MGD's alpha rescales the encoder's gradient: the biases before a
    # BatchNorm hold rounding noise up to about 1e-5 of the largest
    _check_grads(outs[0]["grads"],
                 {(k[len("params/"):] if k.startswith("params/") else k): v
                  for k, v in one["grads"].items()}, noise=1e-4)
    np.testing.assert_allclose(outs[0]["alpha"], one["alpha"], rtol=1e-5)
    for k, v in one["state"].items():
        err = np.abs(outs[0]["state"][k] - v).max()
        bound = 1e-6 if "/norm" in k else 1e-5 * max(np.abs(v).max(), 1.0)
        assert err <= bound, (k, err)


def test_n_model_raises_naming_item_10b(tmp_path):
    """--n_model 2 (item 10b) in one process: a grid of 1 process does not
    divide into model ranks of 2, a ValueError naming the rule."""
    from pase_tpu_torch import train as port_train
    fe, wk = tmp_path / "fe.cfg", tmp_path / "wk.cfg"
    fe.write_text(json.dumps(FE))
    wk.write_text(json.dumps(WORKERS))
    with pytest.raises(ValueError, match="must divide the number of "
                                         "processes"):
        port_train.main(["--synthetic", "--device", "cpu", "--net_cfg",
                         str(wk), "--fe_cfg", str(fe), "--n_model", "2",
                         "--save_path", str(tmp_path / "run")])


# ---------------------------------------------------------------------------
# dropout masks from explicit generators, drawn for the global batch
# ---------------------------------------------------------------------------


def test_dropout_masks_law_and_generator():
    """nn.dropout: the keep share within 5 binomial sd of 1 - p, kept
    values scaled by 1 / (1 - p), the same seed the same mask whatever
    torch's global generator does, identity in eval or at p = 0, and no
    generator raises."""
    from pase_tpu_torch.nn import dropout
    x = torch.rand(64, 20, 40) + 0.5
    gen = torch.Generator().manual_seed(3)
    torch.manual_seed(0)
    y = dropout(x, 0.3, gen)
    n = x.numel()
    kept = int((y != 0).sum())
    assert abs(kept - 0.7 * n) <= 5 * np.sqrt(n * 0.3 * 0.7)
    torch.testing.assert_close(y[y != 0], (x / 0.7)[y != 0])
    gen.manual_seed(3)
    torch.manual_seed(1)
    assert torch.equal(dropout(x, 0.3, gen), y)
    assert dropout(x, 0.3, gen, training=False) is x
    assert dropout(x, 0.0, None) is x
    with pytest.raises(ValueError, match="torch.Generator"):
        dropout(x, 0.3, None)


def _rnn_dropout_modules():
    from pase_tpu_torch.nn import QRNN, BiRNN, MLPBlock
    gen = torch.Generator().manual_seed(1)
    return {"qrnn": (QRNN(6, 5, layers=3, dropout=0.4, generator=gen),
                     lambda m: (m, 1)),
            "birnn": (BiRNN(6, 5, layers=2, cell="gru", dropout=0.4,
                            generator=gen), lambda m: (m, 1)),
            "mlp_block": (MLPBlock(6, 7, dout=0.4, generator=gen),
                          lambda m: (m, 6))}


@pytest.mark.parametrize("kind", ["qrnn", "birnn", "mlp_block"])
def test_dropout_rows_are_one_global_draw(kind):
    """A module whose dropout sits between its layers (QRNN, BiRNN) or
    after its activation (MLPBlock), in train mode on k = 3 streams side
    by side: each of two ranks' rows (under a row_shard) get the
    one-process draw of those rows, so the ranks' outputs are the
    one-process output's rows; a seed changes the masks."""
    module, _ = _rnn_dropout_modules()[kind]
    module.train()
    rng = np.random.RandomState(4)
    shape = (3 * 8, 9, 6) if kind != "mlp_block" else (3 * 8, 6, 9)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    gen = torch.Generator()
    module.dropout_generator = gen

    def run(inp, seed):
        gen.manual_seed(seed)
        with torch.no_grad():
            return module(inp)

    want = run(x, 5)
    assert not torch.equal(run(x, 6), want)
    for r in range(2):
        rows = mesh.RowShard(4 * r, 4 * r + 4, 8)
        idx = torch.cat([torch.arange(s * 8 + 4 * r, s * 8 + 4 * r + 4)
                         for s in range(3)])
        with mesh.row_shard(rows):
            got = run(x[idx], 5)
        # the masks equal; the values within rounding (a conv's sums
        # depend on the batch it is given)
        assert torch.equal(got == 0, want[idx] == 0)
        torch.testing.assert_close(got, want[idx], rtol=1e-5, atol=1e-6)


def test_trainer_gives_the_dropout_modules_their_generators(tmp_path):
    """The trainer's encoder generator reaches the QRNN (rnn_dropout
    between its layers) and its head generator each MLPBlock (the heads'
    dropout): a step draws no mask from torch's global generator, so two
    trainers of one seed give the same losses whatever that generator's
    state."""
    from pase_tpu_torch.trainer import Trainer
    fe = dict(FE, rnn_pool=True, rnn_dim=16, rnn_layers=2, rnn_dropout=0.3)
    wk = json.loads(json.dumps(WORKERS))
    for e in wk["regr"] + wk["cls"]:
        e["dropout"] = 0.2
    raw = {k: v[:2] for k, v in _batches(1)[0].items()}
    losses = []
    for seed in (0, 1):
        tr = Trainer(fe, wk, _cfg(tmp_path / f"t{seed}", batch_size=2),
                     device="cpu")
        assert tr.model.frontend.rnn.dropout_generator is \
            tr.dropout_generator is not None
        blocks = [m for m in tr.model.workers.modules()
                  if hasattr(m, "dout")]
        assert blocks and all(m.dropout_generator is tr.head_generator
                              for m in blocks)
        torch.manual_seed(seed)
        losses.append({k: float(v) for k, v in tr.train_step(raw).items()})
    assert losses[0] == losses[1]


# ---------------------------------------------------------------------------
# the stream with affinorm FeBlocks (per-push statistics, as in JAX)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sizes", [[4000, 4000, 8000], [1000, 777, 13, 5000,
                                                       9210]],
                         ids=["even", "uneven"])
def test_affinorm_stream_matches_the_jax_stream(sizes):
    """The JAX stream admits affinorm FeBlocks without norm_out and
    normalizes each push's frames on their own: the port's stream emits
    the same frames per push (atol = rtol = 2e-5). Per-push statistics
    are not the offline encoder's (the offline forward normalizes over
    the whole utterance): the streamed result differs from it."""
    import jax.numpy as jnp
    from pase_tpu.streaming import StreamingEncoder as JaxStream
    from pase_tpu_torch import streaming
    from test_torch_streaming import CFG, _emissions, _np, _pair, _wav
    jenc, port = _pair(dict(CFG, norm_type="affinorm", norm_out=False))
    assert any(type(m).__name__ == "InstanceNorm1d" and m.weight is not None
               for m in port.modules())
    wav = _wav(2, sum(sizes), seed=3)
    want = _emissions(JaxStream(jenc), jnp.asarray(wav), sizes, _np)
    got = _emissions(streaming.StreamingEncoder(port), wav, sizes, _np)
    assert [None if p is None else p.shape for p in got] == \
        [None if p is None else p.shape for p in want]
    for g, w in zip(got, want):
        if w is not None:
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5)
    with torch.no_grad():
        off = port(torch.from_numpy(wav)).transpose(1, 2).numpy()
    cat = np.concatenate([g for g in got if g is not None], axis=2)
    assert cat.shape == off.shape and not np.allclose(cat, off, atol=1e-3)
