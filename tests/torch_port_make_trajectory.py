"""Write tests/fixtures/torch_port_trajectory.json: the JAX runs that the
port's 40-step trajectory gate (pase_tpu_torch/trajectory.py) is held to.

    python tests/torch_port_make_trajectory.py

Runs on the CPU with JAX, about two minutes. For the configuration of
pase_tpu_torch.trajectory (tests/test_training_regression.py's run) it
records, per step, the distortion draws the JAX step takes from its key,
and the per-worker losses of four JAX runs from the port's seeded init
(carried into the JAX TrainState through the weight bridge):
  f32       float32;
  f32_ulp   float32, every initial parameter times (1 + 2^-23);
  bf16      the bf16 compute policy;
  bf16_ulp  bf16, every initial parameter times (1 + 2^-8).
The port's card needs no JAX: it reads this file.
"""

import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from flax.traverse_util import unflatten_dict  # noqa: E402

from pase_tpu.data import distortions as JD  # noqa: E402
from pase_tpu.optim import build_optimizer  # noqa: E402
from pase_tpu.parallel.mesh import get_mesh  # noqa: E402
from pase_tpu.scheduling import init_policy_state  # noqa: E402
from pase_tpu.trainer import Trainer as JaxTrainer  # noqa: E402
from pase_tpu.trainer import TrainState  # noqa: E402
from pase_tpu_torch import trajectory as T  # noqa: E402
from pase_tpu_torch.checkpoint import \
    model_state_dict_to_variables  # noqa: E402
from pase_tpu_torch.data.distortions import DistortionConfig  # noqa: E402

FIXTURE = os.path.join(HERE, "fixtures", "torch_port_trajectory.json")
RUNS = {"f32": ("f32", 0.0), "f32_ulp": ("f32", T.PERTURB["f32"]),
        "bf16": ("bf16", 0.0), "bf16_ulp": ("bf16", T.PERTURB["bf16"])}


def _jax_assets():
    return JD.DistortionAssets(*(None if a is None else jnp.asarray(a.numpy())
                                 for a in T.synth_assets()))


def port_init_variables():
    """The port's seeded initial variables, flat, in the JAX layout."""
    tr = T.make_trainer("f32", "cpu", tempfile.mkdtemp())
    return model_state_dict_to_variables(tr.model.state_dict())


def jax_trainer(precision, save_path):
    return JaxTrainer(T.FRONTEND, T.WORKERS,
                      T.train_cfg(precision, save_path),
                      dist_cfg=JD.DistortionConfig(**T.DIST),
                      dist_assets=_jax_assets(),
                      mesh=get_mesh(devices=jax.devices()[:1]))


def jax_state(jtr, flat, perturb):
    """The JAX TrainState of the port's init, every parameter times
    (1 + perturb) in float32."""
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})
    scale = np.float32(1.0 + perturb)
    params = jax.tree.map(lambda p: p * scale, tree["params"])
    cfg = jtr.cfg
    jtr._tx, jtr._scheds = build_optimizer(
        params, fe_lr=cfg["fe_lr"], min_lr=cfg["min_lr"],
        lr_mode=cfg["lr_mode"], epochs=jtr.epochs, bpe=jtr.bpe)
    return TrainState(
        params=params, batch_stats=tree["batch_stats"],
        opt_state=jtr._tx.init(params),
        policy_state=init_policy_state(jtr.num_workers),
        alpha=jnp.ones((jtr.num_workers,)),
        rng=jax.random.PRNGKey(T.RNG_SEED), step=jnp.zeros((), jnp.int32))


def jax_run(precision, perturb, steps=T.STEPS, flat=None):
    """Per-step {worker: loss, 'total'} of the JAX step."""
    flat = port_init_variables() if flat is None else flat
    jtr = jax_trainer(precision, tempfile.mkdtemp())
    state = jax_state(jtr, flat, perturb)
    step = jtr._make_train_step()
    traj = []
    for raw in T.batches(steps):
        state, losses = step(state, {k: jnp.asarray(v)
                                     for k, v in raw.items()})
        traj.append({k: float(v) for k, v in
                     jax.device_get(losses).items()})
    return traj


def record_draws(steps=T.STEPS):
    """The distortion draws of each JAX step: the train step splits its
    rng into (next, prep, sample, dropout, policy) and prepare splits
    prep into (scale, dist, zero-speech); the draws come from dist."""
    from test_torch_distortions import jax_draws
    cfg, assets = DistortionConfig(**T.DIST), T.synth_assets()
    rng = jax.random.PRNGKey(T.RNG_SEED)
    out = []
    for _ in range(steps):
        rng, k_prep = jax.random.split(rng, 5)[:2]
        k_dist = jax.random.split(k_prep, 3)[1]
        d = jax_draws(k_dist, T.BATCH, T.CHUNK, cfg, assets)
        out.append({k: v.tolist() for k, v in d._asdict().items()
                    if v is not None})
    return out


def main():
    flat = port_init_variables()
    fixture = {
        "config": {"frontend": T.FRONTEND, "workers": T.WORKERS,
                   "dist": T.DIST, "batch": T.BATCH, "chunk": T.CHUNK,
                   "steps": T.STEPS, "model_seed": T.MODEL_SEED,
                   "batch_seed": T.BATCH_SEED, "rng_seed": T.RNG_SEED,
                   "perturb": {k: p for k, (_, p) in RUNS.items()},
                   "train_cfg": T.train_cfg()},
        "draws": record_draws()}
    fixture["runs"] = {}
    for name, (precision, perturb) in RUNS.items():
        fixture["runs"][name] = jax_run(precision, perturb, flat=flat)
        print(f"[trajectory] {name}: step 1 total "
              f"{fixture['runs'][name][0]['total']:.6f}, step "
              f"{T.STEPS} total {fixture['runs'][name][-1]['total']:.6f}",
              flush=True)
    with open(FIXTURE, "w") as f:
        json.dump(fixture, f, separators=(",", ":"))
    for precision in ("f32", "bf16"):
        floor = T.mean_max_rel(fixture["runs"][precision],
                               fixture["runs"][precision + "_ulp"])
        print(f"[trajectory] {precision} one-ulp floor (mean, max): "
              + ", ".join(f"{k} {m:.2e} {x:.2e}"
                          for k, (m, x) in floor.items()))
    env = T.mean_max_rel(fixture["runs"]["f32"], fixture["runs"]["bf16"])
    print("[trajectory] JAX bf16 against JAX f32 (mean, max): "
          + ", ".join(f"{k} {m:.2e} {x:.2e}" for k, (m, x) in env.items()))
    print(f"[trajectory] wrote {FIXTURE} "
          f"({os.path.getsize(FIXTURE)} bytes)")


if __name__ == "__main__":
    main()
