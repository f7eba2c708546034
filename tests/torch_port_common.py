"""Shared helpers of the tests that hold the PyTorch port (pase_tpu_torch)
to the JAX package: the narrow encoder config, seeded non-trivial weights
and the CUDA fixture."""

import numpy as np
import pytest
import torch

# narrow WaveFe: PASE+'s layer kinds at a few channels (stride product 40)
NARROW_CFG = {
    "kwidths": [251, 20, 11, 11], "strides": [1, 10, 2, 2],
    "fmaps": [8, 8, 16, 16], "rnn_pool": True, "rnn_dim": 16,
    "emb_dim": 8, "denseskips": True, "norm_out": True,
}
PASEP_CFG = "cfg/frontend/PASE+.cfg"


def jax_variables(module, example_len, seed=0):
    """Init a JAX WaveFe, then give every BatchNorm random running stats
    and random affine params, and every PReLU a random slope, so the
    comparison exercises them (init values are 0/1 and hide mistakes)."""
    import jax
    import jax.numpy as jnp
    from flax.core import unfreeze
    from flax.traverse_util import flatten_dict, unflatten_dict

    v = jax.jit(module.init, static_argnames="train")(
        jax.random.PRNGKey(seed), jnp.zeros((1, example_len)), train=False)
    flat = flatten_dict(unfreeze(v))
    rng = np.random.RandomState(seed + 1)
    for k, arr in flat.items():
        shape = np.shape(arr)
        if k[0] == "batch_stats" and k[-1] == "mean":
            new = rng.randn(*shape) * 0.1
        elif k[0] == "batch_stats" and k[-1] == "var":
            new = rng.uniform(0.5, 1.5, shape)
        elif k[-2:] == ("norm", "weight"):
            new = rng.uniform(0.5, 1.5, shape)
        elif k[-2:] == ("norm", "bias"):
            new = rng.randn(*shape) * 0.1
        elif k[-2:] == ("act", "weight"):
            new = rng.uniform(0.0, 0.3, shape)
        else:
            continue
        flat[k] = jnp.asarray(new.astype(np.float32))
    return unflatten_dict(flat)


def flat_variables(variables):
    """JAX variable tree -> {'/'-joined key: np.ndarray} (the native .npz
    layout of pase_tpu.checkpoint.save_variables)."""
    from flax.core import unfreeze
    from flax.traverse_util import flatten_dict
    return {k: np.asarray(v) for k, v in
            flatten_dict(unfreeze(variables), sep="/").items()}


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False); run on the card with -m cuda")
    return torch.device("cuda", 0)
