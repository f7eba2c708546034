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
