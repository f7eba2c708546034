"""The port's QRNN pooling (pase_tpu_torch.ops) against the JAX package:
the plain torch version vs the Pallas kernel in interpret mode and vs the
associative scan, on the same numpy inputs; and the CUDA wrapper's CPU
path. The kernel itself is tested on the card by tests/test_torch_cuda.py.

Tolerance: atol 2e-5, as tests/test_qrnn.py holds the Pallas kernel to the
scan (float32 recurrences summed in different orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.experimental.pallas.tpu as pltpu

from pase_tpu.ops import pallas_qrnn as jax_pallas
from pase_tpu.ops import qrnn as jax_qrnn
from pase_tpu_torch.ops import cuda_qrnn
from pase_tpu_torch.ops import qrnn as torch_qrnn

ATOL = 2e-5
# (B, T, H): B and T off the Pallas kernel's 8 x 128 tiling, T over one
# 128-step time block
SHAPES = [(3, 200, 16), (9, 131, 8), (1, 7, 24)]


def _inputs(b, t, h, seed):
    rng = np.random.RandomState(seed)
    y = rng.randn(b, t, 3 * h).astype(np.float32)
    c0 = rng.randn(b, h).astype(np.float32)
    return y, c0


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seeded", [False, True])
def test_qrnn_pool_matches_pallas_interpret(shape, seeded):
    y, c0 = _inputs(*shape, seed=sum(shape))
    c0 = c0 if seeded else None
    with pltpu.force_tpu_interpret_mode():
        h_ref, c_ref = jax_pallas.qrnn_pool_pallas(
            jnp.asarray(y), None if c0 is None else jnp.asarray(c0))
    h, c = torch_qrnn.qrnn_pool(torch.from_numpy(y),
                                None if c0 is None else torch.from_numpy(c0))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=ATOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_qrnn_pool_matches_jax_scan_with_carry(shape):
    y, c0 = _inputs(*shape, seed=7)
    h_ref, c_ref = jax.jit(jax_qrnn.qrnn_pool)(jnp.asarray(y),
                                               jnp.asarray(c0))
    h, c = torch_qrnn.qrnn_pool(torch.from_numpy(y), torch.from_numpy(c0))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=ATOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=ATOL)


def test_forget_mult_matches_jax_scan():
    rng = np.random.RandomState(0)
    f = 1.0 / (1.0 + np.exp(-rng.randn(2, 57, 16))).astype(np.float32)
    z = np.tanh(rng.randn(2, 57, 16)).astype(np.float32)
    ref = jax.jit(jax_qrnn.forget_mult)(jnp.asarray(f), jnp.asarray(z))
    got = torch_qrnn.forget_mult(torch.from_numpy(f), torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_block_streaming_matches_full_and_pallas():
    """Two halves with the carry threaded == the full sequence (the plain
    version folds c0 like the JAX code: equal to rounding), and the same
    streamed run of the Pallas kernel agrees."""
    y, c0 = _inputs(2, 24, 8, seed=3)
    yt, c0t = torch.from_numpy(y), torch.from_numpy(c0)
    h_full, c_full = torch_qrnn.qrnn_pool(yt, c0t)
    h1, c1 = torch_qrnn.qrnn_pool(yt[:, :12], c0t)
    h2, c2 = torch_qrnn.qrnn_pool(yt[:, 12:], c1)
    np.testing.assert_allclose(torch.cat([h1, h2], 1).numpy(),
                               h_full.numpy(), atol=1e-6)
    np.testing.assert_allclose(c2.numpy(), c_full.numpy(), atol=1e-6)
    with pltpu.force_tpu_interpret_mode():
        p1, pc1 = jax_pallas.qrnn_pool_pallas(jnp.asarray(y[:, :12]),
                                              jnp.asarray(c0))
        p2, _ = jax_pallas.qrnn_pool_pallas(jnp.asarray(y[:, 12:]), pc1)
    np.testing.assert_allclose(torch.cat([h1, h2], 1).numpy(),
                               np.concatenate([p1, p2], 1), atol=ATOL)


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_shift_right_matches_jax(dim):
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    ref = jax_qrnn.shift_right(jnp.asarray(x), axis=dim)
    got = torch_qrnn.shift_right(torch.from_numpy(x), dim=dim)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_cuda_wrapper_cpu_path_needs_no_nvcc(monkeypatch, tmp_path):
    """cuda_qrnn imports and runs its plain path on CPU tensors with no
    nvcc anywhere, and counts no kernel launch."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    y, c0 = _inputs(2, 33, 8, seed=5)
    before = cuda_qrnn.LAUNCHES
    h, c = cuda_qrnn.qrnn_pool(torch.from_numpy(y), torch.from_numpy(c0))
    h_ref, c_ref = torch_qrnn.qrnn_pool(torch.from_numpy(y),
                                        torch.from_numpy(c0))
    assert torch.equal(h, h_ref) and torch.equal(c, c_ref)
    assert cuda_qrnn.LAUNCHES == before


def test_cuda_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing compiler is an error, never a silent fallback."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_qrnn, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_qrnn, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_qrnn.build()
