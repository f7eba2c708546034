"""The port's QRNN pooling (pase_tpu_torch.ops) against the JAX package:
the plain torch version vs the Pallas kernel in interpret mode and vs the
associative scan, on the same numpy inputs; the plain backward (through
the ``QRNNPool`` autograd Function) vs ``jax.grad`` of the Pallas kernel's
custom VJP; and the CUDA wrapper's CPU path. The kernels themselves are
tested on the card by tests/test_torch_cuda.py.

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
    before = dict(cuda_qrnn.LAUNCHES)
    h, c = cuda_qrnn.qrnn_pool(torch.from_numpy(y), torch.from_numpy(c0))
    h_ref, c_ref = torch_qrnn.qrnn_pool(torch.from_numpy(y),
                                        torch.from_numpy(c0))
    assert torch.equal(h, h_ref) and torch.equal(c, c_ref)
    yg = torch.from_numpy(y).requires_grad_()
    h, c = cuda_qrnn.qrnn_pool(yg, torch.from_numpy(c0))
    (h.sum() + c.sum()).backward()
    assert yg.grad is not None
    assert cuda_qrnn.LAUNCHES == before


def test_cuda_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing compiler is an error, never a silent fallback."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_qrnn, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_qrnn, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_qrnn.build()


def _jax_pool_grads(y, c0, wh, wc):
    """jax.grad of sum(h*wh) + sum(c_T*wc) through the Pallas kernel's
    custom VJP, in interpret mode (as tests/test_qrnn.py runs it)."""
    def loss(y_, c0_):
        h, c_last = jax_pallas.qrnn_pool_pallas(y_, c0_)
        return jnp.sum(h * wh) + jnp.sum(c_last * wc)

    with pltpu.force_tpu_interpret_mode():
        if c0 is None:
            return jax.grad(lambda y_: loss(y_, None))(jnp.asarray(y)), None
        gy, gc = jax.grad(loss, argnums=(0, 1))(jnp.asarray(y),
                                                  jnp.asarray(c0))
    return gy, gc


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seeded", [False, True])
def test_qrnn_pool_backward_matches_jax_grad(shape, seeded):
    """The QRNNPool Function on CPU tensors (plain forward, plain reverse
    loop) vs jax.grad, with a nonzero gradient on c_T."""
    y, c0 = _inputs(*shape, seed=sum(shape) + 1)
    c0 = c0 if seeded else None
    rng = np.random.RandomState(9)
    wh = rng.randn(shape[0], shape[1], shape[2]).astype(np.float32)
    wc = rng.randn(shape[0], shape[2]).astype(np.float32)
    gy_ref, gc_ref = _jax_pool_grads(y, c0, wh, wc)
    yt = torch.from_numpy(y).requires_grad_()
    c0t = None if c0 is None else torch.from_numpy(c0).requires_grad_()
    h, c_last = cuda_qrnn.qrnn_pool(yt, c0t)
    (torch.sum(h * torch.from_numpy(wh))
     + torch.sum(c_last * torch.from_numpy(wc))).backward()
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gy_ref),
                               atol=ATOL)
    if seeded:
        np.testing.assert_allclose(c0t.grad.numpy(), np.asarray(gc_ref),
                                   atol=ATOL)


@pytest.mark.parametrize("seeded", [False, True])
def test_qrnn_pool_function_gradcheck(seeded):
    """Finite differences in float64 against the plain backward."""
    rng = np.random.RandomState(4)
    y = torch.from_numpy(rng.randn(2, 9, 3 * 3)).requires_grad_()
    c0 = (torch.from_numpy(rng.randn(2, 3)).requires_grad_() if seeded
          else None)
    assert torch.autograd.gradcheck(
        lambda y_, c0_: cuda_qrnn.QRNNPool.apply(y_, c0_), (y, c0),
        eps=1e-6, atol=1e-7, rtol=1e-5)


def test_plain_backward_returns_no_c0_grad_without_c0():
    y, _ = _inputs(2, 5, 4, seed=2)
    yt = torch.from_numpy(y)
    h, c = torch_qrnn.qrnn_pool_fwd_train(yt)
    dy, dc0 = torch_qrnn.qrnn_pool_bwd(yt, c, torch.ones_like(h))
    assert dy.shape == yt.shape and dc0 is None
