"""The port's CUDA kernel on the card: the QRNN pooling kernel
(pase_tpu_torch/csrc/qrnn_pool.cu) against its plain PyTorch version, and
the encoder on the GPU against the same weights on the CPU.

This file imports no JAX, so it runs on a host without it. There the
repository's conftest (which configures JAX) is left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a card every test skips. Tolerances: 1e-5 absolute for the kernel
(float32 gates and recurrence, ulp-level differences of tanh/exp and FMA
contraction), 2e-4 of the largest output for the encoder (the bound
tests/test_frontend_parity.py holds the JAX encoder to)."""

import numpy as np
import pytest
import torch

from pase_tpu_torch import wf_builder
from pase_tpu_torch.ops import cuda_qrnn
from pase_tpu_torch.ops import qrnn as plain
from torch_port_common import NARROW_CFG, cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _full_precision():
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


def _inputs(b, t, h, device, seed=11):
    rng = np.random.RandomState(seed)
    y = torch.from_numpy(rng.randn(b, t, 3 * h).astype(np.float32))
    c0 = torch.from_numpy(rng.randn(b, h).astype(np.float32))
    return y.to(device), c0.to(device)


def test_kernel_builds(cuda_device):
    lib = cuda_qrnn.build(verbose=True)
    assert lib.qrnn_pool_fwd is not None


@pytest.mark.parametrize("shape", [(3, 200, 16), (2, 1000, 512),
                                   (9, 131, 40), (1, 7, 24)])
def test_kernel_matches_plain(cuda_device, shape):
    y, c0 = _inputs(*shape, cuda_device)
    before = cuda_qrnn.LAUNCHES
    for seed in (None, c0):
        h, c = cuda_qrnn.qrnn_pool(y, seed)
        h_ref, c_ref = plain.qrnn_pool(y, seed)
        torch.cuda.synchronize()
        assert h.shape == h_ref.shape and c.shape == c_ref.shape
        assert (h - h_ref).abs().max().item() <= 1e-5
        assert (c - c_ref).abs().max().item() <= 1e-5
    assert cuda_qrnn.LAUNCHES == before + 2


@pytest.mark.parametrize("shape", [(3, 200, 16), (1, 1001, 512)])
def test_block_streaming_is_bit_identical(cuda_device, shape):
    y, c0 = _inputs(*shape, cuda_device, seed=12)
    h_full, c_full = cuda_qrnn.qrnn_pool(y, c0)
    cut = shape[1] // 3
    h1, c1 = cuda_qrnn.qrnn_pool(y[:, :cut].contiguous(), c0)
    h2, c2 = cuda_qrnn.qrnn_pool(y[:, cut:].contiguous(), c1)
    assert torch.equal(torch.cat([h1, h2], 1), h_full)
    assert torch.equal(c2, c_full)


def test_wrapper_refuses(cuda_device):
    y = torch.randn(2, 10, 12, device=cuda_device)
    with pytest.raises(TypeError):
        cuda_qrnn.qrnn_pool(y.double())
    with pytest.raises(ValueError):
        cuda_qrnn.qrnn_pool(y.transpose(0, 1))
    with pytest.raises(ValueError):
        cuda_qrnn.qrnn_pool(y[:, :, :11].contiguous())
    with pytest.raises(ValueError):
        cuda_qrnn.qrnn_pool(y, torch.zeros(2, 5, device=cuda_device))
    with pytest.raises(NotImplementedError):
        cuda_qrnn.qrnn_pool(y.clone().requires_grad_())


def test_encoder_gpu_matches_cpu(cuda_device):
    gpu = wf_builder(NARROW_CFG, device=cuda_device, seed=0)
    cpu = wf_builder(NARROW_CFG, device="cpu", seed=0)
    x = (np.random.RandomState(0).randn(2, 1, 16000) * 0.1).astype(np.float32)
    before = cuda_qrnn.LAUNCHES
    y = gpu(x)
    assert cuda_qrnn.LAUNCHES == before + len(gpu.module.rnn.layers)
    y_cpu = cpu(x)
    assert tuple(y.shape) == tuple(y_cpu.shape) == (2, 8, 400)
    rel = ((y.cpu() - y_cpu).abs().max() / y_cpu.abs().max()).item()
    assert rel <= 2e-4, rel
