"""The port's CUDA kernels on the card: the QRNN pooling kernels
(pase_tpu_torch/csrc/qrnn_pool.cu: serving forward, training forward,
backward) against their plain PyTorch versions, the encoder on the GPU
against the same weights on the CPU, and one small train step on the GPU
against the CPU.

This file imports no JAX, so it runs on a host without it. There the
repository's conftest (which configures JAX) is left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a card every test skips. Tolerances: 1e-5 absolute for the
forward kernels and 1e-5 x max(1, max|dy_plain|) for the backward
(float32 gates and recurrence, ulp-level differences of tanh/exp and FMA
contraction), 2e-4 of the largest output for the encoder (the bound
tests/test_frontend_parity.py holds the JAX encoder to), 1e-4 relative per
worker loss and 1e-3 of the largest gradient per parameter group for the
train step."""

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
    before = cuda_qrnn.LAUNCHES["qrnn_pool_fwd"]
    for seed in (None, c0):
        h, c = cuda_qrnn.qrnn_pool(y, seed)
        h_ref, c_ref = plain.qrnn_pool(y, seed)
        torch.cuda.synchronize()
        assert h.shape == h_ref.shape and c.shape == c_ref.shape
        assert (h - h_ref).abs().max().item() <= 1e-5
        assert (c - c_ref).abs().max().item() <= 1e-5
    assert cuda_qrnn.LAUNCHES["qrnn_pool_fwd"] == before + 2


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
    h, c = cuda_qrnn.qrnn_pool_fwd_train(y)[:2]
    with pytest.raises(ValueError):
        cuda_qrnn.qrnn_pool_bwd(y, c, h[:, :5].contiguous())
    with pytest.raises(ValueError):
        cuda_qrnn.qrnn_pool_bwd(y, c, h, torch.zeros(2, 5,
                                                     device=cuda_device))


def test_encoder_gpu_matches_cpu(cuda_device):
    gpu = wf_builder(NARROW_CFG, device=cuda_device, seed=0)
    cpu = wf_builder(NARROW_CFG, device="cpu", seed=0)
    x = (np.random.RandomState(0).randn(2, 1, 16000) * 0.1).astype(np.float32)
    before = cuda_qrnn.LAUNCHES["qrnn_pool_fwd"]
    y = gpu(x)
    assert cuda_qrnn.LAUNCHES["qrnn_pool_fwd"] == \
        before + len(gpu.module.rnn.layers)
    y_cpu = cpu(x)
    assert tuple(y.shape) == tuple(y_cpu.shape) == (2, 8, 400)
    rel = ((y.cpu() - y_cpu).abs().max() / y_cpu.abs().max()).item()
    assert rel <= 2e-4, rel


@pytest.mark.parametrize("shape", [(3, 200, 16), (2, 1000, 512),
                                   (9, 131, 40), (1, 7, 24)])
@pytest.mark.parametrize("seeded", [False, True])
def test_train_kernels_match_plain_autograd(cuda_device, shape, seeded):
    """qrnn_pool through the QRNNPool Function (fwd_train + bwd kernels)
    vs the plain version's autograd, with a nonzero gradient on c_T."""
    y, c0 = _inputs(*shape, cuda_device, seed=13)
    c0 = c0 if seeded else None
    rng = np.random.RandomState(14)
    wh = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        cuda_device)
    wc = torch.from_numpy(rng.randn(shape[0], shape[2]).astype(
        np.float32)).to(cuda_device)
    grads = []
    for fn in (cuda_qrnn.qrnn_pool, plain.qrnn_pool):
        yg = y.clone().requires_grad_()
        cg = None if c0 is None else c0.clone().requires_grad_()
        h, c_last = fn(yg, cg)
        inputs = [yg] + ([] if cg is None else [cg])
        grads.append(torch.autograd.grad(
            torch.sum(h * wh) + torch.sum(c_last * wc), inputs))
    torch.cuda.synchronize()
    (dy, *dc0), (dy_ref, *dc0_ref) = grads
    assert (dy - dy_ref).abs().max().item() <= \
        1e-5 * max(1.0, dy_ref.abs().max().item())
    if seeded:
        assert (dc0[0] - dc0_ref[0]).abs().max().item() <= 1e-5


def test_train_kernels_count_launches(cuda_device):
    y, _ = _inputs(2, 50, 8, cuda_device)
    before = dict(cuda_qrnn.LAUNCHES)
    h, _ = cuda_qrnn.qrnn_pool(y.clone().requires_grad_())
    h.sum().backward()
    after = cuda_qrnn.LAUNCHES
    assert after["qrnn_pool_fwd_train"] == before["qrnn_pool_fwd_train"] + 1
    assert after["qrnn_pool_bwd"] == before["qrnn_pool_bwd"] + 1
    assert after["qrnn_pool_fwd"] == before["qrnn_pool_fwd"]


def test_train_step_gpu_matches_cpu(cuda_device, tmp_path):
    """One small train step (every workers+ head kind) on the card vs the
    CPU plain path, same weights and batch."""
    import json
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    from pase_tpu_torch.trainer import Trainer
    with open("cfg/workers/workers+.cfg") as f:
        wk = json.load(f)
    for group in ("regr", "cls"):
        for e in wk[group]:
            e["hidden_size"] = 32
            if e["name"] == "cchunk":
                e["fmaps"] = [16, 16, 8]
    fe = dict(NARROW_CFG, strides=[1, 10, 4, 4])
    cfg = dict(batch_size=2, chunk_size=4800, fe_lr=5e-4, min_lr=5e-4,
               lr_mode="poly", save_path=str(tmp_path))
    gpu = Trainer(fe, wk, cfg, device=cuda_device)
    cpu = Trainer(fe, wk, cfg, device="cpu")
    cpu.model.load_state_dict(gpu.model.state_dict())
    raw = next(iter(SyntheticChunkBatcher(2, 4800, seed=3)))
    before = dict(cuda_qrnn.LAUNCHES)
    lg, lc = gpu.train_step(raw), cpu.train_step(raw)
    assert cuda_qrnn.LAUNCHES["qrnn_pool_bwd"] == \
        before["qrnn_pool_bwd"] + len(gpu.model.frontend.rnn.layers)
    for k in gpu.ordered_names:
        assert abs(float(lg[k]) - float(lc[k])) <= 1e-4 * abs(float(lc[k])), k
    for part in ("frontend", "workers"):
        g = [p.grad for p in getattr(gpu.model, part).parameters()]
        c = [p.grad for p in getattr(cpu.model, part).parameters()]
        top = max(x.abs().max().item() for x in c)
        diff = max((a.cpu() - b).abs().max().item() for a, b in zip(g, c))
        assert diff <= 1e-3 * top, (part, diff, top)
