"""The port's CUDA kernels on the card: the QRNN pooling kernels
(pase_tpu_torch/csrc/qrnn_pool.cu: the few-lane, the split, the segmented
and the one-thread-a-lane serving forward, the last two also against each other,
bit for bit; the chunked eval forward, also against the chunked plain
version of its algebra; training forward, backward) and the stride-1 conv kernels
(csrc/conv_s1_tc.cu: conv_s1_tc for bf16, conv_s1_tf32x3 for float32)
against their plain PyTorch versions (the training pair also against the
chunked plain versions of its own algebra, bit for bit between calls and
in a CUDA graph), the encoder on the GPU against the
same weights on the CPU, one small train
step on the GPU against the CPU, the probes' PASE+ extractor and MLP fit
on the GPU against the CPU, the distortion stack on the GPU
against the CPU with the same draws, the residual VQ encoder's
blocks (FeResBlock, the VQEMA quantizer) against the CPU, and the
recurrent layers (cuDNN's): BiRNN, an lstm / gru WaveFe, the WaveRNN
head's forward and gradient, and generate against teacher forcing, and
the alternative encoders (TDNN, ASPP-residual, ResNet) against the CPU,
the global BatchNorm of data parallelism under a one-rank NCCL group
(the single-process layer's bits) and the time-sharded encoder against
the offline one on the card, the training CLI with the host distortion
stage, the spectrum decoders against the CPU and the dropout masks drawn
from a generator on the card.

This file imports no JAX, so it runs on a host without it. There the
repository's conftest (which configures JAX) is left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a card every test skips. Tolerances: 1e-5 absolute for the
forward kernels and 1e-5 x max(1, max|dy_plain|) for the backward
(float32 gates and recurrence, ulp-level differences of tanh/exp and FMA
contraction), 2e-4 of the largest output for the encoder (the bound
tests/test_frontend_parity.py holds the JAX encoder to), 1e-4 relative per
worker loss and 1e-3 of the largest gradient per parameter group for the
train step; for the conv kernel 2^-7 of the largest output in bf16 (one
bf16 rounding of float32 sums taken in another order) and 1e-5 in
float32; the distortion stack within 1e-5 of its largest output."""

import os

import numpy as np
import pytest
import torch

from pase_tpu_torch import wf_builder
from pase_tpu_torch.kernel_variants import gates
from pase_tpu_torch.ops import conv, cuda_qrnn
from pase_tpu_torch.ops import qrnn as plain
from torch_port_common import NARROW_CFG, cuda_device  # noqa: F401
from torch_port_common import port_test_guard  # noqa: F401

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


def _unseeded(b, t, h):
    """The launch count an unseeded call of [b, t, 3 h] adds to: its
    forward entry's (cuda_qrnn.forward_entry)."""
    return cuda_qrnn.forward_entry(b * h, False, t)


def test_kernel_builds(cuda_device):
    lib = cuda_qrnn.build(verbose=True)
    assert lib.qrnn_pool_fwd is not None


@pytest.mark.parametrize("shape", [(3, 200, 16), (2, 1000, 512),
                                   (9, 131, 40), (1, 7, 24)])
def test_kernel_matches_plain(cuda_device, shape):
    """Unseeded (the route's kernel at these shapes: the few-lane one) and
    seeded (the segmented serial kernel) against the plain version."""
    y, c0 = _inputs(*shape, cuda_device)
    unseeded = _unseeded(*shape)
    before = dict(cuda_qrnn.LAUNCHES)
    for seed in (None, c0):
        h, c = cuda_qrnn.qrnn_pool(y, seed)
        h_ref, c_ref = plain.qrnn_pool(y, seed)
        torch.cuda.synchronize()
        assert h.shape == h_ref.shape and c.shape == c_ref.shape
        assert (h - h_ref).abs().max().item() <= 1e-5
        assert (c - c_ref).abs().max().item() <= 1e-5
    assert cuda_qrnn.LAUNCHES == {
        **before, "qrnn_pool_fwd_seg": before["qrnn_pool_fwd_seg"] + 1,
        unseeded: before[unseeded] + 1}


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("t", [1, 17, 1000, 10000])
def test_chunked_kernel_matches_plain(cuda_device, b, t):
    """qrnn_pool_fwd_few, the unseeded forward chunked in time, against
    the plain version: one step, a ragged chunk, one segment, several
    segments; at B = 1 its narrow tile (4 lanes a block), at B = 8 its
    wide one (8 lanes a block, chunks of at most 4)."""
    y, c0 = _inputs(b, t, 512, cuda_device, seed=t + b)
    h_ref, c_ref = plain.qrnn_pool(y)
    h, c = cuda_qrnn.qrnn_pool_fwd_few(y)
    torch.cuda.synchronize()
    assert (h - h_ref).abs().max().item() <= 1e-5
    assert (c - c_ref).abs().max().item() <= 1e-5
    h, c = cuda_qrnn.qrnn_pool_fwd_few(y, c0)
    h_ref, c_ref = plain.qrnn_pool(y, c0)
    torch.cuda.synchronize()
    assert (h - h_ref).abs().max().item() <= 1e-5
    assert (c - c_ref).abs().max().item() <= 1e-5


def test_serving_forward_routes(cuda_device):
    """Unseeded on few lanes: the few-lane kernel, or the split one on at most SPLIT_LANES lanes from SPLIT_STEPS
    steps; on EVAL_LANES lanes: the chunked eval kernel; seeded under
    SEG_LANES: the segmented one; seeded on more lanes: the
    one-thread-a-lane loop. One launch each."""
    small, c0 = _inputs(2, 30, 16, cuda_device)
    long = torch.randn(1, cuda_qrnn.SPLIT_STEPS, 3 * 16, device=cuda_device)
    big = torch.randn(cuda_qrnn.EVAL_LANES // 64, 3, 3 * 64,
                      device=cuda_device)
    wide, wide_c0 = _inputs(cuda_qrnn.SEG_LANES // 64, 3, 64, cuda_device)
    for y, seed, name in ((small, None, "qrnn_pool_fwd_few"),
                          (long, None, "qrnn_pool_fwd_split"),
                          (small, c0, "qrnn_pool_fwd_seg"),
                          (big, None, "qrnn_pool_fwd_eval"),
                          (wide, wide_c0, "qrnn_pool_fwd")):
        before = dict(cuda_qrnn.LAUNCHES)
        cuda_qrnn.qrnn_pool(y, seed)
        assert cuda_qrnn.LAUNCHES == {**before, name: before[name] + 1}


# the eval kernel at T = 1 and a ragged T on lane counts that are not a
# multiple of a block's 32 (120 and 65), and at the 2 x 2 --n_model
# rank's eval, [48,200,256]
EVAL_SHAPES = [(3, 1, 40), (5, 37, 13), (48, 200, 256)]


@pytest.mark.parametrize("shape", EVAL_SHAPES, ids=str)
@pytest.mark.parametrize("seeded", [False, True])
def test_eval_kernel_matches_plain(cuda_device, shape, seeded):
    """qrnn_pool_fwd_eval against the plain version (1e-5) and against the
    chunked plain version of its algebra at the library's chunking (5e-7);
    two calls bit for bit; one launch each."""
    y, c0 = _inputs(*shape, cuda_device, seed=sum(shape))
    c0 = c0 if seeded else None
    chunks, steps = cuda_qrnn.eval_chunking(shape[1])
    assert (chunks, steps) == (plain.EVAL_CHUNKS,
                               plain.eval_chunk_len(shape[1]))
    before = dict(cuda_qrnn.LAUNCHES)
    h, c = cuda_qrnn.qrnn_pool_fwd_eval(y, c0)
    h2, c2 = cuda_qrnn.qrnn_pool_fwd_eval(y, c0)
    assert cuda_qrnn.LAUNCHES == {
        **before, "qrnn_pool_fwd_eval": before["qrnn_pool_fwd_eval"] + 2}
    torch.cuda.synchronize()
    assert torch.equal(h, h2) and torch.equal(c, c2)
    h_ref, c_ref = plain.qrnn_pool(y, c0)
    assert (h - h_ref).abs().max().item() <= 1e-5
    assert (c - c_ref).abs().max().item() <= 1e-5
    hp, _, cp = plain.qrnn_pool_fwd_train_chunked_plain(
        y, c0, chunk=steps, chunks=chunks)
    assert (h - hp).abs().max().item() <= 5e-7
    assert (c - cp).abs().max().item() <= 5e-7


# the split kernel at few-lane shapes: B = 1 extraction of a 2 s
# utterance, forward-chunk's 10 s window, a 100 s file in one forward,
# the time shard's [2,1500,512]; and a narrow ragged one (11 lanes a row:
# tiles of 32 lanes across three rows, a ragged last time tile)
SPLIT_SHAPES = [(1, 200, 512), (1, 1000, 512), (1, 10000, 512),
                (2, 1500, 512), (3, 1237, 11)]
# gates whose carries decay slowly ("slow": f less 6, a about 0.9975) or
# not at all ("frozen": f = 0 exactly from the second step;
# kernel_variants.gates), so that the speculative run stores no h and the
# second run takes every segment of a tile: 100 s, 50 s on two rows, and a
# ragged last segment
SPLIT_GATES = [((1, 10000, 512), "slow"), ((2, 5000, 512), "slow"),
               ((1, 10000, 512), "frozen"), ((1, 9999, 512), "frozen")]


@pytest.mark.parametrize(
    "shape,kind", [(s, "randn") for s in SPLIT_SHAPES] + SPLIT_GATES,
    ids=str)
@pytest.mark.parametrize("seeded", [False, True])
def test_split_kernel_matches_plain(cuda_device, shape, kind, seeded):
    """qrnn_pool_fwd_split against the plain version (1e-5) and against the
    plain version of its algebra at the library's tiling (5e-7), which is
    ops/qrnn.py's; two calls bit for bit; one launch each."""
    b, t, hid = shape
    y, c0 = _inputs(*shape, cuda_device, seed=sum(shape))
    y = gates(y, kind)
    c0 = c0 if seeded else None
    chunk, tile, tiles = cuda_qrnn.split_tiling(b * hid, t)
    assert (chunk, tile) == plain.split_tiling(b * hid, t)
    assert tiles == -(-b * hid // plain.TILE_LANES) * -(-t // tile)
    before = dict(cuda_qrnn.LAUNCHES)
    h, c = cuda_qrnn.qrnn_pool_fwd_split(y, c0)
    h2, c2 = cuda_qrnn.qrnn_pool_fwd_split(y, c0)
    assert cuda_qrnn.LAUNCHES == {
        **before, "qrnn_pool_fwd_split": before["qrnn_pool_fwd_split"] + 2}
    torch.cuda.synchronize()
    assert torch.equal(h, h2) and torch.equal(c, c2)
    h_ref, c_ref = plain.qrnn_pool(y, c0)
    assert (h - h_ref).abs().max().item() <= 1e-5
    assert (c - c_ref).abs().max().item() <= 1e-5
    hp, cp = plain.qrnn_pool_split_plain(y, c0, tile=tile, chunk=chunk)
    assert (h - hp).abs().max().item() <= 5e-7
    assert (c - cp).abs().max().item() <= 5e-7


@pytest.mark.parametrize("shape", [(1, 10000, 512), (1, 1000, 512)],
                         ids=str)
def test_split_kernel_replays_in_a_cuda_graph(cuda_device, shape):
    """Two CUDA graphs of the split kernel, captured with no call before
    on torch's capture stream, replayed on new inputs at once on two
    streams, give the eager call's bits each time: each graph clears flags
    of its own on every replay."""
    cuda_qrnn.build()
    ys = [_inputs(*shape, cuda_device, seed=s)[0] for s in (1, 2, 3, 4)]
    statics = [ys[0].clone(), ys[1].clone()]
    graphs, outs = [], []
    for static in statics:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append(cuda_qrnn.qrnn_pool_fwd_split(static))
        graphs.append(graph)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for turn in range(3):
        for i, (static, graph, stream) in enumerate(
                zip(statics, graphs, streams)):
            static.copy_(ys[(turn + 2 * i) % 4])
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                graph.replay()
        torch.cuda.synchronize()
        for i, (h, c) in enumerate(outs):
            h_ref, c_ref = cuda_qrnn.qrnn_pool_fwd_split(ys[(turn + 2 * i)
                                                            % 4])
            torch.cuda.synchronize()
            assert torch.equal(h, h_ref) and torch.equal(c, c_ref)


def test_split_kernel_through_the_operator(cuda_device):
    """torch.ops.pase_tpu_torch.qrnn_pool_fwd at [1,10000,512] launches the
    split kernel once and gives the direct call's bits."""
    y, _ = _inputs(1, 10000, 512, cuda_device, seed=5)
    before = dict(cuda_qrnn.LAUNCHES)
    h, c = torch.ops.pase_tpu_torch.qrnn_pool_fwd(y, None)
    assert cuda_qrnn.LAUNCHES == {
        **before, "qrnn_pool_fwd_split": before["qrnn_pool_fwd_split"] + 1}
    h2, c2 = cuda_qrnn.qrnn_pool_fwd_split(y)
    torch.cuda.synchronize()
    assert torch.equal(h, h2) and torch.equal(c, c2)


def test_split_kernel_on_a_b1_encoder_forward(cuda_device):
    """PASE+ at B = 1 on a 100 s file in one forward (10000 frames): one
    split launch per QRNN layer and no other K1 launch; within 2e-4 of
    max|y| of the same weights on the CPU."""
    cfg = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "cfg", "frontend", "PASE+.cfg")
    gpu = wf_builder(cfg, device=cuda_device, seed=0)
    cpu = wf_builder(cfg, device="cpu", seed=0)
    x = (np.random.RandomState(4).randn(1, 1, 1600000) * 0.1).astype(
        np.float32)
    cuda_qrnn.reset_launches()
    y = gpu(x)
    layers = len(gpu.module.rnn.layers)
    assert cuda_qrnn.LAUNCHES == {**{k: 0 for k in cuda_qrnn.LAUNCHES},
                                  "qrnn_pool_fwd_split": layers}
    y_cpu = cpu(x)
    rel = ((y.cpu() - y_cpu).abs().max() / y_cpu.abs().max()).item()
    assert rel <= 2e-4, rel


# the few-lane kernel: one step, a ragged chunk, B = 1 extraction's 200
# steps and one past them, the rehearsal's 8 s, forward-chunk's 10 s
# window, the longest call the route gives it at B = 1 (7499 steps), the
# time shard's [2,1500,512] (the mid tile), the serving batch [8,1000,512]
# and a ragged 1500 lanes (the wide tile), and a narrow ragged one (33
# lanes: a block's 4 lanes across rows, a ragged last block)
FEW_SHAPES = [(1, 1, 512), (1, 7, 512), (1, 200, 512), (1, 201, 512),
              (1, 800, 512), (1, 1000, 512), (1, 7499, 512), (2, 1500, 512),
              (8, 1000, 512), (5, 97, 300), (3, 1237, 11)]
FEW_GATES = [((1, 200, 512), "slow"), ((1, 1000, 512), "slow"),
             ((2, 1500, 512), "frozen"), ((1, 1000, 512), "frozen"),
             ((8, 1000, 512), "frozen")]


@pytest.mark.parametrize(
    "shape,kind", [(s, "randn") for s in FEW_SHAPES] + FEW_GATES, ids=str)
@pytest.mark.parametrize("seeded", [False, True])
def test_few_kernel_matches_plain(cuda_device, shape, kind, seeded):
    """qrnn_pool_fwd_few against the plain version (1e-5) and against the
    plain version of its algebra at the library's chunking, which is
    ops/qrnn.py's (5e-7); two calls bit for bit; one launch each, counted
    under its own name."""
    b, t, hid = shape
    y, c0 = _inputs(*shape, cuda_device, seed=sum(shape))
    y = gates(y, kind)
    c0 = c0 if seeded else None
    assert cuda_qrnn.few_chunking(b * hid, t) == plain.few_tile(b * hid, t)
    before = dict(cuda_qrnn.LAUNCHES)
    h, c = cuda_qrnn.qrnn_pool_fwd_few(y, c0)
    h2, c2 = cuda_qrnn.qrnn_pool_fwd_few(y, c0)
    assert cuda_qrnn.LAUNCHES == {
        **before, "qrnn_pool_fwd_few": before["qrnn_pool_fwd_few"] + 2}
    torch.cuda.synchronize()
    assert torch.equal(h, h2) and torch.equal(c, c2)
    h_ref, c_ref = plain.qrnn_pool(y, c0)
    assert (h - h_ref).abs().max().item() <= 1e-5
    assert (c - c_ref).abs().max().item() <= 1e-5
    hp, cp = plain.qrnn_pool_few_plain(y, c0)
    assert (h - hp).abs().max().item() <= 5e-7
    assert (c - cp).abs().max().item() <= 5e-7


@pytest.mark.parametrize("shape", [(1, 200, 512), (2, 1500, 512),
                                   (8, 1000, 512)], ids=str)
def test_few_kernel_replays_in_a_cuda_graph(cuda_device, shape):
    """A CUDA graph of the few-lane kernel replayed on new inputs gives
    the eager call's bits each time."""
    ys = [_inputs(*shape, cuda_device, seed=s)[0] for s in (1, 2, 3)]
    static = ys[0].clone()
    cuda_qrnn.qrnn_pool_fwd_few(static)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        h, c = cuda_qrnn.qrnn_pool_fwd_few(static)
    for y in ys[1:] + ys[:1]:
        static.copy_(y)
        graph.replay()
        h_ref, c_ref = cuda_qrnn.qrnn_pool_fwd_few(y)
        torch.cuda.synchronize()
        assert torch.equal(h, h_ref) and torch.equal(c, c_ref)


@pytest.mark.parametrize("shape,key", [
    ((1, 200, 512), "qrnn_pool_fwd_few"), ((1, 1000, 512),
                                           "qrnn_pool_fwd_few"),
    ((1, 7499, 512), "qrnn_pool_fwd_few"), ((2, 1500, 512),
                                            "qrnn_pool_fwd_few"),
    ((1, 7500, 512), "qrnn_pool_fwd_split"),
    ((3, 1000, 512), "qrnn_pool_fwd_few")], ids=str)
def test_few_lanes_route_to_the_few_kernel(cuda_device, shape, key):
    """The operator's unseeded route: B = 1 at H = 512 under SPLIT_STEPS
    steps, B = 2 and 1536 lanes to the few-lane kernel, one launch on its
    counter, its bits; from SPLIT_STEPS steps the split kernel."""
    y, _ = _inputs(*shape, cuda_device, seed=7)
    before = dict(cuda_qrnn.LAUNCHES)
    h, c = torch.ops.pase_tpu_torch.qrnn_pool_fwd(y, None)
    assert cuda_qrnn.LAUNCHES == {**before, key: before[key] + 1}
    assert cuda_qrnn.forward_entry(shape[0] * shape[2], False,
                                   shape[1]) == key
    if key == "qrnn_pool_fwd_few":
        h2, c2 = cuda_qrnn.qrnn_pool_fwd_few(y)
        torch.cuda.synchronize()
        assert torch.equal(h, h2) and torch.equal(c, c2)


def test_stream_floor_is_its_elementwise_function(cuda_device):
    """The streaming floor writes sigmoid(o) tanh(z) sigmoid(f) of each
    lane-step (1e-6) and counts no launch; H not a multiple of 4 is
    refused."""
    y, _ = _inputs(2, 300, 512, cuda_device, seed=9)
    before = dict(cuda_qrnn.LAUNCHES)
    h = cuda_qrnn.stream_floor(y)
    z, f, o = torch.chunk(y, 3, dim=-1)
    want = torch.sigmoid(o) * torch.tanh(z) * torch.sigmoid(f)
    assert (h - want).abs().max().item() <= 1e-6
    assert cuda_qrnn.LAUNCHES == before
    with pytest.raises(RuntimeError):
        cuda_qrnn.stream_floor(_inputs(1, 5, 6, cuda_device)[0])


@pytest.mark.parametrize("shape", [(3, 200, 16), (1, 1001, 512)])
def test_block_streaming_is_bit_identical(cuda_device, shape):
    y, c0 = _inputs(*shape, cuda_device, seed=12)
    h_full, c_full = cuda_qrnn.qrnn_pool(y, c0)
    cut = shape[1] // 3
    h1, c1 = cuda_qrnn.qrnn_pool(y[:, :cut].contiguous(), c0)
    h2, c2 = cuda_qrnn.qrnn_pool(y[:, cut:].contiguous(), c1)
    assert torch.equal(torch.cat([h1, h2], 1), h_full)
    assert torch.equal(c2, c_full)


def _steps(spec):
    """T from a spec: an int, or 'S-1' / 'S' / 'S+1' around the segmented
    kernel's segment length S."""
    if isinstance(spec, int):
        return spec
    return cuda_qrnn.segment_steps() + int(spec[1:] or 0)


@pytest.mark.parametrize("t", [1, 10, "S-1", "S", "S+1", 100, 1001],
                         ids=str)
@pytest.mark.parametrize("b,h", [(1, 512), (8, 512), (3, 20)])
@pytest.mark.parametrize("seeded", [False, True])
def test_serial_kernel_equals_the_lane_loop(cuda_device, t, b, h, seeded):
    """The segmented serial forward (gates by every thread of a block, one
    FMA chain per lane) equals the one-thread-a-lane loop bit for bit, and
    the plain version within 1e-5: B in {1, 8} at 512 lanes a row, and
    3 x 20 lanes (not a multiple of a tile's lanes); one step, 100 ms and
    1 s pushes, a segment and one step either side of it, a long stream.
    One launch of each."""
    t = _steps(t)
    y, c0 = _inputs(b, t, h, cuda_device, seed=t + b + h)
    c0 = c0 if seeded else None
    before = dict(cuda_qrnn.LAUNCHES)
    hk, ck = cuda_qrnn.qrnn_pool_fwd_seg(y, c0)
    h_lane, c_lane = cuda_qrnn.qrnn_pool_fwd_loop(y, c0)
    assert cuda_qrnn.LAUNCHES == {
        **before, "qrnn_pool_fwd_seg": before["qrnn_pool_fwd_seg"] + 1,
        "qrnn_pool_fwd": before["qrnn_pool_fwd"] + 1}
    torch.cuda.synchronize()
    assert torch.equal(hk, h_lane) and torch.equal(ck, c_lane)
    h_ref, c_ref = plain.qrnn_pool(y, c0)
    assert (hk - h_ref).abs().max().item() <= 1e-5
    assert (ck - c_ref).abs().max().item() <= 1e-5


@pytest.mark.parametrize("cut", ["S-3", "S", "S+5", 301],
                         ids=str)
@pytest.mark.parametrize("b,h", [(1, 512), (3, 20)])
def test_serial_kernel_block_streamed_equals_full(cuda_device, cut, b, h):
    """Two calls with c_T threaded into the second's c0 == one call, bit
    for bit, cut inside a segment, on its edge and past it."""
    cut = _steps(cut)
    t = cut + 150
    y, c0 = _inputs(b, t, h, cuda_device, seed=cut)
    h_full, c_full = cuda_qrnn.qrnn_pool_fwd_seg(y, c0)
    h1, c1 = cuda_qrnn.qrnn_pool_fwd_seg(y[:, :cut].contiguous(), c0)
    h2, c2 = cuda_qrnn.qrnn_pool_fwd_seg(y[:, cut:].contiguous(), c1)
    assert torch.equal(torch.cat([h1, h2], 1), h_full)
    assert torch.equal(c2, c_full)


@pytest.mark.parametrize("b,t,kernel", [
    (1, 100, "qrnn_pool_fwd_seg_kernel"), (8, 10, "qrnn_pool_fwd_seg_kernel"),
    (1, 1, "qrnn_pool_fwd_seg_kernel"), (16, 10, "qrnn_pool_fwd_seg_kernel"),
    (32, 100, "qrnn_pool_fwd_kernel(")])
def test_serial_forward_routes_by_lanes(cuda_device, b, t, kernel):
    """A seeded qrnn_pool_fwd launches the segmented kernel under
    SEG_LANES lanes and the one-thread-a-lane loop from there on (the same
    bits either way): the kernel's name in a profile."""
    from torch.profiler import ProfilerActivity, profile, schedule
    y, c0 = _inputs(b, t, 512, cuda_device)
    cuda_qrnn.qrnn_pool_fwd(y, c0)
    torch.cuda.synchronize()
    # a warm-up cycle first: a session's first cycle can end before CUPTI
    # delivers the activity of a launch that torch's dispatcher did not
    # make (the kernel goes out through ctypes), and then records none
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=2, repeat=1),
                 acc_events=True) as prof:
        for _ in range(3):
            cuda_qrnn.qrnn_pool_fwd(y, c0)
            torch.cuda.synchronize()
            prof.step()
    names = [e.key for e in prof.key_averages()
             if "qrnn" in e.key and e.device_type.name == "CUDA"]
    assert len(names) == 1 and kernel in names[0], names


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
    name = _unseeded(2, 400, NARROW_CFG["rnn_dim"])
    before = cuda_qrnn.LAUNCHES[name]
    y = gpu(x)
    assert cuda_qrnn.LAUNCHES[name] == before + len(gpu.module.rnn.layers)
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
    assert after["qrnn_pool_fwd_seg"] == before["qrnn_pool_fwd_seg"]
    assert after["qrnn_pool_fwd_few"] == before["qrnn_pool_fwd_few"]
    assert after["qrnn_pool_fwd_eval"] == before["qrnn_pool_fwd_eval"]


def _train_inputs(shape, cuda_device, seeded, dct):
    """y, c0 (or None), dh and dc_T (or None) of a training-pair call."""
    b, t, h = shape
    y, c0 = _inputs(b, t, h, cuda_device, seed=t + h)
    rng = np.random.RandomState(t + b)
    dh = torch.from_numpy(rng.randn(b, t, h).astype(np.float32))
    dc = torch.from_numpy(rng.randn(b, h).astype(np.float32))
    return (y, c0 if seeded else None, dh.to(cuda_device),
            dc.to(cuda_device) if dct else None)


# ragged T (37: one segment of 8 chunks of 5, the last two idle; 201: four
# of 8 x 7 and a fifth of 33 steps) at ragged lanes (120 and 32 lanes, not
# whole blocks), and two training ranks' lane counts: the attention
# variant's rank and a 2 x 2 --n_model rank
TRAIN_CHUNKED_SHAPES = [(3, 37, 40), (2, 201, 16), (24, 200, 512),
                        (48, 200, 256)]


@pytest.mark.parametrize("shape", TRAIN_CHUNKED_SHAPES, ids=str)
@pytest.mark.parametrize("seeded,dct", [(False, False), (True, True)])
def test_train_kernels_match_their_chunked_plain(cuda_device, shape, seeded,
                                                 dct):
    """qrnn_pool_fwd_train and qrnn_pool_bwd against the chunked plain
    versions at the kernels' own chunking (the library's, which the plain
    versions' defaults repeat): h, c, c_T and dc0 within 1e-5, dy within
    1e-5 x max(1, max|dy_plain|); one launch each."""
    y, c0, dh, dct_ = _train_inputs(shape, cuda_device, seeded, dct)
    t = shape[1]
    chunks, len_fwd, len_bwd = cuda_qrnn.train_chunking(t)
    assert (chunks, len_fwd, len_bwd) == (
        plain.TRAIN_CHUNKS, plain.train_chunk_len(t, chunks, plain.FWD_CHUNK),
        plain.train_chunk_len(t, chunks, plain.BWD_CHUNK))
    before = dict(cuda_qrnn.LAUNCHES)
    hk, ck, ctk = cuda_qrnn.qrnn_pool_fwd_train(y, c0)
    dyk, dc0k = cuda_qrnn.qrnn_pool_bwd(y, ck, dh, dct_, c0)
    assert cuda_qrnn.LAUNCHES == {
        **before, "qrnn_pool_fwd_train": before["qrnn_pool_fwd_train"] + 1,
        "qrnn_pool_bwd": before["qrnn_pool_bwd"] + 1}
    hp, cp, ctp = plain.qrnn_pool_fwd_train_chunked_plain(
        y, c0, chunk=len_fwd, chunks=chunks)
    dyp, dc0p = plain.qrnn_pool_bwd_chunked_plain(
        y, ck, dh, dct_, c0, chunk=len_bwd, chunks=chunks)
    torch.cuda.synchronize()
    for got, want in ((hk, hp), (ck, cp), (ctk, ctp)):
        assert (got - want).abs().max().item() <= 1e-5
    assert (dyk - dyp).abs().max().item() <= \
        1e-5 * max(1.0, dyp.abs().max().item())
    if seeded:
        assert (dc0k - dc0p).abs().max().item() <= 1e-5
    else:
        assert dc0k is None


@pytest.mark.parametrize("shape", [(3, 37, 40), (24, 200, 512)], ids=str)
def test_train_kernels_are_deterministic_and_capture(cuda_device, shape):
    """Two calls of the training pair give the same bits (no atomics, one
    order of composition), and a CUDA graph of one fwd_train + bwd gives
    them too when replayed."""
    y, c0, dh, dct = _train_inputs(shape, cuda_device, True, True)

    def run():
        h, c, c_last = cuda_qrnn.qrnn_pool_fwd_train(y, c0)
        return (h, c, c_last) + cuda_qrnn.qrnn_pool_bwd(y, c, dh, dct, c0)

    first, second = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(first, second))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(first, captured))


def test_qrnn_pool_function_launches_each_training_kernel_once(cuda_device):
    """One QRNNPool forward and backward at a training rank's lanes (the
    attention variant's [24,200,512]) launches qrnn_pool_fwd_train and
    qrnn_pool_bwd once each and nothing else."""
    y, _ = _inputs(24, 200, 512, cuda_device)
    before = dict(cuda_qrnn.LAUNCHES)
    h, _ = cuda_qrnn.qrnn_pool(y.clone().requires_grad_())
    h.sum().backward()
    torch.cuda.synchronize()
    assert cuda_qrnn.LAUNCHES == {
        **before, "qrnn_pool_fwd_train": before["qrnn_pool_fwd_train"] + 1,
        "qrnn_pool_bwd": before["qrnn_pool_bwd"] + 1}


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


def _small_workers():
    """workers+ at hidden_size 32, the cchunk decoder at [16, 16, 8]."""
    import json
    with open("cfg/workers/workers+.cfg") as f:
        wk = json.load(f)
    for group in ("regr", "cls"):
        for e in wk[group]:
            e["hidden_size"] = 32
            if e["name"] == "cchunk":
                e["fmaps"] = [16, 16, 8]
    return wk


def _small_trainer(device, save_path, compute_dtype=None, gan_cfg=None):
    from pase_tpu_torch.trainer import Trainer
    fe = dict(NARROW_CFG, strides=[1, 10, 4, 4])
    cfg = dict(batch_size=2, chunk_size=4800, fe_lr=5e-4, min_lr=5e-4,
               lr_mode="poly", save_path=str(save_path),
               compute_dtype=compute_dtype)
    return Trainer(fe, _small_workers(), cfg, device=device,
                   gan_cfg=gan_cfg)


def test_bf16_step_launches_the_training_kernels(cuda_device, tmp_path):
    """Two bf16 train steps: qrnn_pool_fwd_train and qrnn_pool_bwd once
    per QRNN layer per step, no other kernel; every loss finite."""
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    from pase_tpu_torch.ops import conv as conv_ops
    tr = _small_trainer(cuda_device, tmp_path, "bfloat16")
    it = iter(SyntheticChunkBatcher(2, 4800, seed=3))
    cuda_qrnn.reset_launches()
    conv_ops.reset_launches()
    for _ in range(2):
        losses = tr.train_step(next(it))
        assert all(torch.isfinite(v) for v in losses.values())
    layers = len(tr.model.frontend.rnn.layers)
    assert cuda_qrnn.LAUNCHES == {
        "qrnn_pool_fwd_split": 0, "qrnn_pool_fwd_few": 0,
        "qrnn_pool_fwd_seg": 0, "qrnn_pool_fwd": 0,
        "qrnn_pool_fwd_eval": 0,
        "qrnn_pool_fwd_train": 2 * layers, "qrnn_pool_bwd": 2 * layers}
    assert not any(conv_ops.LAUNCHES.values())


def test_bf16_qrnn_gates_reach_the_kernels_as_float32(cuda_device,
                                                      monkeypatch):
    """Under the bf16 policy the QRNN's linear runs in bf16 and its gates
    reach the training kernels as float32; the forward and backward
    kernels each launch once, the output and the gradients are finite
    and float32."""
    from pase_tpu_torch import nn as pnn
    from pase_tpu_torch.precision import compute_dtype
    layer = pnn.QRNN(16, 24).to(cuda_device)
    seen = []
    fwd = cuda_qrnn.qrnn_pool_fwd_train

    def spy(y, c0=None):
        seen.append(y.dtype)
        return fwd(y, c0)

    monkeypatch.setattr(cuda_qrnn, "qrnn_pool_fwd_train", spy)
    x = torch.randn(3, 40, 16, device=cuda_device, requires_grad=True)
    before = dict(cuda_qrnn.LAUNCHES)
    with compute_dtype(torch.bfloat16):
        h = layer(x)
    h.float().pow(2).sum().backward()
    assert seen == [torch.float32]
    assert h.dtype == torch.float32 and bool(torch.isfinite(h).all())
    assert cuda_qrnn.LAUNCHES["qrnn_pool_fwd_train"] == \
        before["qrnn_pool_fwd_train"] + 1
    assert cuda_qrnn.LAUNCHES["qrnn_pool_bwd"] == \
        before["qrnn_pool_bwd"] + 1
    grad = layer.layers[0].linear.weight.grad
    assert grad.dtype == torch.float32 and bool(torch.isfinite(grad).all())


@pytest.mark.parametrize("dtype,rel", [(torch.bfloat16, 2.0 ** -7),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("layer", [
    (160, 20, 10, 64, 64), (37, 11, 1, 48, 70), (200, 11, 2, 128, 256),
    (9, 3, 1, 5, 3), (50, 1, 1, 24, 40), (1600, 20, 10, 64, 64),
    (400, 11, 2, 512, 512), (120, 20, 1, 16, 24)])
def test_conv_kernel_matches_plain(cuda_device, dtype, rel, layer):
    """Each route's kernel (conv_s1_tc for bf16, conv_s1_tf32x3 for
    float32) against the plain version. Ragged tiles in t, c and o
    included (37 steps, 48 / 5 channels, 70 / 3 outputs; C = 5 is copied
    to 8), K=1, the L1 fold read as a strided view (K=20 s=10), L7's shape
    at batch 3 (one flattened slab), and 20 taps at stride 1 (two tap
    groups of the kernels' windows)."""
    t, k, s, cin, cout = layer
    gen = torch.Generator(device=cuda_device).manual_seed(sum(layer))
    x = torch.randn((3, t + k - 1, cin), generator=gen,
                    device=cuda_device).to(dtype)
    w = torch.randn((k, cin, cout), generator=gen, device=cuda_device) * 0.05
    name = conv.route(x)
    before = dict(conv.LAUNCHES)
    y = conv.conv_strided(x, w, s)
    assert conv.LAUNCHES == {**before, name: before[name] + 1}
    xs, ws, tout = conv.space_to_depth(x, w, s)
    want = conv.conv_s1_plain(xs, ws)[:, :tout]
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == want.shape
    err = (y.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item(), err


def test_conv_launches_count_by_route(cuda_device):
    """One bf16 call counts one conv_s1_tc launch, one float32 call one
    conv_s1_tf32x3 launch (its w split included), and nothing else."""
    x = torch.randn(2, 40, 16, device=cuda_device)
    w = torch.randn(3, 16, 8, device=cuda_device)
    before = dict(conv.LAUNCHES)
    conv.conv_s1(x.to(torch.bfloat16), w)
    assert conv.LAUNCHES == {**before,
                             "conv_s1_tc": before["conv_s1_tc"] + 1}
    conv.conv_s1(x, w)
    assert conv.LAUNCHES == {
        "conv_s1_tf32x3": before["conv_s1_tf32x3"] + 1,
        "conv_s1_tc": before["conv_s1_tc"] + 1}


def test_conv_tc_reads_the_l1_view_in_place(cuda_device):
    """L1's space-to-depth view goes into conv_s1_tc without a copy: the
    call's peak memory rises by less than x's bytes (y and w are a tenth
    of them)."""
    _reads_the_l1_view_in_place(cuda_device, torch.bfloat16, 2.0 ** -7)


def test_conv_tf32x3_reads_the_l1_view_in_place(cuda_device):
    """The same for conv_s1_tf32x3 in float32 (its w split is 2 x w)."""
    _reads_the_l1_view_in_place(cuda_device, torch.float32, 1e-5)


def _reads_the_l1_view_in_place(cuda_device, dtype, rel):
    x = torch.randn((8, 16019, 64), device=cuda_device).to(dtype)
    w = torch.randn((20, 64, 64), device=cuda_device) * 0.05
    xs, ws, tout = conv.space_to_depth(x, w, 10)
    assert xs.data_ptr() == x.data_ptr() and not xs.is_contiguous()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y = conv.conv_s1(xs, ws)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    assert rise < x.numel() * x.element_size(), rise
    want = conv.conv_s1_plain(xs, ws)
    err = (y.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item(), err


def test_conv_kernel_refuses(cuda_device):
    x = torch.randn(2, 30, 4, device=cuda_device)
    with pytest.raises(TypeError):
        conv.conv_s1(x.double(), torch.randn(3, 4, 2, device=cuda_device))
    with pytest.raises(TypeError):
        conv.conv_s1(x.half(), torch.randn(3, 4, 2, device=cuda_device))
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError):
            conv.conv_s1(x.to(dt), torch.randn(3, 5, 2, device=cuda_device))
        with pytest.raises(ValueError):
            conv.conv_s1(x.to(dt), torch.randn(31, 4, 2, device=cuda_device))


def test_distortions_gpu_match_cpu(cuda_device):
    """Every stage at p = 1 on the card against the CPU, same draws."""
    from pase_tpu_torch.data import distortions as D
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    rng = np.random.RandomState(0)
    t = 4800
    ir = np.zeros((2, 300), np.float32)
    ir[:, 0], ir[1, 40] = 1.0, 0.5
    assets = D.DistortionAssets(
        ir_bank=torch.from_numpy(ir), ir_pmax=torch.tensor([0, 0]),
        noise_bank=torch.from_numpy(rng.randn(3, 2 * t).astype(np.float32)),
        overlap_bank=torch.from_numpy(rng.randn(2, 2 * t).astype(
            np.float32)),
        bandrop_bank=torch.from_numpy(rng.randn(2, 65).astype(np.float32)),
        bandrop_lens=torch.tensor([65, 33], dtype=torch.int32),
        downsample_bank=torch.from_numpy(rng.randn(1, 65).astype(
            np.float32)),
        resample_filters=D.build_resample_filters((2, 4)))
    cfg = D.DistortionConfig(
        reverb_p=1.0, overlap_p=1.0, overlap_reverb=True, noises_p=1.0,
        speed_p=1.0, speed_range=(-0.1, 0.1), resample_p=1.0,
        resample_factors=(2, 4), clip_p=1.0, chop_p=1.0, bandrop_p=1.0,
        downsample_p=1.0)
    wav = torch.from_numpy(next(iter(SyntheticChunkBatcher(4, t)))["chunk"])
    draws = D.draw_distortions(torch.Generator().manual_seed(1), 4, t, cfg,
                               assets)
    y_cpu, m_cpu = D.apply_distortions(wav, draws, cfg, assets)
    y, m = D.apply_distortions(wav.to(cuda_device), draws.to(cuda_device),
                               cfg, assets.to(cuda_device))
    assert (y.cpu() - y_cpu).abs().max() <= 1e-5 * y_cpu.abs().max()
    assert (m.cpu() - m_cpu).abs().max() <= 1e-7


def test_stage_copies_host_batches_and_keeps_device_ones(cuda_device,
                                                         tmp_path):
    """Trainer.stage on the card: host arrays cross through pinned memory
    on the side stream (int16 waveforms under the int16 wire) and the
    step's stream waits for the copy; tensors already on the card are the
    same tensors after staging."""
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    tr = _small_trainer(cuda_device, tmp_path)
    tr.wire_int16 = True
    raw = next(iter(SyntheticChunkBatcher(2, 4800, seed=3)))
    on_card = torch.ones(2, device=cuda_device)
    staged = tr.stage(dict(raw, dist_mask=on_card))
    assert staged.event is not None
    batch = tr.ready(staged)
    assert batch["dist_mask"] is on_card
    for k in ("chunk", "chunk_ctxt", "chunk_rand"):
        want = np.clip(raw[k] * 32768.0, -32768, 32767).astype(np.int16)
        assert batch[k].dtype == torch.int16 and batch[k].is_cuda
        np.testing.assert_array_equal(batch[k].cpu().numpy(), want)
    losses = tr.train_step(staged)
    assert all(torch.isfinite(v) for v in losses.values())


def test_device_corpus_rows_on_the_card(cuda_device, tmp_path):
    """The card-resident corpus: the buffer equals the CPU build's, and
    every row of a batch is the wav's samples at the start drawn on the
    card."""
    from pase_tpu_torch.data.dataset import LibriSpeechTupleDataset, crop_at
    from pase_tpu_torch.data.device_corpus import DeviceCorpusBatcher
    from pase_tpu_torch.data.io import read_wav
    from pase_tpu_torch.data.synthetic_corpus import write_synthetic_corpus
    root, cfg = write_synthetic_corpus(str(tmp_path), 20, 2,
                                       min_seconds=0.2, max_seconds=2.0)
    ds = LibriSpeechTupleDataset(root, cfg, "train")
    names = [w["filename"] for w in ds.wavs]
    card = DeviceCorpusBatcher(ds, 8, 16000, seed=1, device=cuda_device)
    host = DeviceCorpusBatcher(LibriSpeechTupleDataset(root, cfg, "train"),
                               8, 16000, seed=1, device="cpu")
    assert torch.equal(card.buf.cpu(), host.buf)
    batch = card.make_batch(3)
    starts = card.sample_starts(3).cpu().numpy()
    for role, key in enumerate(("chunk", "chunk_ctxt", "chunk_rand")):
        for r in range(8):
            i = int(np.searchsorted(card.offsets, starts[role, r], "right")
                    - 1)
            off = int(starts[role, r] - card.offsets[i])
            wav, _ = read_wav(os.path.join(root, names[i]))
            wav = crop_at(wav, 0, 16000) if len(wav) < 16000 else wav
            np.testing.assert_array_equal(batch[key][r].cpu().numpy(),
                                          wav[off:off + 16000])


def test_registered_op_launches_and_routes(cuda_device):
    """torch.ops.pase_tpu_torch.qrnn_pool_fwd on CUDA tensors launches the
    kernels, the route taken inside the operator from the call's shapes:
    unseeded on 1 x 512 lanes the few-lane kernel's narrow tile, on 4 x
    512 its wide one, on 64 x 512 the chunked eval kernel; seeded,
    on 1 x 512 the segmented one, on 64 x 512 the one-thread-a-lane one.
    Within 1e-5 of the plain version."""
    op = torch.ops.pase_tpu_torch.qrnn_pool_fwd
    for b, seeded, name in ((1, False, "qrnn_pool_fwd_few"),
                            (4, False, "qrnn_pool_fwd_few"),
                            (64, False, "qrnn_pool_fwd_eval"),
                            (1, True, "qrnn_pool_fwd_seg"),
                            (64, True, "qrnn_pool_fwd")):
        y, c0 = _inputs(b, 50, 512, cuda_device, seed=b)
        c0 = c0 if seeded else None
        before = dict(cuda_qrnn.LAUNCHES)
        h, c = op(y, c0)
        assert cuda_qrnn.LAUNCHES == {**before, name: before[name] + 1}
        hp, cp = plain.qrnn_pool(y, c0)
        assert (h - hp).abs().max().item() <= 1e-5
        assert (c - cp).abs().max().item() <= 1e-5
    with pytest.raises(TypeError):
        op(torch.randn(2, 5, 6, device=cuda_device).double(), None)


def test_streaming_is_bit_identical_across_chunkings(cuda_device):
    """The narrow encoder streamed on the card in three chunkings: the
    frames are equal bit for bit, within the streaming contract of the
    offline forward, and every pooling call took the seeded segmented
    kernel."""
    from pase_tpu_torch.streaming import StreamingEncoder
    enc = wf_builder(dict(NARROW_CFG, strides=[1, 10, 4, 4]),
                     device=cuda_device)
    wav = torch.from_numpy((np.random.RandomState(3).randn(2, 16000)
                            * 0.1).astype(np.float32)).to(cuda_device)
    outs = []
    for chunk in (16000, 4000, 1600):
        cuda_qrnn.reset_launches()
        st = StreamingEncoder(enc)
        ys = [st.push(wav[:, i:i + chunk])
              for i in range(0, 16000, chunk)] + [st.flush()]
        outs.append(torch.cat([y for y in ys if y is not None], 2))
        assert cuda_qrnn.LAUNCHES["qrnn_pool_fwd_split"] == 0
        assert cuda_qrnn.LAUNCHES["qrnn_pool_fwd_few"] == 0
        assert cuda_qrnn.LAUNCHES["qrnn_pool_fwd_seg"] == st.qrnn_calls
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    ref = enc(wav)
    assert torch.allclose(outs[0], ref, rtol=1e-3, atol=2e-4)


def test_exported_bucket_runs_on_the_card(cuda_device, tmp_path):
    """A bucket exported on the card serves there (meta device 'cuda'),
    within 2e-5 of the offline encoder, through the few-lane kernel at a
    small batch and the chunked eval kernel from
    EVAL_LANES lanes."""
    from pase_tpu_torch import serving
    enc = wf_builder(dict(NARROW_CFG, strides=[1, 10, 4, 4]),
                     device=cuda_device)
    serving.export_encoder(enc, str(tmp_path), chunk_sizes=(1600,))
    srv = serving.ServingEncoder(str(tmp_path))
    assert srv.meta["device"] == "cuda"
    lanes = NARROW_CFG["rnn_dim"]
    for b, name in ((2, "qrnn_pool_fwd_few"),
                    (cuda_qrnn.EVAL_LANES // lanes, "qrnn_pool_fwd_eval")):
        wav = (np.random.RandomState(b).randn(b, 1600) * 0.1).astype(
            np.float32)
        before = dict(cuda_qrnn.LAUNCHES)
        got = srv._call(1600, wav)
        assert cuda_qrnn.LAUNCHES == {**before, name: before[name] + 1}
        ref = enc(wav).transpose(1, 2).cpu().numpy()
        assert np.abs(got - ref).max() <= 2e-5


def test_vq_argmin_and_ema_on_the_card(cuda_device):
    """VQEMA at 512 codes of width 256 on the card against the CPU, one
    training call: the codes equal outside ties (grad_parity.vq_codes
    forces the card's at the CPU's ties), then the output, the loss and
    the EMA state within 1e-5 of their largest."""
    from pase_tpu_torch.grad_parity import code_flips, vq_codes
    from pase_tpu_torch.nn import VQEMA
    gen = torch.Generator().manual_seed(4)
    cpu = VQEMA(512, 256, generator=gen).train()
    gpu = VQEMA(512, 256).train()
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(cuda_device)
    x = torch.randn(3, 200, 256, generator=gen)
    rec_gpu, rec_cpu, forced = {}, {}, {}
    with vq_codes(gpu, record=rec_gpu):
        y_gpu = gpu(x.to(cuda_device))
    with vq_codes(cpu, record=rec_cpu, force={"": rec_gpu[""][0]},
                  forced=forced):
        y_cpu = cpu(x)
    assert code_flips(rec_cpu, rec_gpu)[""] == (0, 0)
    for a, b in ((y_gpu, y_cpu), (gpu.loss, cpu.loss),
                 (gpu.emb, cpu.emb), (gpu.ema_w, cpu.ema_w),
                 (gpu.ema_cluster_size, cpu.ema_cluster_size)):
        err = (a.detach().cpu() - b.detach()).abs().max()
        assert err <= 1e-5 * b.detach().abs().max(), err


@pytest.mark.parametrize("cin", [16, 24])
def test_feresblock_on_the_card(cuda_device, cin):
    """FeResBlock (kwidth 11, downsample 2, with and without resproj) on
    the card against the CPU, train and eval: within 1e-5 of the largest
    output."""
    from pase_tpu_torch.nn import FeResBlock
    cpu = FeResBlock(cin, 24, 11, downsample=2, norm_type="bnorm",
                     generator=torch.Generator().manual_seed(5))
    gpu = FeResBlock(cin, 24, 11, downsample=2, norm_type="bnorm")
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(cuda_device)
    x = torch.randn(4, cin, 3000, generator=torch.Generator().manual_seed(6))
    for train in (True, False):
        y_gpu = gpu.train(train)(x.to(cuda_device)).detach().cpu()
        y_cpu = cpu.train(train)(x).detach()
        assert y_gpu.shape == (4, 24, 1500)
        err = (y_gpu - y_cpu).abs().max() / y_cpu.abs().max()
        assert err <= 1e-5, (train, err)


def _gan_trainers(cuda_device, tmp_path, gan_cfg, compute_dtype=None):
    """The card's and the CPU's small trainer with a GAN worker, the
    same model and discriminator weights."""
    gpu = _small_trainer(cuda_device, tmp_path / "gpu", compute_dtype,
                         dict(gan_cfg))
    cpu = _small_trainer("cpu", tmp_path / "cpu", compute_dtype,
                         dict(gan_cfg))
    cpu.model.load_state_dict(gpu.model.state_dict())
    cpu.discriminator.load_state_dict(gpu.discriminator.state_dict())
    return gpu, cpu


@pytest.mark.parametrize("gan_cfg", [
    {"worker": "cchunk", "loss": "LSGAN", "lr": 4e-4, "weight": 1.0},
    {"type": "z", "loss": "BCE", "lr": 5e-4, "weight": 0.1,
     "cchunk_prior": True}], ids=["wave", "z_prior"])
def test_gan_step_gpu_matches_cpu(cuda_device, tmp_path, gan_cfg):
    """One small GAN step on the card vs the CPU: every loss, the G term
    and d_loss within 1e-4 relative; the model's gradients within 1e-3 of
    each part's largest; D's gradients within 1e-3 of its largest; u
    within 1e-5; the training kernels once per QRNN layer, on the
    encoder's one call of the step (four streams with the cchunk
    prior)."""
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    gpu, cpu = _gan_trainers(cuda_device, tmp_path, gan_cfg)
    raw = next(iter(SyntheticChunkBatcher(2, 4800, seed=3)))
    cuda_qrnn.reset_launches()
    lg = gpu.train_step(raw)
    torch.cuda.synchronize()
    layers = len(gpu.model.frontend.rnn.layers)
    assert cuda_qrnn.LAUNCHES["qrnn_pool_fwd_train"] == layers
    assert cuda_qrnn.LAUNCHES["qrnn_pool_bwd"] == layers
    lc = cpu.train_step(raw)
    assert set(lg) == set(lc)
    for k in lc:
        assert abs(float(lg[k]) - float(lc[k])) <= 1e-4 * abs(float(lc[k])), k
    for part in ("frontend", "workers"):
        g = [p.grad for p in getattr(gpu.model, part).parameters()]
        c = [p.grad for p in getattr(cpu.model, part).parameters()]
        top = max(x.abs().max().item() for x in c)
        diff = max((a.cpu() - b).abs().max().item() for a, b in zip(g, c))
        assert diff <= 1e-3 * top, (part, diff, top)
    dg = [p.grad for p in gpu.discriminator.parameters()]
    dc = [p.grad for p in cpu.discriminator.parameters()]
    top = max(x.abs().max().item() for x in dc)
    assert max((a.cpu() - b).abs().max().item()
               for a, b in zip(dg, dc)) <= 1e-3 * top
    for (k, a), b in zip(gpu.discriminator.named_buffers(),
                         cpu.discriminator.buffers()):
        assert (a.cpu() - b).abs().max().item() <= 1e-5, k


def test_bf16_gan_steps_launch_the_training_kernels(cuda_device, tmp_path):
    """Two bf16 wave-GAN steps: the training kernels once per QRNN layer
    per step (D adds none), every loss finite, D's Adam at count 2."""
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    from pase_tpu_torch.ops import conv as conv_ops
    gpu, _ = _gan_trainers(
        cuda_device, tmp_path,
        {"worker": "cchunk", "loss": "LSGAN", "lr": 4e-4}, "bfloat16")
    it = iter(SyntheticChunkBatcher(2, 4800, seed=5))
    cuda_qrnn.reset_launches()
    conv_ops.reset_launches()
    for _ in range(2):
        losses = gpu.train_step(next(it))
        assert all(bool(torch.isfinite(v)) for v in losses.values())
    torch.cuda.synchronize()
    layers = len(gpu.model.frontend.rnn.layers)
    want = {k: 0 for k in cuda_qrnn.LAUNCHES}
    want.update(qrnn_pool_fwd_train=2 * layers, qrnn_pool_bwd=2 * layers)
    assert cuda_qrnn.LAUNCHES == want
    assert all(v == 0 for v in conv_ops.LAUNCHES.values())
    assert all(int(st["step"]) == 2
               for st in gpu.d_opt.state.values())


def test_probe_extraction_gpu_matches_cpu(cuda_device):
    """The probes' PASE+ extractor at batch 1 on a 2 s utterance (the
    1600-sample bucket, 'avg_concat'): the card within 2e-4 of max|y| of
    the same weights on the CPU, K1's few-lane kernel (the unseeded route
    at B = 1) once per QRNN layer and no other forward kernel."""
    from pase_tpu_torch.probes.extract import FeatureExtractor
    cfg = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "cfg", "frontend", "PASE+.cfg")
    gpu = FeatureExtractor(cfg, mode="avg_concat", device=cuda_device)
    cpu = FeatureExtractor(cfg, mode="avg_concat", device="cpu")
    cpu.encoder.module.load_state_dict(gpu.encoder.module.state_dict())
    wav = (np.random.RandomState(0).randn(31000) * 0.1).astype(np.float32)
    cuda_qrnn.reset_launches()
    got = gpu.extract(wav)
    layers = len(gpu.encoder.module.rnn.layers)
    assert cuda_qrnn.LAUNCHES == {**{k: 0 for k in cuda_qrnn.LAUNCHES},
                                  "qrnn_pool_fwd_few": layers}
    want = cpu.extract(wav)
    assert got.shape == want.shape == (194, 2 * gpu.encoder.emb_dim)
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()


def test_probe_fit_gpu_matches_cpu(cuda_device):
    """build_mlp_probe + fit, 3 epochs on tie-free clusters, on the card
    and the CPU from the same init: the same dev errors and halvings,
    parameters within 1e-4 of each leaf's largest (the bias that feeds
    the BatchNorm, rounding noise about 0, within 1e-6)."""
    from pase_tpu_torch.probes import classifier as pc
    rng = np.random.RandomState(3)
    centers = rng.randn(3, 6) * 4.0
    y = rng.randint(0, 3, 600).astype(np.int32)
    x = (centers[y] + rng.randn(600, 6) * 0.3).astype(np.float32)
    yd = rng.randint(0, 3, 150)
    xd = (centers[yd] + rng.randn(150, 6) * 0.3).astype(np.float32)
    yd = np.where(rng.rand(150) < 0.1, (yd + 1) % 3, yd).astype(np.int32)
    logs, models = {}, {}
    for dev in (cuda_device, "cpu"):
        key = str(dev)
        models[key] = pc.build_mlp_probe(6, 3, (16,), seed=5, device=dev)
        logs[key] = []
        pc.fit(models[key], x, y, xd, yd, epochs=3, lr=0.1, batch_size=64,
               seed=5, log=lambda s, k=key: logs[k].append(
                   s.split(" nll ")[1].split(" ", 2)[2]))
    assert logs[str(cuda_device)] == logs["cpu"]
    got = models[str(cuda_device)].state_dict()
    for k, w in models["cpu"].state_dict().items():
        diff = (got[k].cpu() - w).abs().max().item()
        bound = 1e-6 if k == "dense.0.bias" else 1e-4 * w.abs().max().item()
        assert diff <= bound, (k, diff)


# ---------------------------------------------------------------------------
# the recurrent layers: BiRNN, the lstm WaveFe, the WaveRNN head, generate
# (bounds: 1e-5 of the largest output for a layer, 2e-4 for the encoder,
# 1e-4 of the largest logit for the head and for generate's loop against
# the teacher-forced forward, 1e-3 of each leaf's largest gradient)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_birnn_gpu_matches_cpu(cuda_device, cell):
    from pase_tpu_torch.nn import BiRNN
    torch.manual_seed(0)
    cpu = BiRNN(64, 32, layers=2, cell=cell,
                generator=torch.Generator().manual_seed(1))
    gpu = BiRNN(64, 32, layers=2, cell=cell).to(cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.RandomState(2).randn(3, 150, 64)
                         .astype(np.float32))
    r = torch.randn(3, 150, 64)
    (cpu(x) * r).sum().backward()
    y = gpu(x.to(cuda_device))
    (y * r.to(cuda_device)).sum().backward()
    with torch.no_grad():
        want = cpu(x)
    assert (y.detach().cpu() - want).abs().max() <= 1e-5 * want.abs().max()
    for (k, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        err = (pg.grad.cpu() - pc.grad).abs().max()
        assert err <= 1e-3 * pc.grad.abs().max(), k


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_rnn_encoder_gpu_matches_cpu(cuda_device, rnn_type):
    cfg = dict(NARROW_CFG, rnn_type=rnn_type)
    gpu = wf_builder(cfg, device=cuda_device, seed=3)
    cpu = wf_builder(cfg, device="cpu", seed=3)
    x = (np.random.RandomState(4).randn(2, 1, 16000) * 0.1).astype(
        np.float32)
    cuda_qrnn.reset_launches()
    y = gpu(x).cpu()
    assert sum(cuda_qrnn.LAUNCHES.values()) == 0     # no QRNN there
    want = cpu(x)
    assert (y - want).abs().max() <= 2e-4 * want.abs().max()


def _wavernn_pair(cuda_device, mode):
    from pase_tpu_torch.wavernn import WaveRNNMinion
    kw = dict(rnn_dims=64, fc_dims=64, bits=9, mode=mode,
              res_out_dims=32)
    cpu = WaveRNNMinion(24, generator=torch.Generator().manual_seed(5),
                        **kw)
    gpu = WaveRNNMinion(24, **kw).to(cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(6)
    mels = torch.from_numpy(rng.randn(2, 24, 3 + 4).astype(np.float32))
    x = torch.from_numpy(np.clip(rng.randn(2, 480) * 0.3, -1, 1)
                         .astype(np.float32))
    return cpu, gpu, mels, x


@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_wavernn_head_gpu_matches_cpu(cuda_device, mode):
    """Train-mode logits and the head's gradients under the CPU's loss
    cotangent (MoL's branch at cdf_delta = 1e-5 is a kink)."""
    from pase_tpu_torch.wavernn import (discretized_mix_logistic_loss,
                                        raw_loss)
    cpu, gpu, mels, x = _wavernn_pair(cuda_device, mode)
    cpu.train()
    gpu.train()
    lc = cpu(x, mels).detach().requires_grad_()
    loss = (raw_loss(lc, x) if mode == "RAW"
            else discretized_mix_logistic_loss(lc, x))
    loss.backward()
    yc = cpu(x, mels)
    yc.backward(lc.grad)
    yg = gpu(x.to(cuda_device), mels.to(cuda_device))
    yg.backward(lc.grad.to(cuda_device))
    assert (yg.detach().cpu() - yc.detach()).abs().max() <= \
        1e-4 * yc.abs().max()
    for (k, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        err = (pg.grad.cpu() - pc.grad).abs().max()
        assert err <= 1e-3 * pc.grad.abs().max(), k


def test_generate_on_the_card_is_teacher_forcing(cuda_device):
    from pase_tpu_torch.wavernn import generate
    _, gpu, mels, _ = _wavernn_pair(cuda_device, "RAW")
    m = mels.to(cuda_device)
    wav, fed, logits = generate(
        gpu, m, torch.Generator(device=cuda_device).manual_seed(0),
        return_logits=True)
    assert wav.shape == (2, 480) and wav.abs().max() <= 1 + 1e-5
    x_prev = torch.nn.functional.pad(fed, (1, 0))[:, :-1]
    with torch.no_grad():
        tf = gpu.eval()(x_prev, m)
    assert (tf - logits).abs().max() <= 1e-4 * logits.abs().max()


# the alternative encoders (pase_tpu_torch.encoders) at narrow widths: the
# frames they emit per 16000 samples and the QRNN layers they pool with
ENCODER_CFGS = {
    "tdnn": ({"name": "tdnn", "emb_dim": 16, "fmaps": 8, "kwidth": 161,
              "rnn_pool": True}, 100, 1),
    "asppRes": ({"name": "asppRes", "sinc_out": 4, "hidden_dim": 8,
                 "sinc_kernel": 33, "fmaps": [4, 4, 4, 4],
                 "concat": [False, True, False, True], "rnn_pool": True,
                 "rnn_add": True}, 100, 1),
    "Resnet50": ({"name": "Resnet50", "sinc_out": 4, "hidden_dim": 8,
                  "sinc_kernel": 33, "stage_fmaps": [8, 8, 16, 16],
                  "stage_blocks": [1, 1, 1, 1]}, 400, 0)}


@pytest.mark.parametrize("name", sorted(ENCODER_CFGS))
def test_alternative_encoder_gpu_matches_cpu(cuda_device, name):
    """TDNNFe, ASPPResEncoder and ResnetEncoder on the card against the
    same weights on the CPU (2e-4 of the largest output); the QRNN of the
    first two launches the few-lane kernel (a few lanes) once a call."""
    cfg, frames, layers = ENCODER_CFGS[name]
    gpu = wf_builder(cfg, device=cuda_device, seed=0)
    cpu = wf_builder(cfg, device="cpu", seed=0)
    x = (np.random.RandomState(1).randn(2, 1, 16000) * 0.1).astype(
        np.float32)
    before = dict(cuda_qrnn.LAUNCHES)
    y = gpu(x)
    launched = {k: cuda_qrnn.LAUNCHES[k] - before[k] for k in before}
    assert launched == {**{k: 0 for k in before},
                        "qrnn_pool_fwd_few": layers}, launched
    y_cpu = cpu(x)
    assert tuple(y.shape) == tuple(y_cpu.shape) == (2, gpu.emb_dim, frames)
    rel = ((y.cpu() - y_cpu).abs().max() / y_cpu.abs().max()).item()
    assert rel <= 2e-4, rel


# ---------------------------------------------------------------------------
# AMI, the step-level tools, the reference layouts and the trainer's rows
# ---------------------------------------------------------------------------

SLICE_FE = dict(NARROW_CFG, strides=[1, 10, 4, 4])   # hop 160, a QRNN
SLICE_WK = {"regr": [{"name": "mfcc", "num_outputs": 39, "hidden_size": 32,
                      "hidden_layers": 1, "r": 1, "loss": "MSELoss",
                      "dropout": 0, "skip": False}],
            "cls": [{"name": "mi", "num_outputs": 1, "hidden_size": 32,
                     "hidden_layers": 1, "loss": "BCEWithLogitsLoss",
                     "dropout": 0, "skip": False}]}


def _slice_cfgs(tmp_path):
    import json
    paths = []
    for name, cfg in (("fe.cfg", SLICE_FE), ("wk.cfg", SLICE_WK)):
        paths.append(str(tmp_path / name))
        with open(paths[-1], "w") as f:
            json.dump(cfg, f)
    return paths


def test_ami_cli_steps_on_the_card(cuda_device, tmp_path, monkeypatch):
    """A seeded AMI meeting, segmented and described by the port's
    data_prep, trained by the CLI on the card in tree mode (the far-field
    channel 1 against the headsets) for two steps: the training kernels
    once per QRNN layer per step, every loss finite, FE_e0.npz written."""
    import glob
    import json
    from pase_tpu_torch import data_prep, train as port_train
    from pase_tpu_torch.data.synthetic_corpus import write_synthetic_ami
    from pase_tpu_torch.trainer import Trainer
    # 40 s meetings: enough headset segments for a valid split of two
    meetings = write_synthetic_ami(str(tmp_path / "ami"), 2, 40.0, seed=2)
    ids = tmp_path / "meetings.txt"
    ids.write_text("\n".join(meetings))
    seg = str(tmp_path / "seg")
    data_prep.main(["ami-segment", "--data_root", str(tmp_path / "ami"),
                    "--out_root", seg, "--ami_meeting_ids", str(ids)])
    for split, meets in (("train", meetings[:1]), ("test", meetings[1:])):
        (tmp_path / f"{split}.scp").write_text("\n".join(sorted(
            f for m in meets for f in glob.glob(f"{seg}/{m}/audio/*.wav"))))
    cfg = str(tmp_path / "ami.cfg")
    data_prep.main(["ami-cfg", "--data_root", seg, "--train_scp",
                    str(tmp_path / "train.scp"), "--test_scp",
                    str(tmp_path / "test.scp"), "--cfg_file", cfg])
    sdm = tmp_path / "sdm"
    for f in glob.glob(f"{seg}/*/audio/*.Headset-?-*.wav"):
        if ".Arr1-" not in f:
            dst = sdm / os.path.relpath(f, seg)
            dst.parent.mkdir(parents=True, exist_ok=True)
            os.link(f.replace(".wav", ".Arr1-01.wav"), dst)
    orig = Trainer.train_

    def two_steps(self, *a, **k):
        self.bpe = 2
        self.cfg["va_bpe"] = 1
        return orig(self, *a, **k)

    monkeypatch.setattr(Trainer, "train_", two_steps)
    fe, wk = _slice_cfgs(tmp_path)
    cuda_qrnn.reset_launches()
    tr = port_train.main(["--net_cfg", wk, "--fe_cfg", fe, "--data_root",
                          str(sdm), "--data_cfg", cfg, "--dtrans_cfg",
                          "None", "--dataset", "AmiSegTupleWavDataset",
                          "--clean_root", seg, "--batch_size", "4",
                          "--chunk_size", "4800", "--epoch", "1",
                          "--log_freq", "1", "--save_path",
                          str(tmp_path / "run")])
    torch.cuda.synchronize()
    layers = len(tr.model.frontend.rnn.layers)
    assert cuda_qrnn.LAUNCHES["qrnn_pool_fwd_train"] == 2 * layers
    assert cuda_qrnn.LAUNCHES["qrnn_pool_bwd"] == 2 * layers
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        recs = [json.loads(ln) for ln in f]
    assert all(np.isfinite(v) for r in recs for k, v in r.items()
               if k not in ("t", "split", "step"))
    assert (tmp_path / "run" / "FE_e0.npz").exists()


def test_profile_step_on_the_card(cuda_device, tmp_path, capsys):
    import json
    from pase_tpu_torch import util_scripts
    fe, wk = _slice_cfgs(tmp_path)
    cuda_qrnn.reset_launches()
    out = util_scripts.main(["profile-step", "--fe_cfg", fe, "--net_cfg",
                             wk, "--batch_size", "4", "--chunk_size",
                             "4800", "--n_meas", "3",
                             "--compute_dtype", "bfloat16"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out and set(line) == {
        "prepare_ms", "step_ms", "model_opt_ms", "steps_per_sec",
        "audio_sec_per_sec"}
    assert line["step_ms"] > line["prepare_ms"] > 0
    # 3 warm-up steps and 3 timed ones, one QRNN layer
    assert cuda_qrnn.LAUNCHES["qrnn_pool_fwd_train"] == 6


def test_export_torch_round_trip_on_the_card(cuda_device, tmp_path):
    """export-torch of a native artifact, loaded back with
    load_frontend_ckpt: the encoder's forward on the card equals the
    original's bit for bit."""
    from pase_tpu_torch import util_scripts
    from pase_tpu_torch.checkpoint import save_variables_npz
    enc = wf_builder(SLICE_FE, device="cuda", seed=3)
    npz = save_variables_npz(str(tmp_path / "FE_e0.npz"),
                             enc.module.state_dict())
    ckpt = str(tmp_path / "FE_e0.ckpt")
    util_scripts.main(["export-torch", "--in_ckpt", npz, "--out_ckpt",
                       ckpt])
    back = wf_builder(SLICE_FE, device="cuda", seed=7).load_pretrained(ckpt)
    x = np.random.RandomState(0).randn(4, 1, 16000).astype(np.float32)
    with torch.no_grad():
        assert torch.equal(back(x), enc(x))


def test_trainer_rows_gpu_match_cpu(cuda_device, tmp_path):
    """log_histograms and log_grad_norms on the card against the CPU from
    the same weights and targets: lo / hi within 1e-4 relative of the
    row's largest, counts equal but for values within 1e-5 (hi - lo) of
    an edge, grad norms within 1e-3 relative; fused_heads=False gives the
    fused step's losses within 1e-4."""
    from pase_tpu_torch import trainer as port_trainer
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    from pase_tpu_torch.data.pipeline import make_prepare_fn
    from pase_tpu_torch.model import parse_workers_cfg
    from pase_tpu_torch.trainer import Trainer
    wk = _small_workers()
    raw = next(iter(SyntheticChunkBatcher(2, 4800, seed=3)))
    with torch.no_grad():
        prep = make_prepare_fn(parse_workers_cfg(wk))(
            {k: torch.from_numpy(v) for k, v in raw.items()})
    raw.update({e["name"]: prep[e["name"]].numpy() for e in wk["regr"]
                if e["name"] != "cchunk"})
    out, seen = {}, {}
    orig = port_trainer.hist_row
    for fused in (True, False):
        for device in ("cpu", "cuda"):
            cfg = dict(batch_size=2, chunk_size=4800, fe_lr=5e-4,
                       min_lr=5e-4, lr_mode="poly",
                       save_path=str(tmp_path / f"{device}{fused}"),
                       log_histograms=True, log_grad_norms=True,
                       fused_heads=fused)
            tr = Trainer(SLICE_FE, wk, cfg, device=device)
            rec = seen.setdefault((device, fused), [])
            port_trainer.hist_row = (
                lambda x, bins=24, rec=rec: (rec.append(
                    x.detach().reshape(-1).double().cpu().numpy()),
                    orig(x, bins))[1])
            try:
                out[(device, fused)] = {k: v.cpu().numpy() for k, v in
                                        tr.train_step(raw).items()}
            finally:
                port_trainer.hist_row = orig
    for fused in (True, False):
        g, c = out[("cuda", fused)], out[("cpu", fused)]
        for k, want in c.items():
            got = g[k]
            if k.startswith("hist/"):
                lo, hi = want[0], want[1]
                scale = max(abs(lo), abs(hi))
                assert abs(got[:2] - want[:2]).max() <= 1e-4 * scale, k
                vals = seen[("cpu", fused)][
                    [n for n in c if n.startswith("hist/")].index(k)]
                edges = lo + (hi - lo + 1e-9) * np.arange(25) / 24
                near = int((np.abs(vals[:, None] - edges[None, 1:-1])
                            <= 1e-5 * (hi - lo)).any(axis=1).sum())
                assert np.abs(got[2:] - want[2:]).sum() <= 2 * near, k
            elif k.startswith("grad_norm/"):
                assert abs(float(got) - float(want)) <= 1e-3 * float(want), k
            else:
                assert abs(float(got) - float(want)) <= \
                    1e-4 * abs(float(want)), k
    for k in out[("cuda", True)]:
        if not k.startswith(("hist/", "grad_norm/")):
            a, b = float(out[("cuda", False)][k]), float(out[("cuda",
                                                              True)][k])
            assert abs(a - b) <= 1e-4 * abs(b), k


KALDI_HEADS = (("kaldimfcc", 39, {"num_ceps": 13, "der_order": 2}),
               ("kaldiplp", 20, {"num_ceps": 20, "der_order": 0}))


@pytest.mark.parametrize("name,n_out,transform", KALDI_HEADS)
def test_kaldi_targets_gpu_match_cpu(cuda_device, name, n_out, transform):
    """The Kaldi MFCC / PLP targets of speech-like chunks on the card
    within 1e-4 of each target's largest value on the CPU (cuFFT against
    pocketfft, sums in another order)."""
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    from pase_tpu_torch.ops.features import feature_fn_for_worker
    wav = torch.from_numpy(next(iter(SyntheticChunkBatcher(
        4, 16000, seed=5)))["chunk"])
    fn = feature_fn_for_worker(name, transform)
    cpu, gpu = fn(wav), fn(wav.to(cuda_device)).cpu()
    assert cpu.shape == gpu.shape == (4, 100, n_out)
    assert (gpu - cpu).abs().max() <= 1e-4 * cpu.abs().max()


def test_kaldi_head_step_gpu_matches_cpu(cuda_device, tmp_path):
    """One narrow PASE+ step with workers+ and both Kaldi heads on the card
    against the CPU, same weights and batch: the losses within 1e-4
    relative, the training kernels launched once per QRNN layer."""
    from pase_tpu_torch.data.dataset import SyntheticChunkBatcher
    from pase_tpu_torch.trainer import Trainer
    wk = _small_workers()
    mfcc = next(e for e in wk["regr"] if e["name"] == "mfcc")
    for name, n_out, transform in KALDI_HEADS:
        wk["regr"].append(dict(mfcc, name=name, num_outputs=n_out,
                               transform=dict(transform)))
    fe = dict(NARROW_CFG, strides=[1, 10, 4, 4])
    cfg = dict(batch_size=2, chunk_size=4800, fe_lr=5e-4, min_lr=5e-4,
               lr_mode="poly", save_path=str(tmp_path))
    gpu = Trainer(fe, wk, cfg, device=cuda_device)
    cpu = Trainer(fe, wk, cfg, device="cpu")
    cpu.model.load_state_dict(gpu.model.state_dict())
    raw = next(iter(SyntheticChunkBatcher(2, 4800, seed=3)))
    before = dict(cuda_qrnn.LAUNCHES)
    lg, lc = gpu.train_step(raw), cpu.train_step(raw)
    layers = len(gpu.model.frontend.rnn.layers)
    for k in ("qrnn_pool_fwd_train", "qrnn_pool_bwd"):
        assert cuda_qrnn.LAUNCHES[k] == before[k] + layers
    assert {"kaldimfcc", "kaldiplp"} <= set(gpu.ordered_names)
    for k in gpu.ordered_names:
        assert abs(float(lg[k]) - float(lc[k])) <= 1e-4 * abs(float(lc[k])), k


def test_kmeans_gpu_matches_cpu(cuda_device):
    """util_scripts.kmeans on the card against the CPU from the same
    initial rows: the same assignments, the centres within 1e-5 of their
    largest."""
    from pase_tpu_torch import util_scripts
    rng = np.random.RandomState(0)
    centers = rng.randn(16, 32) * 3
    x = np.concatenate([c + rng.randn(200, 32) for c in centers]).astype(
        np.float32)
    idx = util_scripts.kmeans_init(len(x), 16, seed=1)
    cg, ag = util_scripts.kmeans(torch.from_numpy(x).to(cuda_device), 16,
                                 init_idx=idx)
    cc, ac = util_scripts.kmeans(torch.from_numpy(x), 16, init_idx=idx)
    np.testing.assert_array_equal(ag, ac)
    assert np.abs(cg - cc).max() <= 1e-5 * np.abs(cc).max()


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_batchnorm_one_rank_nccl(cuda_device, dtype):
    """The data-parallel BatchNorm function (nn._GlobalBatchNorm) under a
    process group of one NCCL rank: the output, the gradients and the
    running stats of the single-process layer (float32: torch's layer, to
    1e-5 of the largest; bf16: the one-pass float32 statistics, to bf16's
    rounding), and the NCCL all_reduce on the card runs."""
    import torch.distributed as dist
    from pase_tpu_torch.nn import BatchNorm1d, _GlobalBatchNorm
    from pase_tpu_torch.parallel import mesh
    assert mesh.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                 device=cuda_device)
    try:
        assert dist.get_backend() == "nccl"
        rng = np.random.RandomState(0)
        dt = getattr(torch, dtype)
        x = torch.from_numpy((rng.randn(6, 16, 300) * 2 + 1).astype(
            np.float32)).to(cuda_device, dt)
        dy = torch.from_numpy(rng.randn(6, 16, 300).astype(np.float32)).to(
            cuda_device)
        ref = BatchNorm1d(16).to(cuda_device)
        with torch.no_grad():
            ref.weight.uniform_(0.5, 1.5)
            ref.bias.normal_()
        xr = x.clone().requires_grad_()
        yr = ref.train()(xr)
        yr.float().backward(dy)
        bn = BatchNorm1d(16).to(cuda_device)
        bn.load_state_dict({k: v for k, v in ref.state_dict().items()
                            if "running" not in k and "tracked" not in k},
                           strict=False)
        xg = x.clone().requires_grad_()
        yg, mean, var = _GlobalBatchNorm.apply(xg, bn.weight, bn.bias,
                                               bn.eps)
        yg.float().backward(dy)
        tol = 1e-5 if dtype == "float32" else 2.0 ** -7
        for got, want in ((yg, yr), (xg.grad, xr.grad),
                          (bn.weight.grad, ref.weight.grad),
                          (bn.bias.grad, ref.bias.grad)):
            err = ((got.float() - want.float()).abs().max()
                   / want.float().abs().max()).item()
            assert err <= tol, err
        n = 6 * 300
        torch.testing.assert_close(
            ref.running_mean, 0.1 * mean, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(
            ref.running_var, 0.9 + 0.1 * var * n / (n - 1), rtol=1e-5,
            atol=1e-6)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("layers", [1, 2])
def test_time_shard_matches_offline_on_the_card(cuda_device, layers):
    """encode_time_sharded over [cuda:0] * 4 (the QRNN carry through K1's
    few-lane and seeded kernels) against the offline forward on the card
    (atol = rtol = 2e-5, JAX's bound), and its gradient (K2 with dc0)
    against the offline gradient (atol 1e-5, rtol 1e-4)."""
    from pase_tpu_torch import frontend
    from pase_tpu_torch.parallel import sp
    cfg = dict(NARROW_CFG, strides=[1, 10, 4, 4], rnn_layers=layers)
    m = frontend.build_wavefe(cfg).to(cuda_device).eval()
    rng = np.random.RandomState(1)
    wav = torch.from_numpy((rng.randn(2, 32000) * 0.2).astype(
        np.float32)).to(cuda_device)
    devices = [cuda_device] * 4
    before = dict(cuda_qrnn.LAUNCHES)
    got = sp.encode_time_sharded(m, wav, devices)
    launched = {k: cuda_qrnn.LAUNCHES[k] - before[k] for k in before}
    # pass 1 on the shards but the last, pass 2 on every shard
    assert launched["qrnn_pool_fwd_few"] == 3 * layers, launched
    assert launched["qrnn_pool_fwd_seg"] == 4 * layers, launched
    with torch.no_grad():
        want = m(wav)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    w = torch.from_numpy(rng.randn(*want.shape).astype(np.float32)).to(
        cuda_device)
    params = list(m.parameters())
    g_sp = torch.autograd.grad(
        (sp.time_sharded_apply(m, wav, devices) * w).mean(), params,
        allow_unused=True)
    g_off = torch.autograd.grad((m(wav) * w).mean(), params,
                                allow_unused=True)
    for a, b in zip(g_sp, g_off):
        if b is not None:
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


def test_host_stage_cli_on_the_card(cuda_device, tmp_path):
    """The training CLI on the card from a seeded corpus with a
    --dtrans_cfg of codec2_p 0.5 / whisper_p 0.1: the host stage (the
    vocoder built from csrc/codec2_lite.cc) on the feed's numpy batches,
    two steps, the training kernels once per QRNN layer per step, every
    loss finite, the 'host_stage' line."""
    import json
    from pase_tpu_torch import train as port_train
    from pase_tpu_torch.data.synthetic_corpus import write_synthetic_corpus
    root, cfg = write_synthetic_corpus(str(tmp_path / "corpus"), 1.2, 0.5,
                                       seed=7, utts_per_chapter=3,
                                       min_seconds=0.1, max_seconds=0.6)
    fe, wk = _slice_cfgs(tmp_path)
    dist = tmp_path / "dist.cfg"
    dist.write_text(json.dumps({"codec2_p": 0.5, "whisper_p": 0.1}))
    cuda_qrnn.reset_launches()
    tr = port_train.main(["--net_cfg", wk, "--fe_cfg", fe, "--data_root",
                          root, "--data_cfg", cfg, "--dtrans_cfg",
                          str(dist), "--batch_size", "2", "--chunk_size",
                          "4800", "--epoch", "1", "--log_freq", "1",
                          "--save_path", str(tmp_path / "run")])
    torch.cuda.synchronize()
    layers = len(tr.model.frontend.rnn.layers)
    assert cuda_qrnn.LAUNCHES["qrnn_pool_fwd_train"] == tr.bpe * layers
    assert cuda_qrnn.LAUNCHES["qrnn_pool_bwd"] == tr.bpe * layers
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        recs = [json.loads(ln) for ln in f]
    assert all(np.isfinite(v) for r in recs for k, v in r.items()
               if isinstance(v, float))
    assert recs[-1]["split"] == "host_stage"
    assert recs[-1]["rows"] == 2 * tr.bpe


def test_decoders_gpu_match_cpu(cuda_device):
    """SpectrogramDecoder (an upsampling stage, bnorm, eval) and the
    SpectrumLM rollout (2 x LSTM, 30 steps, a forced frame) on the card
    against the CPU with the same weights and state: within 1e-4 of the
    largest output."""
    from pase_tpu_torch import decoders
    gen = torch.Generator().manual_seed(0)
    dec = decoders.SpectrogramDecoder(32, nfft=64, strides=(1, 2),
                                      kwidths=(3, 4), fmaps=(24, 16),
                                      norm_type="bnorm", generator=gen).eval()
    x = torch.randn(3, 50, 32, generator=gen)
    with torch.no_grad():
        want = dec(x)
        got = dec.to(cuda_device)(x.to(cuda_device)).cpu()
    assert got.shape == (3, 100, 33)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-4
    lm = decoders.SpectrumLM(64, 2, 33, generator=gen).eval()
    seed = torch.randn(3, 33, generator=gen)
    state = lm.init_state(3, gen)
    cps = {7: torch.randn(3, 33, generator=gen)}
    with torch.no_grad():
        want, _ = lm(seed, 30, state=state, dec_cps=cps)
        got, _ = lm.to(cuda_device)(
            seed.to(cuda_device), 30,
            state=tuple(tuple(t.to(cuda_device) for t in s) for s in state),
            dec_cps={k: v.to(cuda_device) for k, v in cps.items()})
    assert ((got.cpu() - want).abs().max() / want.abs().max()).item() <= 1e-4


def test_dropout_masks_on_the_card(cuda_device):
    """nn.dropout with a generator on the card: the same seed the same
    mask bit for bit, the keep share within 5 binomial sd of 1 - p; the
    QRNN's dropout between its layers draws from its generator there."""
    from pase_tpu_torch.nn import QRNN, dropout
    x = torch.rand(64, 50, 40, device=cuda_device) + 0.5
    gen = torch.Generator(device=cuda_device)
    a = dropout(x, 0.3, gen.manual_seed(4))
    b = dropout(x, 0.3, gen.manual_seed(4))
    assert torch.equal(a, b)
    n = x.numel()
    kept = int((a != 0).sum())
    assert abs(kept - 0.7 * n) <= 5 * (n * 0.21) ** 0.5
    q = QRNN(6, 8, layers=2, dropout=0.5).to(cuda_device).train()
    q.dropout_generator = gen
    y = torch.randn(4, 30, 6, device=cuda_device)
    with torch.no_grad():
        gen.manual_seed(1)
        r = q(y)
        gen.manual_seed(1)
        s = q(y)
        gen.manual_seed(2)
        t = q(y)
    assert torch.equal(r, s) and not torch.equal(r, t)


@pytest.mark.parametrize("shape", [(96, 200, 256), (48, 200, 256)])
def test_lane_shard_kernels_match_plain(cuda_device, shape):
    """The QRNN's lane shards under --n_model (PASE+ at 32 x 2 s on a 1 x 2
    and a 2 x 2 grid): K2 (fwd_train + bwd through QRNNPool) against the
    plain version's autograd and K1's eval kernel (a rank's eval route)
    against the plain forward, each launched once."""
    y, _ = _inputs(*shape, cuda_device, seed=21)
    dh = torch.from_numpy(np.random.RandomState(22).randn(*shape).astype(
        np.float32)).to(cuda_device)
    before = dict(cuda_qrnn.LAUNCHES)
    grads = []
    for fn in (cuda_qrnn.qrnn_pool, plain.qrnn_pool):
        yg = y.clone().requires_grad_()
        h, _ = fn(yg)
        grads.append((h.detach(), torch.autograd.grad(
            torch.sum(h * dh), [yg])[0]))
    assert cuda_qrnn.forward_entry(shape[0] * shape[2], False,
                                   shape[1]) == "qrnn_pool_fwd_eval"
    h_eval, _ = cuda_qrnn.qrnn_pool_fwd(y)
    torch.cuda.synchronize()
    (h, dy), (h_ref, dy_ref) = grads
    assert (h - h_ref).abs().max().item() <= 1e-5
    assert (h_eval - h_ref).abs().max().item() <= 1e-5
    assert (dy - dy_ref).abs().max().item() <= \
        1e-5 * max(1.0, dy_ref.abs().max().item())
    after = cuda_qrnn.LAUNCHES
    for k, n in (("qrnn_pool_fwd_train", 1), ("qrnn_pool_bwd", 1),
                 ("qrnn_pool_fwd_eval", 1), ("qrnn_pool_fwd", 0)):
        assert after[k] == before[k] + n, k


TP_FE = {"kwidths": [65, 10, 5, 5], "strides": [1, 10, 4, 4],
         "fmaps": [64, 64, 128, 128], "emb_dim": 128, "norm_out": True,
         "rnn_pool": True, "rnn_dim": 128, "denseskips": True}
TP_WORKERS = {"regr": [{"num_outputs": 39, "dropout": 0,
                        "hidden_size": 128, "hidden_layers": 1,
                        "name": "mfcc", "r": 1, "loss": "MSELoss",
                        "skip": False}],
              "cls": [{"num_outputs": 1, "dropout": 0, "hidden_size": 128,
                       "hidden_layers": 1, "name": "mi",
                       "loss": "BCEWithLogitsLoss", "skip": False}]}


def test_tensor_parallel_step_on_the_card(cuda_device, tmp_path):
    """Two gloo ranks sharing the card as a 1 x 2 grid (--n_model 2: the
    column shards of parallel/tp.py, the QRNN by lanes, K2 on each) against
    one process on the card: per-worker losses within 1e-4 relative (step
    2: 1e-3), the ranks' losses bit for bit, the gathered gradients within
    1e-3 of each group's largest."""
    from torch_port_ranks import run_ranks, train_steps
    rng = np.random.RandomState(5)
    batches = [{k: rng.randn(4, 8000).astype(np.float32) * 0.1
                for k in ("chunk", "chunk_ctxt", "chunk_rand")}
               for _ in range(2)]

    def cfg(n_model, path):
        return dict(backprop_mode="base", hop=160, bpe=100, epoch=10,
                    batch_size=4, chunk_size=8000, fe_lr=5e-4, min_lr=5e-4,
                    lr_mode="poly", n_model=n_model, save_path=str(path))

    kw = dict(fe_cfg=TP_FE, wk_cfg=TP_WORKERS, variables=None,
              batches=batches, device="cuda")
    one = train_steps(0, 1, cfg=cfg(1, tmp_path / "one"), **kw)
    outs = run_ranks(tmp_path, "train_steps",
                     dict(kw, cfg=cfg(2, tmp_path / "tp")), world=2)
    assert outs[0]["routes"]["frontend.rnn"] == "lanes"
    for a, b in zip(outs[0]["losses"], outs[1]["losses"]):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    for step, rel in ((0, 1e-4), (1, 1e-3)):
        for k, v in one["losses"][step].items():
            got = outs[0]["losses"][step][k]
            assert abs(got - v) <= rel * abs(v), (step, k, got, v)
    groups = {}
    for k, g in one["grads"].items():
        top = k.split("/")[1]
        err = np.abs(outs[0]["grads"][k] - g).max()
        groups.setdefault(top, [0.0, 0.0])
        groups[top][0] = max(groups[top][0], err)
        groups[top][1] = max(groups[top][1], np.abs(g).max())
    for top, (err, big) in groups.items():
        assert err <= 1e-3 * big, (top, err, big)


# ---------------------------------------------------------------------------
# the training CLI as processes of their own (the rehearsal's setting)
# ---------------------------------------------------------------------------


REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the training CLI under torch's deterministic algorithms (cuBLAS's
# workspace fixed by CUBLAS_WORKSPACE_CONFIG), as a `python -m` run of it;
# torch warns once for each op it has no deterministic implementation of
DETERMINISTIC_TRAIN = (
    "import runpy, sys, torch\n"
    "torch.use_deterministic_algorithms(True, warn_only=True)\n"
    "sys.argv = ['pase_tpu_torch.train'] + sys.argv[1:]\n"
    "runpy.run_module('pase_tpu_torch.train', run_name='__main__')\n")
# the ops of the rehearsal's step that torch has no deterministic
# implementation of (the card's torch 2.11): their atomics gave the same
# bits in every run on the card so far
NONDETERMINISTIC_OPS = {"reflection_pad1d_backward_out_cuda"}


def _child_env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, **extra)
    env.pop("PYTEST_CURRENT_TEST", None)
    return env


def test_train_cli_process_turns_tf32_off(cuda_device, tmp_path):
    """A fresh process of the training CLI (its ``main``, two --synthetic
    steps on the card): cuDNN's TF32 default is on there (torch's
    default), and after the CLI's setup both TF32 flags are off."""
    import json
    import subprocess
    import sys
    fe, wk = _slice_cfgs(tmp_path)
    code = (
        "import json, sys, torch\n"
        "b = torch.backends\n"
        "before = [b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32]\n"
        "from pase_tpu_torch import train\n"
        "train.SYNTHETIC_BPE = 2\n"
        "train.main(sys.argv[1:])\n"
        "print(json.dumps({'before': before, 'after': "
        "[b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32]}))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, "--synthetic", "--device", "cuda",
         "--fe_cfg", fe, "--net_cfg", wk, "--batch_size", "2",
         "--chunk_size", "4800", "--epoch", "1", "--save_path",
         str(tmp_path / "run")], cwd=REPO_ROOT, env=_child_env(),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    flags = json.loads(proc.stdout.strip().splitlines()[-1])
    assert flags["before"][1] is True          # cuDNN's default: TF32
    assert flags["after"] == [False, False]


def test_train_cli_kill_and_resume_across_processes(cuda_device, tmp_path):
    """The rehearsal's preemption at a narrow cfg: run A trains 3 epochs
    from a device corpus with the distortion stack; run B, the same
    command, is killed (SIGKILL) once a step of epoch 2 is logged and
    resumed in a new process. Under deterministic algorithms (each process
    sets them, with CUBLAS_WORKSPACE_CONFIG) B's FE_e2.npz is A's bit for
    bit, and the ops torch warns it has no deterministic implementation
    of are NONDETERMINISTIC_OPS; without them two uninterrupted runs on
    the card already differ (chip_smoke.py phase 28)."""
    import json
    import re
    import subprocess
    import sys
    import time
    from pase_tpu_torch import make_bench_corpus
    corpus = tmp_path / "corpus"
    make_bench_corpus.main(["--out_root", str(corpus), "--hours", "0.0223",
                            "--seg_s", "1"])
    fe, wk = _slice_cfgs(tmp_path)
    argv = ["--data_root", str(corpus / "wavs"), "--data_cfg",
            str(corpus / "data.cfg"), "--dtrans_cfg", str(corpus / "dist.cfg"),
            "--fe_cfg", fe, "--net_cfg", wk, "--device_corpus",
            "--batch_size", "4", "--chunk_size", "4800", "--epoch", "3",
            "--seed", "42", "--log_freq", "1", "--device", "cuda"]
    env = _child_env(CUBLAS_WORKSPACE_CONFIG=":4096:8")

    def start(run):
        return subprocess.Popen(
            [sys.executable, "-c", DETERMINISTIC_TRAIN] + argv
            + ["--save_path", str(tmp_path / run)], cwd=REPO_ROOT, env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)

    warned = set()

    def finish(proc):
        err = proc.communicate(timeout=600)[1]
        assert proc.returncode == 0, err[-3000:]
        warned.update(re.findall(r"(\w+) does not have a deterministic "
                                 r"implementation", err))

    def rows(run):
        path = tmp_path / run / "metrics.jsonl"
        if not path.exists():
            return []
        with open(path) as f:
            return [json.loads(ln) for ln in f if ln.endswith("\n")]

    finish(start("runA"))
    bpe = next(r["step"] for r in rows("runA") if r["split"] == "perf")
    b = start("runB")
    deadline = time.time() + 600
    while not any(r["split"] == "train" and r["step"] > 2 * bpe
                  for r in rows("runB")):
        assert b.poll() is None, b.communicate()[1][-3000:]
        assert time.time() < deadline
        time.sleep(0.02)
    b.kill()
    b.communicate()
    assert not (tmp_path / "runB" / "FE_e2.npz").exists(), "killed late"
    killed = max(r["step"] for r in rows("runB") if r["split"] == "train")
    finish(start("runB"))
    steps = [r["step"] for r in rows("runB") if r["split"] == "train"]
    assert steps.count(2 * bpe + 1) == 2 and steps[-1] == 3 * bpe
    assert 2 * bpe < killed <= 3 * bpe
    a = np.load(tmp_path / "runA" / "FE_e2.npz")
    got = np.load(tmp_path / "runB" / "FE_e2.npz")
    assert sorted(a.files) == sorted(got.files)
    for k in a.files:
        assert np.array_equal(a[k], got[k]), k
    assert warned <= NONDETERMINISTIC_OPS, warned
