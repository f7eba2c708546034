"""The port's QRNN pooling (pase_tpu_torch.ops) against the JAX package:
the plain torch version vs the Pallas kernel in interpret mode and vs the
associative scan, on the same numpy inputs; the plain backward (through
the ``QRNNPool`` autograd Function) vs ``jax.grad`` of the Pallas kernel's
custom VJP; and the CUDA wrapper's CPU path. The kernels themselves are
tested on the card by tests/test_torch_cuda.py.

Tolerance: atol 2e-5, as tests/test_qrnn.py holds the Pallas kernel to the
scan (float32 recurrences summed in different orders).

Every interpret-mode reference runs as one jitted call (``_interpret``):
run op by op, an eager dispatch of the main thread can wait on the CPU
device while the interpreted kernel's io_callbacks of the call before it
wait on the main thread, a hang seen under a loaded 6-worker run."""

import functools

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
from torch_port_common import port_test_guard  # noqa: F401

ATOL = 2e-5
# (B, T, H): B and T off the Pallas kernel's 8 x 128 tiling, T over one
# 128-step time block
SHAPES = [(3, 200, 16), (9, 131, 8), (1, 7, 24)]


def _interpret(fn, *args):
    """fn(*args) of the JAX package in TPU interpret mode, traced and run
    as one jitted call, its result on the host."""
    with pltpu.force_tpu_interpret_mode():
        return jax.device_get(jax.jit(fn)(*args))


def _pallas_pool(y, c0=None):
    """qrnn_pool_pallas(y, c0) of numpy inputs (``_interpret``)."""
    return _interpret(jax_pallas.qrnn_pool_pallas, jnp.asarray(y),
                      None if c0 is None else jnp.asarray(c0))


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
    h_ref, c_ref = _pallas_pool(y, c0)
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
    p1, pc1 = _pallas_pool(y[:, :12], c0)
    p2, _ = _pallas_pool(y[:, 12:], pc1)
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

    if c0 is None:
        return _interpret(jax.grad(lambda y_: loss(y_, None)),
                          jnp.asarray(y)), None
    return _interpret(jax.grad(loss, argnums=(0, 1)), jnp.asarray(y),
                      jnp.asarray(c0))


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


# (lanes the tile is chosen for, T): the few-lane kernel's mid tile (8
# lanes, 16 warps of 4 chunks of at most 8) and its wide one (8 lanes, 16
# warps of 4 chunks of at most 4): one step; T under one chunk; several
# segments, the last ragged
CHUNKED = [(1024, 1), (1024, 5), (1024, 517), (4096, 1), (4096, 17),
           (4096, 600)]


@pytest.mark.parametrize("lanes,t", CHUNKED, ids=lambda v: str(v))
@pytest.mark.parametrize("seeded", [False, True])
def test_chunked_plain_matches_serial_and_pallas(lanes, t, seeded):
    """The few-lane kernel's algebra at the tile it takes on ``lanes``
    lanes (chunk maps, each warp's 4 chunks scanned as its shuffles scan
    them, the carry put through the warps' maps in order, chunks re-run
    from their carry) against the serial plain version and the Pallas
    kernel in interpret mode, within 1e-6, on 3 x 8 lanes."""
    y, c0 = _inputs(3, t, 8, seed=t + lanes)
    c0 = c0 if seeded else None
    c0t = None if c0 is None else torch.from_numpy(c0)
    _, per, warps, chunk = torch_qrnn.few_tile(lanes, t)
    h, _, c = torch_qrnn.qrnn_pool_fwd_train_chunked_plain(
        torch.from_numpy(y), c0t, chunk=chunk, chunks=per * warps,
        warp_chunks=per)
    h_ser, c_ser = torch_qrnn.qrnn_pool(torch.from_numpy(y), c0t)
    h_ref, c_ref = _pallas_pool(y, c0)
    assert h.shape == (3, t, 8) and c.shape == (3, 8)
    for got, want in ((h, h_ser), (c, c_ser), (h, np.asarray(h_ref)),
                      (c, np.asarray(c_ref))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# the training pair's chunking (T, chunk, chunks): one step; T under one
# chunk; T one past whole chunks (a second segment of one step); several
# segments, the last ragged; the main path's T = 200 (4 segments of 8 x 7)
TRAIN_CHUNKED = [(1, 1, 8), (5, 7, 8), (15, 7, 2), (37, 4, 2), (200, 7, 8)]


def _train_chunked(y, c0, wh, wc, chunk, chunks):
    """The chunked plain training pair on numpy inputs: (h, c_T) of the
    forward, (dy, dc0) of the backward with dh = wh and dc_T = wc (None:
    no c_T gradient)."""
    yt = torch.from_numpy(y)
    c0t = None if c0 is None else torch.from_numpy(c0)
    h, c, c_last = torch_qrnn.qrnn_pool_fwd_train_chunked_plain(
        yt, c0t, chunk=chunk, chunks=chunks)
    dy, dc0 = torch_qrnn.qrnn_pool_bwd_chunked_plain(
        yt, c, torch.from_numpy(wh), None if wc is None else
        torch.from_numpy(wc), c0t, chunk=chunk, chunks=chunks)
    return h, c, c_last, dy, dc0


def _train_case(t, seeded, dct):
    y, c0 = _inputs(3, t, 8, seed=t + 2 * seeded + dct)
    rng = np.random.RandomState(t + 5)
    wh = rng.randn(3, t, 8).astype(np.float32)
    wc = rng.randn(3, 8).astype(np.float32) if dct else None
    return y, (c0 if seeded else None), wh, wc


@pytest.mark.parametrize("t,chunk,chunks", TRAIN_CHUNKED, ids=str)
@pytest.mark.parametrize("seeded,dct", [(False, True), (True, False)])
def test_train_chunked_plain_matches_jax_grad(t, chunk, chunks, seeded, dct):
    """The chunked training pair's algebra (the kernels' chunk maps,
    carries put through them one after the other, chunks re-run; the
    backward's carry a_t g_t) against the Pallas kernel's forward and
    jax.grad of its custom VJP in interpret mode, at the file's tolerance
    (unseeded with a c_T gradient, seeded without one; the serial test
    below takes all four)."""
    y, c0, wh, wc = _train_case(t, seeded, dct)
    h, _, c_last, dy, dc0 = _train_chunked(y, c0, wh, wc, chunk, chunks)
    h_ref, c_ref = _pallas_pool(y, c0)
    gy_ref, gc_ref = _jax_pool_grads(
        y, c0, wh, np.zeros((3, 8), np.float32) if wc is None else wc)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=ATOL)
    np.testing.assert_allclose(c_last.numpy(), np.asarray(c_ref), atol=ATOL)
    np.testing.assert_allclose(dy.numpy(), np.asarray(gy_ref), atol=ATOL)
    if seeded:
        np.testing.assert_allclose(dc0.numpy(), np.asarray(gc_ref),
                                   atol=ATOL)
    else:
        assert dc0 is None


@pytest.mark.parametrize("t,chunk,chunks", TRAIN_CHUNKED, ids=str)
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("dct", [False, True])
def test_train_chunked_plain_matches_serial(t, chunk, chunks, seeded, dct):
    """The chunked training pair against the serial plain versions (the
    CPU main path's ``qrnn_pool_fwd_train`` / ``qrnn_pool_bwd``): every
    output, c included, at the file's tolerance."""
    y, c0, wh, wc = _train_case(t, seeded, dct)
    h, c, c_last, dy, dc0 = _train_chunked(y, c0, wh, wc, chunk, chunks)
    yt = torch.from_numpy(y)
    c0t = None if c0 is None else torch.from_numpy(c0)
    h_ser, c_ser = torch_qrnn.qrnn_pool_fwd_train(yt, c0t)
    dy_ser, dc0_ser = torch_qrnn.qrnn_pool_bwd(
        yt, c_ser, torch.from_numpy(wh),
        None if wc is None else torch.from_numpy(wc), c0t)
    for got, want in ((h, h_ser), (c, c_ser), (c_last, c_ser[:, -1]),
                      (dy, dy_ser)) + (((dc0, dc0_ser),) if seeded else ()):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


@pytest.mark.parametrize("t,len_fwd,len_bwd", [
    (1, 1, 1), (5, 1, 1), (21, 3, 3), (63, 8, 4), (64, 8, 4), (65, 5, 3),
    (200, 7, 4), (1001, 8, 4)])
def test_train_chunking_covers_t_in_the_fewest_segments(t, len_fwd,
                                                        len_bwd):
    """The training pair's chunk length: the fewest segments of 8 chunks
    of at most 8 steps (forward) or 4 (backward) that cover T, then the
    shortest chunk that covers T in as many; the chunked plain versions
    default to it."""
    chunks = torch_qrnn.TRAIN_CHUNKS
    for got, most in ((len_fwd, torch_qrnn.FWD_CHUNK),
                      (len_bwd, torch_qrnn.BWD_CHUNK)):
        assert torch_qrnn.train_chunk_len(t, chunks, most) == got
        assert -(-t // (chunks * got)) == -(-t // (chunks * most))
    assert torch_qrnn.train_chunk_len(t) == len_fwd
    y, c0 = _inputs(2, t, 4, seed=t)
    yt, c0t = torch.from_numpy(y), torch.from_numpy(c0)
    fwd = torch_qrnn.qrnn_pool_fwd_train_chunked_plain(yt, c0t)
    assert all(torch.equal(u, v) for u, v in zip(
        fwd, torch_qrnn.qrnn_pool_fwd_train_chunked_plain(
            yt, c0t, chunk=len_fwd)))
    dh = torch.ones_like(fwd[0])
    bwd = torch_qrnn.qrnn_pool_bwd_chunked_plain(yt, fwd[1], dh, None, c0t)
    assert all(torch.equal(u, v) for u, v in zip(
        bwd, torch_qrnn.qrnn_pool_bwd_chunked_plain(
            yt, fwd[1], dh, None, c0t, chunk=len_bwd)))


# the eval kernel's algebra (the training forward's, without c) at the
# chunkings (T, chunk, chunks) of CHUNKED and TRAIN_CHUNKED and its own
# (eval_chunk_len): one step; T under one chunk; T one past whole chunks;
# several segments, the last ragged; the main path's T = 200 (5 segments
# of 8 x 5, and 4 of 8 x 7), on 3 x 11 lanes (not a multiple of 32)
EVAL_CHUNKED = [(1, 1, 8), (1, 8, 64), (5, 8, 64), (5, 7, 8), (17, 8, 64),
                (17, 3, 8), (37, 4, 2), (37, 5, 8), (200, 5, 8),
                (200, 7, 8)]


@functools.lru_cache(maxsize=None)
def _eval_case(t, seeded):
    """Inputs of an eval-chunking case and the Pallas kernel's (h, c_T)
    on them in interpret mode, once per (T, seeded)."""
    y, c0 = _inputs(3, t, 11, seed=t + 7 * seeded)
    c0 = c0 if seeded else None
    return y, c0, _pallas_pool(y, c0)


@pytest.mark.parametrize("t,chunk,chunks", EVAL_CHUNKED, ids=str)
@pytest.mark.parametrize("seeded", [False, True])
def test_eval_chunked_plain_matches_serial_and_pallas(t, chunk, chunks,
                                                      seeded):
    """qrnn_pool_fwd_eval's algebra (qrnn_pool_fwd_train_chunked_plain's h
    and c_T: chunk maps, the carry put through them one after the other,
    chunks re-run) against the Pallas kernel in interpret mode and the
    serial plain version, within 1e-6."""
    y, c0, (h_ref, c_ref) = _eval_case(t, seeded)
    c0t = None if c0 is None else torch.from_numpy(c0)
    h, _, c = torch_qrnn.qrnn_pool_fwd_train_chunked_plain(
        torch.from_numpy(y), c0t, chunk=chunk, chunks=chunks)
    h_ser, c_ser = torch_qrnn.qrnn_pool(torch.from_numpy(y), c0t)
    assert h.shape == (3, t, 11) and c.shape == (3, 11)
    for got, want in ((h, h_ser), (c, c_ser), (h, np.asarray(h_ref)),
                      (c, np.asarray(c_ref))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("t,chunk", [(1, 1), (17, 3), (21, 3), (40, 5),
                                     (41, 3), (200, 5), (1000, 5)])
def test_eval_chunk_len_covers_t_in_the_fewest_segments(t, chunk):
    """The eval kernel's chunk length: the fewest segments of EVAL_CHUNKS
    chunks of at most EVAL_CHUNK steps that cover T, then the shortest
    chunk that covers T in as many; its CPU wrapper takes the chunked plain
    version there."""
    assert torch_qrnn.eval_chunk_len(t) == chunk
    per = torch_qrnn.EVAL_CHUNKS * chunk
    assert -(-t // per) == -(-t // (torch_qrnn.EVAL_CHUNKS
                                    * torch_qrnn.EVAL_CHUNK))
    y, c0 = _inputs(2, t, 4, seed=t)
    h, _, c = torch_qrnn.qrnn_pool_fwd_train_chunked_plain(
        torch.from_numpy(y), torch.from_numpy(c0), chunk=chunk,
        chunks=torch_qrnn.EVAL_CHUNKS)
    hk, ck = cuda_qrnn.qrnn_pool_fwd_eval(torch.from_numpy(y),
                                          torch.from_numpy(c0))
    assert torch.equal(hk, h) and torch.equal(ck, c)


def test_eval_chunking_constants_are_the_kernels():
    """ops/qrnn.py's EVAL_CHUNKS and EVAL_CHUNK are the shipped eval
    kernel's kEvalThreads / kEvalLanes and kEvalChunk, and
    kernel_variants's EVAL_SHIPPED is its tile."""
    import re
    from pase_tpu_torch import kernel_variants
    with open(cuda_qrnn.SOURCE) as f:
        text = f.read()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}
    assert const["kEvalThreads"] // const["kEvalLanes"] == \
        torch_qrnn.EVAL_CHUNKS
    assert const["kEvalChunk"] == torch_qrnn.EVAL_CHUNK
    assert kernel_variants.EVAL_SHIPPED == tuple(
        const[k] for k in ("kEvalLanes", "kEvalThreads", "kEvalChunk",
                           "kEvalBlocks", "kEvalDepth"))


def test_eval_wrapper_cpu_path_launches_nothing():
    """qrnn_pool_fwd_eval on CPU tensors takes the chunked plain version at
    the eval kernel's chunking, seeded and unseeded, and launches
    nothing."""
    y, c0 = _inputs(2, 21, 8, seed=12)
    before = dict(cuda_qrnn.LAUNCHES)
    for seed in (None, torch.from_numpy(c0)):
        h, c = cuda_qrnn.qrnn_pool_fwd_eval(torch.from_numpy(y), seed)
        hp, _, cp = torch_qrnn.qrnn_pool_fwd_train_chunked_plain(
            torch.from_numpy(y), seed, chunk=torch_qrnn.eval_chunk_len(21),
            chunks=torch_qrnn.EVAL_CHUNKS)
        assert torch.equal(h, hp) and torch.equal(c, cp)
    assert cuda_qrnn.LAUNCHES == before


@functools.lru_cache(maxsize=None)
def _few_case(b, t, seeded):
    """Inputs of a few-lane case (B rows of 5 lanes) and the Pallas
    kernel's (h, c_T) on them in interpret mode, once per (B, T,
    seeded)."""
    y, c0 = _inputs(b, t, 5, seed=3 * t + b + 11 * seeded)
    c0 = c0 if seeded else None
    return y, c0, _pallas_pool(y, c0)


@pytest.mark.parametrize("t", [1, 7, 200, 201, 1000])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("seeded", [False, True])
def test_few_plain_matches_serial_and_pallas(t, b, seeded):
    """qrnn_pool_fwd_few's algebra at its narrow tile (chunk maps, each
    warp's 8 chunks scanned as its shuffles scan them, the carry put
    through the warps' maps in order, chunks re-run) against the Pallas
    kernel in interpret mode and the serial plain version, within 1e-6:
    one step, a ragged chunk, B = 1 extraction's 200 steps (one segment of
    128 chunks of 2), one past it, forward-chunk's 1000 (2 segments of 128
    x 4)."""
    y, c0, (h_ref, c_ref) = _few_case(b, t, seeded)
    c0t = None if c0 is None else torch.from_numpy(c0)
    h, c = torch_qrnn.qrnn_pool_few_plain(torch.from_numpy(y), c0t)
    h_ser, c_ser = torch_qrnn.qrnn_pool(torch.from_numpy(y), c0t)
    assert h.shape == (b, t, 5) and c.shape == (b, 5)
    for got, want in ((h, h_ser), (c, c_ser), (h, np.asarray(h_ref)),
                      (c, np.asarray(c_ref))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# the warp scan at other tiles (T, chunk, chunks a segment, chunks a
# warp): 2, 4, 8 and 32 chunks a warp (16, 8, 4 and 1 lanes a block), one
# and several segments, ragged
WARP_CHUNKED = [(37, 3, 4, 2), (37, 2, 8, 4), (200, 2, 128, 4),
                (61, 1, 16, 8), (100, 2, 32, 32), (5, 7, 8, 4)]


@pytest.mark.parametrize("t,chunk,chunks,per_warp", WARP_CHUNKED, ids=str)
def test_warp_chunked_plain_matches_serial(t, chunk, chunks, per_warp):
    """The warp-scanned composition (``warp_chunks``) at other tiles
    against the serial plain version, seeded, within 1e-6; with one chunk
    a warp it is the serial fold's algebra bit for bit."""
    y, c0 = _inputs(2, t, 6, seed=t + per_warp)
    yt, c0t = torch.from_numpy(y), torch.from_numpy(c0)
    h, _, c = torch_qrnn.qrnn_pool_fwd_train_chunked_plain(
        yt, c0t, chunk=chunk, chunks=chunks, warp_chunks=per_warp)
    h_ser, c_ser = torch_qrnn.qrnn_pool(yt, c0t)
    np.testing.assert_allclose(h.numpy(), h_ser.numpy(), atol=1e-6)
    np.testing.assert_allclose(c.numpy(), c_ser.numpy(), atol=1e-6)
    rng = np.random.RandomState(t)
    ma, mb = (torch.from_numpy(rng.rand(2, chunks, 6).astype(np.float32))
              for _ in range(2))
    cin, c = [], c0t
    for k in range(chunks):
        cin.append(c)
        c = torch_qrnn._fma(ma[:, k], c, mb[:, k])
    assert torch.equal(torch_qrnn._warp_carries(ma, mb, c0t, 1),
                       torch.stack(cin, dim=1))


@pytest.mark.parametrize("lanes,t,tile", [
    (512, 1, (4, 8, 16, 1)), (512, 128, (4, 8, 16, 1)),
    (512, 200, (4, 8, 16, 2)), (512, 513, (4, 8, 16, 3)),
    (512, 1000, (4, 8, 16, 4)), (16, 7, (4, 8, 16, 1)),
    (513, 200, (8, 4, 16, 4)), (1024, 1500, (8, 4, 16, 8)),
    (1024, 1, (8, 4, 16, 1)), (1025, 200, (8, 4, 16, 4)),
    (1048, 3000, (8, 4, 16, 4)), (4096, 1000, (8, 4, 16, 4)),
    (4096, 21, (8, 4, 16, 1)), (6143, 4000, (8, 4, 16, 4)),
    (2048, 257, (8, 4, 16, 3))])
def test_few_tile_by_lanes_covers_t_in_the_fewest_segments(lanes, t, tile):
    """The few-lane kernel's tile: the narrow one (4 lanes, 16 warps of 8
    chunks of at most 4 steps) on at most FEW_NARROW lanes, the mid one (8
    lanes, 16 warps of 4 chunks of at most 8) on at most FEW_MID, else the
    wide one (8 lanes, 16 warps of 4 chunks of at most 4); the chunk the
    shortest that covers T in the fewest segments."""
    assert torch_qrnn.few_tile(lanes, t) == tile
    lw, per, warps, chunk = tile
    max_chunk = (torch_qrnn.FEW_TILE if lanes <= torch_qrnn.FEW_NARROW
                 else torch_qrnn.FEW_MID_TILE if lanes <= torch_qrnn.FEW_MID
                 else torch_qrnn.FEW_WIDE_TILE)[2]
    assert -(-t // (per * warps * chunk)) == -(-t // (per * warps
                                                      * max_chunk))


def test_few_chunking_constants_are_the_kernels():
    """ops/qrnn.py's FEW_NARROW, FEW_MID, FEW_TILE, FEW_MID_TILE and
    FEW_WIDE_TILE are the shipped few-lane kernel's kFewNarrow, kFewMid
    and kFew* constants, and kernel_variants's FEW_SHIPPED is its
    tiles."""
    import re
    from pase_tpu_torch import kernel_variants
    with open(cuda_qrnn.SOURCE) as f:
        text = f.read()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}
    assert const["kFewNarrow"] == torch_qrnn.FEW_NARROW
    assert const["kFewMid"] == torch_qrnn.FEW_MID
    assert tuple(const[k] for k in (
        "kFewMidLanes", "kFewMidWarps",
        "kFewMidChunk")) == torch_qrnn.FEW_MID_TILE
    assert tuple(const[k] for k in ("kFewLanes", "kFewWarps",
                                    "kFewChunk")) == torch_qrnn.FEW_TILE
    assert tuple(const[k] for k in (
        "kFewWideLanes", "kFewWideWarps",
        "kFewWideChunk")) == torch_qrnn.FEW_WIDE_TILE
    assert kernel_variants.FEW_SHIPPED == tuple(
        const[k] for k in kernel_variants._FEW_NAMES)


def test_few_wrapper_cpu_path_launches_nothing():
    """qrnn_pool_fwd_few on CPU tensors takes the plain version of its
    algebra at its chunking, seeded and unseeded, and launches nothing."""
    y, c0 = _inputs(2, 37, 8, seed=14)
    before = dict(cuda_qrnn.LAUNCHES)
    for seed in (None, torch.from_numpy(c0)):
        h, c = cuda_qrnn.qrnn_pool_fwd_few(torch.from_numpy(y), seed)
        _, per, warps, chunk = torch_qrnn.few_tile(16, 37)
        hp, _, cp = torch_qrnn.qrnn_pool_fwd_train_chunked_plain(
            torch.from_numpy(y), seed, chunk=chunk, chunks=per * warps,
            warp_chunks=per)
        assert torch.equal(h, hp) and torch.equal(c, cp)
        assert torch.equal(h, torch_qrnn.qrnn_pool_few_plain(
            torch.from_numpy(y), seed)[0])
    assert cuda_qrnn.LAUNCHES == before


# the split kernel's algebra (T, tile, chunk; 8 chunks a segment, a
# tile's map from its eighths): one step; T under one tile; several tiles,
# the last ragged; two whole tiles; the shipped tiling at T = 203 on 512
# lanes (6 tiles of 40 steps, the last of 3) and at T = 21 (one tile of
# chunks of 3); tiles of one step a chunk; on 3 x 11 lanes (a 32-lane tile
# spans three rows)
SPLIT_TILED = [(1, 8, 1), (7, 40, 5), (37, 16, 2), (80, 40, 5),
               (203, 40, 5), (21, 24, 3), (50, 8, 1)]


@pytest.mark.parametrize("t,tile,chunk", SPLIT_TILED, ids=str)
@pytest.mark.parametrize("seeded", [False, True])
def test_split_plain_matches_serial_and_pallas(t, tile, chunk, seeded):
    """qrnn_pool_fwd_split's algebra (each tile's map folded from its
    chunks' maps, the carry into a tile put through the maps of the tiles
    before it in order, the carry into a chunk through the maps of the
    chunks before it in its tile, each chunk re-run) against the Pallas
    kernel in interpret mode and the serial plain version, within 1e-6."""
    y, c0, (h_ref, c_ref) = _eval_case(t, seeded)
    c0t = None if c0 is None else torch.from_numpy(c0)
    h, c = torch_qrnn.qrnn_pool_split_plain(
        torch.from_numpy(y), c0t, tile=tile, chunk=chunk)
    h_ser, c_ser = torch_qrnn.qrnn_pool(torch.from_numpy(y), c0t)
    assert h.shape == (3, t, 11) and c.shape == (3, 11)
    for got, want in ((h, h_ser), (c, c_ser), (h, np.asarray(h_ref)),
                      (c, np.asarray(c_ref))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("lanes,t,tiling", [
    (512, 1, (1, 8)), (512, 21, (3, 24)), (512, 200, (5, 40)),
    (512, 800, (5, 40)), (512, 1000, (5, 80)), (512, 10000, (5, 440)),
    (1024, 1500, (5, 160)), (2048, 1000, (5, 200)), (4096, 4000, (5, 1360)),
    (49152, 200, (5, 200)), (49152, 60, (4, 64)), (512, 41, (5, 40))])
def test_split_tiling_aims_at_the_grid(lanes, t, tiling):
    """The split kernel's tiling: as many time tiles as bring the blocks
    (tiles of 32 lanes) to SPLIT_GRID, each the fewest whole segments of 8
    x 5 steps (at most SPLIT_SEGS) that hold its share; one tile, chunks of
    the shortest length that covers T; its CPU wrapper takes the plain
    version of its algebra there and launches nothing."""
    assert torch_qrnn.split_tiling(lanes, t) == tiling
    b, hid = max(1, lanes // 512), min(lanes, 512)
    if b * t * hid <= 512 * 1000:
        y, _ = _inputs(b, t, hid, seed=t)
        before = dict(cuda_qrnn.LAUNCHES)
        h, c = cuda_qrnn.qrnn_pool_fwd_split(torch.from_numpy(y))
        chunk, tile = tiling
        hp, cp = torch_qrnn.qrnn_pool_split_plain(
            torch.from_numpy(y), tile=tile, chunk=chunk)
        assert torch.equal(h, hp) and torch.equal(c, cp)
        assert cuda_qrnn.LAUNCHES == before


def test_split_tiling_constants_are_the_kernels():
    """ops/qrnn.py's TILE_LANES, SPLIT_SEGS and SPLIT_GRID are the shipped
    split kernel's kEvalLanes, kSplitSegs and kSplitGrid (its chunks are
    the eval kernel's: EVAL_CHUNKS, EVAL_CHUNK), and kernel_variants's
    SPLIT_SHIPPED is its tile: the eval kernel's kEvalChunk, kEvalBlocks
    and kEvalDepth, and kSplitGrid."""
    import re
    from pase_tpu_torch import kernel_variants
    with open(cuda_qrnn.SOURCE) as f:
        text = f.read()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}
    assert "kSplitLanes" not in const and "kSplitChunk" not in const
    assert (const["kEvalLanes"], const["kSplitSegs"],
            const["kSplitGrid"]) == (
        torch_qrnn.TILE_LANES, torch_qrnn.SPLIT_SEGS, torch_qrnn.SPLIT_GRID)
    assert kernel_variants.SPLIT_SHIPPED == tuple(
        const[k] for k in ("kEvalChunk", "kEvalBlocks", "kSplitGrid",
                           "kEvalDepth"))


def test_train_chunking_constants_are_the_kernels():
    """ops/qrnn.py's TRAIN_CHUNKS, FWD_CHUNK and BWD_CHUNK are the
    shipped kernels' kTrainThreads / kTrainLanes, kFwdChunk and
    kBwdChunk."""
    import re
    with open(cuda_qrnn.SOURCE) as f:
        text = f.read()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}
    assert const["kTrainThreads"] // const["kTrainLanes"] == \
        torch_qrnn.TRAIN_CHUNKS
    assert const["kFwdChunk"] == torch_qrnn.FWD_CHUNK
    assert const["kBwdChunk"] == torch_qrnn.BWD_CHUNK


def test_train_wrappers_cpu_path_launches_nothing():
    """qrnn_pool_fwd_train / qrnn_pool_bwd on CPU tensors take the serial
    plain versions (the CPU main path) and launch nothing."""
    y, c0 = _inputs(2, 21, 8, seed=10)
    yt, c0t = torch.from_numpy(y), torch.from_numpy(c0)
    dh = torch.ones(2, 21, 8)
    before = dict(cuda_qrnn.LAUNCHES)
    h, c, c_last = cuda_qrnn.qrnn_pool_fwd_train(yt, c0t)
    dy, dc0 = cuda_qrnn.qrnn_pool_bwd(yt, c, dh, None, c0t)
    h_ref, c_ref = torch_qrnn.qrnn_pool_fwd_train(yt, c0t)
    dy_ref, dc0_ref = torch_qrnn.qrnn_pool_bwd(yt, c_ref, dh, None, c0t)
    assert torch.equal(h, h_ref) and torch.equal(c, c_ref)
    assert torch.equal(c_last, c_ref[:, -1])
    assert torch.equal(dy, dy_ref) and torch.equal(dc0, dc0_ref)
    assert cuda_qrnn.LAUNCHES == before


def test_launches_count_each_forward_entry_under_its_name():
    """Every entry forward_entry routes to, and the training pair, has a
    launch count of its own, and no other count is kept (the few-lane
    kernel's launches are its entry's); the route's limits are those its
    comment measured."""
    assert (cuda_qrnn.EVAL_LANES, cuda_qrnn.EVAL_SHORT_LANES,
            cuda_qrnn.EVAL_SHORT_STEPS) == (6144, 4096, 200)
    assert (cuda_qrnn.SPLIT_LANES, cuda_qrnn.SPLIT_STEPS) == (512, 7500)
    routed = {cuda_qrnn.forward_entry(lanes, seeded, steps)
              for lanes in (1, 512, 1024, 4096, 6144, 16384)
              for seeded in (False, True) for steps in (1, 200, 7500)}
    assert routed == {"qrnn_pool_fwd_split", "qrnn_pool_fwd_few",
                      "qrnn_pool_fwd_seg", "qrnn_pool_fwd",
                      "qrnn_pool_fwd_eval"}
    assert set(cuda_qrnn.LAUNCHES) == routed | {"qrnn_pool_fwd_train",
                                                "qrnn_pool_bwd"}


@pytest.mark.parametrize("lanes,seeded,steps,entry", [
    (512, True, 100, "qrnn_pool_fwd_seg"),
    (16383, True, 200, "qrnn_pool_fwd_seg"),
    (16384, True, 200, "qrnn_pool_fwd"), (49152, True, 200, "qrnn_pool_fwd"),
    (512, False, 100, "qrnn_pool_fwd_few"),
    (512, False, 200, "qrnn_pool_fwd_few"),
    (512, False, 1000, "qrnn_pool_fwd_few"),
    (512, False, 7499, "qrnn_pool_fwd_few"),
    (512, False, 7500, "qrnn_pool_fwd_split"),
    (512, False, 10000, "qrnn_pool_fwd_split"),
    (16, False, 20000, "qrnn_pool_fwd_split"),
    (513, False, 10000, "qrnn_pool_fwd_few"),
    (512, False, 3000, "qrnn_pool_fwd_few"),
    (1024, False, 1500, "qrnn_pool_fwd_few"),
    (1024, False, 3000, "qrnn_pool_fwd_few"),
    (2048, False, 200, "qrnn_pool_fwd_few"),
    (2048, False, 1000, "qrnn_pool_fwd_few"),
    (2048, False, 4000, "qrnn_pool_fwd_few"),
    (4096, False, 200, "qrnn_pool_fwd_eval"),
    (4096, False, 201, "qrnn_pool_fwd_few"),
    (4096, False, 600, "qrnn_pool_fwd_few"),
    (4096, False, 1000, "qrnn_pool_fwd_few"),
    (4096, False, 4000, "qrnn_pool_fwd_few"),
    (4096, False, 10000, "qrnn_pool_fwd_few"),
    (6144, False, 1000, "qrnn_pool_fwd_eval"),
    (12288, False, 200, "qrnn_pool_fwd_eval"),
    (24576, False, 200, "qrnn_pool_fwd_eval"),
    (24576, False, 21, "qrnn_pool_fwd_eval"),
    (49152, False, 200, "qrnn_pool_fwd_eval"),
    (1, False, 1, "qrnn_pool_fwd_few"), (24, False, 10, "qrnn_pool_fwd_few"),
    (1025, False, 200, "qrnn_pool_fwd_few"),
    (1048, False, 3000, "qrnn_pool_fwd_few"),
    (1049, False, 200, "qrnn_pool_fwd_few"),
    (4095, False, 200, "qrnn_pool_fwd_few"),
    (6143, False, 1000, "qrnn_pool_fwd_few"),
    (6143, False, 200, "qrnn_pool_fwd_eval"),
    (513, False, 7500, "qrnn_pool_fwd_few"),
    (1, True, 20000, "qrnn_pool_fwd_seg")])
def test_forward_entry_routes_by_seed_and_lanes(lanes, seeded, steps, entry):
    """The operator's route: seeded under SEG_LANES lanes the segmented
    kernel (a streaming push), else the one-thread-a-lane loop; unseeded
    the chunked eval kernel on EVAL_LANES lanes or more, or on
    EVAL_SHORT_LANES or more of at most EVAL_SHORT_STEPS steps (every
    training CLI's eval: [48,200,256] 12288 lanes, [96,200,512] 49152,
    [48,21,512] 24576), else the split kernel on at most SPLIT_LANES lanes
    of SPLIT_STEPS steps or more (a 100 s file at B = 1 in one window,
    [1,10000,512]), else the few-lane kernel (B = 1 extraction
    [1,200,512], forward-chunk's window [1,1000,512], the time shard's
    [2,1500,512], the serving batch [8,1000,512], [8,4000,512],
    [8,1000,256]; 3000 steps at 512 to 2048 lanes and 600 at 4096, where
    the split kernel wins on random gates but not on slow ones)."""
    assert cuda_qrnn.SEG_LANES == 16384
    assert (cuda_qrnn.SPLIT_LANES, cuda_qrnn.SPLIT_STEPS) == (512, 7500)
    assert cuda_qrnn.forward_entry(lanes, seeded, steps) == entry


# (B, T, H) of narrow streaming pushes: a 1 s push, a 100 ms push
PUSHES = [(1, 100, 16), (2, 10, 16)]


@pytest.mark.parametrize("shape", PUSHES, ids=str)
@pytest.mark.parametrize("seeded", [False, True])
def test_serial_plain_matches_pallas_at_push_shapes(shape, seeded):
    """The seeded serial plain version (gates first, then one chain per
    lane seeded with c0, as the serial kernels run it) against the Pallas
    kernel in interpret mode (which folds c0 into b_1) and the plain
    version, within 1e-6."""
    y, c0 = _inputs(*shape, seed=sum(shape) + seeded)
    c0t = torch.from_numpy(c0) if seeded else None
    h, c = torch_qrnn.qrnn_pool_serial_plain(torch.from_numpy(y), c0t)
    h_ref, c_ref = _pallas_pool(y, c0 if seeded else None)
    h_ser, c_ser = torch_qrnn.qrnn_pool(torch.from_numpy(y), c0t)
    assert h.shape == shape and c.shape == (shape[0], shape[2])
    for got, want in ((h, np.asarray(h_ref)), (c, np.asarray(c_ref)),
                      (h, h_ser), (c, c_ser)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("wrapper", ["qrnn_pool_fwd_seg",
                                     "qrnn_pool_fwd_loop"])
def test_serial_wrappers_cpu_path(wrapper):
    """The serial kernels' wrappers on CPU tensors take the seeded serial
    plain version and launch nothing."""
    y, c0 = _inputs(2, 21, 8, seed=8)
    before = dict(cuda_qrnn.LAUNCHES)
    for seed in (None, torch.from_numpy(c0)):
        h, c = getattr(cuda_qrnn, wrapper)(torch.from_numpy(y), seed)
        h_ref, c_ref = torch_qrnn.qrnn_pool_serial_plain(
            torch.from_numpy(y), seed)
        assert torch.equal(h, h_ref) and torch.equal(c, c_ref)
    assert cuda_qrnn.LAUNCHES == before


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::qrnn_pool_fwd_seg_kernel<4, 128, 128>"
     "(float const*, float const*, float*, float*, long, long, long)",
     "qrnn fwd"),
    ("void (anonymous namespace)::qrnn_pool_fwd_kernel(float const*, "
     "float const*, float*, float*, long, long, long)", "qrnn fwd"),
    ("void (anonymous namespace)::qrnn_pool_fwd_few_kernel<4, 16, 4, 1, 2>("
     "float const*, float const*, float*, float*, long, long, long, int)",
     "qrnn fwd few"),
    ("(anonymous namespace)::qrnn_pool_bwd_kernel(float const*)",
     "qrnn bwd"),
    ("void (anonymous namespace)::qrnn_pool_fwd_train_kernel<8>(float "
     "const*, float const*, float*, float*, float*, long, long, long, int)",
     "qrnn fwd_train"),
    ("void (anonymous namespace)::qrnn_pool_bwd_chunked_kernel<4>(float "
     "const*, float const*, float const*, float const*, float const*, "
     "float*, float*, long, long, long, int)", "qrnn bwd"),
    ("void (anonymous namespace)::qrnn_pool_fwd_eval_kernel<5>(float "
     "const*, float const*, float*, float*, long, long, long, int)",
     "qrnn fwd eval"),
    ("void (anonymous namespace)::qrnn_pool_fwd_split_kernel<5, 3>(float "
     "const*, float const*, float*, float*, int*, float*, long, long, long, "
     "int, int, int, int)", "qrnn fwd split"),
    ("void (anonymous namespace)::qrnn_pool_fwd_few_kernel<8, 8, 8, 1>("
     "float const*, float const*, float*, float*, long, long, long, int)",
     "qrnn fwd few")])
def test_profiler_names_the_qrnn_kernels(name, kind):
    """A push's profile counts K1's serial serving kernels (the segmented
    one and the one-thread-a-lane loop) as 'qrnn fwd', apart from the
    few-lane kernel, the eval kernel and the split
    kernel; a step's split counts the training
    pair's kernels as 'qrnn fwd_train' and 'qrnn bwd'."""
    from pase_tpu_torch.profiling import kernel_kind
    assert kernel_kind(name) == kind


def test_kernel_variants_replace_lines_of_the_shipped_sources():
    """python -m pase_tpu_torch.kernel_variants builds each variant from
    the shipped source with lines replaced: each line it replaces is
    there exactly once. The serial group holds every tile of the
    segmented kernel but the shipped one, the train group every tile of
    the training pair but the shipped one, the eval group every tile of
    the eval kernel but the shipped one, the split group every tile of
    the split kernel but the shipped one, the fewlane group every tile of
    the few-lane kernel but the shipped one, each a different one."""
    from pase_tpu_torch import kernel_variants
    serial = [k for k in kernel_variants.VARIANTS
              if k.startswith("qrnn serial")]
    assert kernel_variants.SEG_SHIPPED in kernel_variants.SEG_TILES
    assert len(serial) == len(kernel_variants.SEG_TILES) - 1
    train = [k for k in kernel_variants.VARIANTS
             if k.startswith("qrnn train")]
    tiles = kernel_variants.TRAIN_TILES
    assert kernel_variants.TRAIN_SHIPPED in tiles
    assert len(set(tiles)) == len(tiles) and len(train) == len(tiles) - 1
    assert "train" in kernel_variants.GROUPS
    evals = [k for k in kernel_variants.VARIANTS
             if k.startswith("qrnn eval")]
    tiles = kernel_variants.EVAL_TILES
    assert kernel_variants.EVAL_SHIPPED in tiles
    assert len(set(tiles)) == len(tiles) and len(evals) == len(tiles) - 1
    assert "eval" in kernel_variants.GROUPS
    splits = [k for k in kernel_variants.VARIANTS
              if k.startswith("qrnn split")]
    tiles = kernel_variants.SPLIT_TILES
    assert kernel_variants.SPLIT_SHIPPED in tiles
    assert len(set(tiles)) == len(tiles) and len(splits) == len(tiles) - 1
    assert "split" in kernel_variants.GROUPS
    few = [k for k in kernel_variants.VARIANTS
           if k.startswith("qrnn fewlane")]
    tiles = kernel_variants.FEW_TILES
    assert kernel_variants.FEW_SHIPPED in tiles
    assert len(set(tiles)) == len(tiles) and len(few) == len(tiles) - 1
    assert "fewlane" in kernel_variants.GROUPS
    for name, (source, subs) in kernel_variants.VARIANTS.items():
        with open(source) as f:
            text = f.read()
        assert [text.count(old) for old, _ in subs] == [1] * len(subs), name
