"""QRNN pooling through the hand-written CUDA kernels (csrc/qrnn_pool.cu).

The kernels replace the TPU kernels of ``pase_tpu/ops/pallas_qrnn.py``:
the linear scan and the gate math around it (forward), and the
reverse-time scan of its custom VJP (backward). They are built with
``nvcc`` for ``sm_90a`` into one shared library with plain C entry points
at first use, cached under ``build/pase_tpu_torch/`` by a hash of the
source, and loaded with ``ctypes`` (``ops/cuda_build.py``).

Entry points, each with a launch count in ``LAUNCHES``:
  qrnn_pool_fwd_eval    ``qrnn_pool`` without a gradient and without c0 on
                        many lanes (B * H; ``forward_entry``: the eval of
                        every training CLI, batched serving): the training
                        forward's chunked scan without c's stores, at a
                        tile of its own (``eval_chunking`` gives its
                        chunking, which
                        ``ops.qrnn.qrnn_pool_fwd_train_chunked_plain``
                        repeats); within 1e-5 of the plain version, the
                        same bits on every call;
  qrnn_pool_fwd_split   ``qrnn_pool`` without a gradient and without c0 on
                        few lanes of many steps (``forward_entry``: at most
                        SPLIT_LANES lanes of at least SPLIT_STEPS steps, a
                        file of 75 s or more at B = 1 in one window): each
                        lane's time axis cut into tiles over blocks, every
                        tile run from c = 0 (h stored once a carry in has
                        no say in it), its map published, the carries
                        composed between blocks in tile order, each tile
                        run again from its true carry until the two runs
                        meet; within 1e-5 of the plain version, the same
                        bits on every call and on every replay of a CUDA
                        graph (``split_tiling`` gives its tiling, which
                        ``ops.qrnn.qrnn_pool_split_plain`` repeats). Its
                        time depends on the gates: the second run is a
                        segment where a carry dies fast, the whole tile
                        where it lives thousands of steps;
  qrnn_pool_fwd_few     ``qrnn_pool`` without a gradient and without c0 on
                        the other calls (B = 1 extraction, a 10 s window,
                        the serving batch): the time axis in chunks, each
                        warp's chunk maps scanned with shuffles, the
                        block's warps cutting T, z, f and o loaded in one
                        round trip, so few lanes fill the card; at a tile
                        by lanes (``few_chunking`` gives it, which
                        ``ops.qrnn.qrnn_pool_fwd_train_chunked_plain``
                        repeats with ``warp_chunks``); within 1e-5 of the
                        plain version, the same bits on every call;
  qrnn_pool_fwd_seg     ``qrnn_pool`` without a gradient, seeded with c0,
                        on fewer than SEG_LANES lanes (a streaming push):
                        the gates of a segment of steps computed by every
                        thread of a block, then one serial FMA chain per
                        lane seeded with c0, so a block-streamed run (c_T
                        threaded into the next block's c0) equals one full
                        run bit for bit;
  qrnn_pool_fwd         the same function, seeded, on the other calls
                        (many lanes), one thread a lane, with the same
                        bits as qrnn_pool_fwd_seg;
  qrnn_pool_fwd_train   the forward of ``QRNNPool``: also stores every c_t;
  qrnn_pool_bwd         the backward of ``QRNNPool``. Both cut each lane's
                        time axis into chunks, one warp a chunk of 32
                        lanes, compose each chunk's affine map, put the
                        carry through them in a fixed order and re-run the
                        chunks from it, so a training rank's few lanes
                        fill the card; within 1e-5 of the plain versions,
                        the same bits on every call (``train_chunking``
                        gives their chunking, which
                        ``ops.qrnn.qrnn_pool_fwd_train_chunked_plain`` and
                        ``qrnn_pool_bwd_chunked_plain`` repeat).

``qrnn_pool(y, c0=None)`` goes through the ``QRNNPool`` autograd Function
when a gradient is needed, and through ``qrnn_pool_fwd`` otherwise, which
routes by c0 and lane count (``forward_entry``). A tensor on the CPU
takes the plain PyTorch versions (``ops/qrnn.py``). For a CUDA tensor
every wrapper launches its kernel or raises: a missing ``nvcc``, a failed
build and a refused launch all raise.

The serving forward is also a registered operator,
``torch.ops.pase_tpu_torch.qrnn_pool_fwd(Tensor y, Tensor? c0) -> (Tensor,
Tensor)`` (``torch.library.Library``: a CPU implementation, the plain
version; a CUDA one, the kernels; a fake one for the shapes), so that
``torch.export`` traces the encoder with a symbolic batch and an exported
program calls the kernels. The route between the five forward kernels
is taken inside the CUDA implementation, from the shapes of the call, so
one exported program takes each route at the batch sizes that call for
it. Importing this module registers the operator; a process that
loads an exported program needs nothing else of the package.
"""

import ctypes

import torch

from pase_tpu_torch.ops import cuda_build
from pase_tpu_torch.ops import qrnn as _plain

SOURCE = cuda_build.source_path("qrnn_pool")
BUILD_DIR = cuda_build.BUILD_DIR

# kernel launches per entry point since import (or since reset_launches)
LAUNCHES = {"qrnn_pool_fwd_split": 0, "qrnn_pool_fwd_few": 0,
            "qrnn_pool_fwd_seg": 0,
            "qrnn_pool_fwd": 0, "qrnn_pool_fwd_eval": 0,
            "qrnn_pool_fwd_train": 0, "qrnn_pool_bwd": 0}
_LIB = None
# unseeded calls take the chunked eval kernel on at least EVAL_LANES lanes,
# or on at least EVAL_SHORT_LANES lanes of at most EVAL_SHORT_STEPS steps;
# of the others, those on at most SPLIT_LANES lanes of at least SPLIT_STEPS
# steps the split kernel, the rest the few-lane kernel. The limits were
# drawn against the serving kernel the few-lane one replaced ("old"), on
# the H100 (python -m pase_tpu_torch.kernel_variants eval, in turns; eval /
# old ms): 0.0117 / 0.0172 at [12,200,512] (6144 lanes), 0.0219 / 0.0262
# at [12,400,512], 0.0519 / 0.0527 at [12,1000,512], 0.1987 / 0.2486 at
# [16,4000,512]; at 4096 lanes 0.0033 / 0.0102 at [8,21,512] and 0.0098 /
# 0.0123 at [8,200,512], but 0.0173 / 0.0162 at [8,400,512]; 0.0096 /
# 0.0071 at [4,200,512] (2048 lanes). The split kernel's time depends on
# the gates, so it takes a shape only where it is no slower than the old
# kernel on gates whose carries live thousands of steps (f less 6) as well
# as on random ones (kernel_variants split, in turns; NVIDIA H100 80GB
# HBM3, 700.00 W; split / old, random gates and slow ones): at 512 lanes
# 1.10 and 1.44 at T = 3000, 0.84 and 1.17 at 5000, 0.67 and 0.99 at 7500,
# 0.65 and 0.98-1.01 at 10000, 0.57 and 0.93 at 20000; at 1024 lanes 0.68
# and 1.11 at 10000; at 2048 lanes 1.02 and 1.61 at 3000; at 4096 lanes
# 1.04 and 1.57 at [8,1000,512], 0.93 and 1.56 at [8,4000,512]. Against
# the few-lane kernel (kernel_variants fewlane, in turns): split / few 0.89
# on random gates and 1.36 on slow ones at [1,10000,512]
EVAL_LANES, EVAL_SHORT_LANES, EVAL_SHORT_STEPS = 6144, 4096, 200
SPLIT_LANES, SPLIT_STEPS = 512, 7500
# seeded calls on fewer lanes take the segmented kernel, the others the
# one-thread-a-lane loop (the same bits: a composed carry rounds otherwise,
# so no seeded call takes a chunked kernel). On the H100, seeded (python -m
# pase_tpu_torch.kernel_variants serial): the segmented kernel took
# 0.00456 ms at [1,100,512] against the loop's 0.01975 and 0.01884 at
# [32,100,512] (16384 lanes) against 0.02062, but 0.05817 at [48,200,512]
# (24576 lanes) against 0.05697 and 0.11211 at [96,200,512] against 0.07021,
# where the loop is bound by bytes
SEG_LANES = 16384

_P, _N = cuda_build.PTR, cuda_build.SIZE
_ARGTYPES = {
    # (y, c0, h, c_T, B, T, H, stream)
    "qrnn_pool_fwd": [_P, _P, _P, _P, _N, _N, _N, _P],
    "qrnn_pool_fwd_seg": [_P, _P, _P, _P, _N, _N, _N, _P],
    "qrnn_pool_fwd_eval": [_P, _P, _P, _P, _N, _N, _N, _P],
    "qrnn_pool_fwd_few": [_P, _P, _P, _P, _N, _N, _N, _P],
    # (y, c0, h, c_T, ctrl, maps, tiles, B, T, H, stream)
    "qrnn_pool_fwd_split": [_P, _P, _P, _P, _P, _P, _N, _N, _N, _N, _P],
    # (y, c0, h, c, c_T, B, T, H, stream)
    "qrnn_pool_fwd_train": [_P, _P, _P, _P, _P, _N, _N, _N, _P],
    # (y, c, dh, dc_T, c0, dy, dc0, B, T, H, stream)
    "qrnn_pool_bwd": [_P, _P, _P, _P, _P, _P, _P, _N, _N, _N, _P],
    # () -> qrnn_pool_fwd_seg's segment length
    "qrnn_pool_fwd_segment_steps": [],
    # (T, int[3] out) -> the training pair's chunking
    "qrnn_pool_train_chunking": [_N, _P],
    # (T, int[2] out) -> qrnn_pool_fwd_eval's chunking
    "qrnn_pool_eval_chunking": [_N, _P],
    # (lanes, T, long long[3] out) -> qrnn_pool_fwd_split's tiling
    "qrnn_pool_split_tiling": [_N, _N, _P],
    # (stream) -> one empty kernel
    "qrnn_pool_empty": [_P],
    # (y, h, B, T, H, stream) -> the streaming floor's kernel
    "qrnn_pool_stream_floor": [_P, _P, _N, _N, _N, _P],
    # (lanes, T, int[4] out) -> qrnn_pool_fwd_few's tile
    "qrnn_pool_few_chunking": [_N, _N, _P],
    # (int[9] out) -> qrnn_pool_fwd_few's registers, spills, blocks an SM
    # (narrow, mid and wide tiles)
    "qrnn_pool_few_attrs": [_P],
}
# qrnn_pool_fwd_split's flags for calls outside a CUDA graph capture:
# {(device index, stream handle): int32 tensors, the last one in use}. A
# stream's buffer is zeroed once, when it is made; every call leaves the
# ticket counter at 0 and moves the epoch its flags carry on. A call being
# captured takes flags of its own (``_split_ctrl``).
_SPLIT_CTRL = {}
# the flags a stream's first buffer holds at least
SPLIT_CTRL_TILES = 4096


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library_path():
    """Where the built library for the current source lives."""
    return cuda_build.library_path(SOURCE, BUILD_DIR)


def build(verbose=False):
    """Compile the kernels if their library is not built yet, load it, and
    return the ``ctypes`` handle. Raises on any failure."""
    global _LIB
    if _LIB is None:
        _LIB = cuda_build.load(SOURCE, _ARGTYPES, BUILD_DIR, verbose)
    return _LIB


def segment_steps():
    """Steps per segment of ``qrnn_pool_fwd_seg``'s kernel, from the
    built library."""
    return build().qrnn_pool_fwd_segment_steps()


def train_chunking(steps, lib=None):
    """The training pair's chunking at T = steps, from the built library
    (or ``lib``): (chunks a segment, steps a chunk forward, steps a chunk
    backward), as ``ops.qrnn.qrnn_pool_fwd_train_chunked_plain`` and
    ``qrnn_pool_bwd_chunked_plain`` take it."""
    out = (ctypes.c_int * 3)()
    (lib or build()).qrnn_pool_train_chunking(steps, ctypes.addressof(out))
    return tuple(out)


def eval_chunking(steps, lib=None):
    """``qrnn_pool_fwd_eval``'s chunking at T = steps, from the built
    library (or ``lib``): (chunks a segment, steps a chunk), as
    ``ops.qrnn.qrnn_pool_fwd_train_chunked_plain`` takes it."""
    out = (ctypes.c_int * 2)()
    (lib or build()).qrnn_pool_eval_chunking(steps, ctypes.addressof(out))
    return tuple(out)


def split_tiling(lanes, steps, lib=None):
    """``qrnn_pool_fwd_split``'s tiling of a call on ``lanes`` lanes of T =
    steps, from the built library (or ``lib``): (steps a chunk, steps a
    time tile, tiles); the first two are what ``ops.qrnn.split_tiling``
    repeats and ``ops.qrnn.qrnn_pool_split_plain`` takes."""
    out = (ctypes.c_longlong * 3)()
    (lib or build()).qrnn_pool_split_tiling(lanes, steps,
                                            ctypes.addressof(out))
    return tuple(out)


def few_chunking(lanes, steps, lib=None):
    """``qrnn_pool_fwd_few``'s tile for a call on ``lanes`` lanes (B * H) of
    T = steps, from the built library (or ``lib``): (lanes a block, chunks
    a warp, warps a block, steps a chunk), as ``ops.qrnn.few_tile`` repeats
    it and ``ops.qrnn.qrnn_pool_fwd_train_chunked_plain`` takes it
    (``chunks`` = chunks a warp x warps, ``warp_chunks`` = chunks a
    warp)."""
    out = (ctypes.c_int * 4)()
    (lib or build()).qrnn_pool_few_chunking(lanes, steps,
                                            ctypes.addressof(out))
    return tuple(out)


def few_attrs(lib=None):
    """``qrnn_pool_fwd_few``'s kernels as built (or as ``lib`` has them):
    {tile: {registers a thread, spill bytes a thread, blocks an SM}} of
    its narrow, mid and wide tiles."""
    out = (ctypes.c_int * 9)()
    err = (lib or build()).qrnn_pool_few_attrs(ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"qrnn_pool_few_attrs failed: cudaError {err}")
    keys = ("registers", "spill_bytes", "blocks_per_sm")
    return {tile: dict(zip(keys, out[3 * i:3 * i + 3]))
            for i, tile in enumerate(("narrow", "mid", "wide"))}


def empty_launch():
    """One empty kernel on the current stream (the launch floor timed
    beside launch-bound shapes; on no path, so not counted)."""
    err = build().qrnn_pool_empty(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"qrnn_pool_empty launch failed: cudaError {err}")


def stream_floor(y):
    """The streaming floor on y [B, T, 3H] (CUDA, float32, contiguous, H a
    multiple of 4): h = sigmoid(o) tanh(z) sigmoid(f) of each lane-step in
    one kernel, y read once, h written once, no carry; the least a K1 of
    one launch can move, timed beside it (on no path, so not counted)."""
    _check(y, None)
    bsz, t, h3 = y.shape
    h = torch.empty((bsz, t, h3 // 3), dtype=y.dtype, device=y.device)
    with torch.cuda.device(y.device):
        err = build().qrnn_pool_stream_floor(
            y.data_ptr(), h.data_ptr(), bsz, t, h3 // 3,
            torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qrnn_pool_stream_floor launch failed: "
                           f"cudaError {err}")
    return h


def _check_lanes(name, t, like):
    """t is None, or float32 [B, H] on like's device and contiguous."""
    if t is None:
        return
    bsz, hid = like.shape[0], like.shape[-1]
    if t.device != like.device or t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 on y's device")
    if tuple(t.shape) != (bsz, hid):
        raise ValueError(f"{name} must be [{bsz}, {hid}], "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_steps(name, t, y):
    """t is float32 [B, T, H] on y's device and contiguous."""
    bsz, steps, h3 = y.shape
    if t.device != y.device or t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 on y's device")
    if tuple(t.shape) != (bsz, steps, h3 // 3):
        raise ValueError(f"{name} must be [{bsz}, {steps}, {h3 // 3}], "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check(y, c0):
    if y.dtype != torch.float32:
        raise TypeError(f"qrnn_pool kernel takes float32, got {y.dtype}")
    if y.dim() != 3 or y.shape[-1] % 3 != 0:
        raise ValueError(f"y must be [B, T, 3H], got {tuple(y.shape)}")
    bsz, t, h3 = y.shape
    if bsz == 0 or t == 0 or h3 == 0:
        raise ValueError(f"empty y {tuple(y.shape)}")
    if not y.is_contiguous():
        raise ValueError("y must be contiguous")
    _check_lanes("c0", c0, y[:, 0, :h3 // 3])


def _cuda_or_plain(y):
    """True when y is on the CPU (plain version), False for CUDA."""
    if y.device.type == "cpu":
        return True
    if y.device.type != "cuda":
        raise ValueError(f"qrnn_pool: no kernel for device {y.device}")
    return False


def _launch(name, *args):
    cuda_build.launch(build(), name, LAUNCHES, *args)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward(name, y, c0):
    _check(y, c0)
    bsz, t, h3 = y.shape
    h = torch.empty((bsz, t, h3 // 3), dtype=y.dtype, device=y.device)
    c_last = torch.empty((bsz, h3 // 3), dtype=y.dtype, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        _launch(name, y.data_ptr(), _ptr(c0), h.data_ptr(),
                c_last.data_ptr(), bsz, t, h3 // 3, stream)
    return h, c_last


def _split_ctrl(device, stream, tiles):
    """The flags of ``qrnn_pool_fwd_split`` on ``stream``: 2 + tiles int32
    at least (ticket counter, epoch, a flag a tile), zeroed.
    While the stream captures a CUDA graph, a new buffer: its zeroing is
    captured with the call, so every replay clears its own flags and no
    two graphs, nor a graph and an eager call, share them. Otherwise the
    stream's buffer, made on the stream when it has none that holds
    ``tiles``."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(2 + tiles, dtype=torch.int32, device=device)
    held = _SPLIT_CTRL.setdefault((device.index, stream.cuda_stream), [])
    if not held or held[-1].numel() < 2 + tiles:
        held.append(torch.zeros(2 + max(tiles, SPLIT_CTRL_TILES),
                                dtype=torch.int32, device=device))
    return held[-1]


def _forward_split(y, c0):
    _check(y, c0)
    bsz, t, h3 = y.shape
    tiles = split_tiling(bsz * (h3 // 3), t)[2]
    h = torch.empty((bsz, t, h3 // 3), dtype=y.dtype, device=y.device)
    c_last = torch.empty((bsz, h3 // 3), dtype=y.dtype, device=y.device)
    maps = torch.empty(3 * _plain.TILE_LANES * tiles, dtype=torch.float32,
                       device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device)
        ctrl = _split_ctrl(y.device, stream, tiles)
        _launch("qrnn_pool_fwd_split", y.data_ptr(), _ptr(c0), h.data_ptr(),
                c_last.data_ptr(), ctrl.data_ptr(), maps.data_ptr(), tiles,
                bsz, t, h3 // 3, stream.cuda_stream)
    return h, c_last


# the operator's namespace; its registrations last as long as this object
_OPS = torch.library.Library("pase_tpu_torch", "DEF")
_OPS.define("qrnn_pool_fwd(Tensor y, Tensor? c0) -> (Tensor, Tensor)")


def _qrnn_pool_fwd_cpu(y, c0):
    """The plain version, for CPU tensors (c_T copied: an operator's
    outputs own their memory)."""
    h, c_last = _plain.qrnn_pool(y, c0)
    return h, c_last.clone()


def forward_entry(lanes, seeded, steps):
    """The forward kernel's entry point for a call on ``lanes`` lanes
    (B * H) of ``steps`` steps (T). Unseeded: the chunked eval kernel on
    at least EVAL_LANES lanes, or on at least EVAL_SHORT_LANES lanes of at
    most EVAL_SHORT_STEPS steps; else the split kernel on at most
    SPLIT_LANES lanes of at least SPLIT_STEPS steps; else the few-lane
    kernel. Seeded: the segmented kernel on fewer than SEG_LANES
    lanes, else the one-thread-a-lane loop (the same bits)."""
    if seeded:
        return "qrnn_pool_fwd_seg" if lanes < SEG_LANES else "qrnn_pool_fwd"
    if lanes >= EVAL_LANES or (lanes >= EVAL_SHORT_LANES
                               and steps <= EVAL_SHORT_STEPS):
        return "qrnn_pool_fwd_eval"
    if lanes <= SPLIT_LANES and steps >= SPLIT_STEPS:
        return "qrnn_pool_fwd_split"
    return "qrnn_pool_fwd_few"


def _qrnn_pool_fwd_cuda(y, c0):
    """The kernels, routed by this call's shapes (``forward_entry``)."""
    lanes = y.shape[0] * (y.shape[-1] // 3)
    entry = forward_entry(lanes, c0 is not None, y.shape[1])
    if entry == "qrnn_pool_fwd_split":
        return _forward_split(y, c0)
    return _forward(entry, y, c0)


@torch.library.register_fake("pase_tpu_torch::qrnn_pool_fwd", lib=_OPS)
def _qrnn_pool_fwd_fake(y, c0):
    bsz, t, h3 = y.shape
    return y.new_empty((bsz, t, h3 // 3)), y.new_empty((bsz, h3 // 3))


_OPS.impl("qrnn_pool_fwd", _qrnn_pool_fwd_cpu, "CPU")
_OPS.impl("qrnn_pool_fwd", _qrnn_pool_fwd_cuda, "CUDA")


def qrnn_pool_fwd(y, c0=None):
    """Serving forward: y [B, T, 3H] (+ c0 [B, H]) -> (h [B, T, H],
    c_T [B, H]). No gradient. Through the registered operator
    ``torch.ops.pase_tpu_torch.qrnn_pool_fwd``, which launches the kernel
    ``forward_entry`` names; on the CPU the plain version."""
    return torch.ops.pase_tpu_torch.qrnn_pool_fwd(y, c0)


def qrnn_pool_fwd_eval(y, c0=None):
    """The chunked eval forward: y [B, T, 3H] (+ c0 [B, H]) -> (h, c_T),
    no gradient, within 1e-5 of the plain version. On the CPU the chunked
    plain version of its algebra at its chunking
    (``ops.qrnn.qrnn_pool_fwd_train_chunked_plain``, ``EVAL_CHUNKS`` chunks
    of ``eval_chunk_len(T)`` steps)."""
    if _cuda_or_plain(y):
        h, _, c_last = _plain.qrnn_pool_fwd_train_chunked_plain(
            y, c0, chunk=_plain.eval_chunk_len(y.shape[1]),
            chunks=_plain.EVAL_CHUNKS)
        return h, c_last
    return _forward("qrnn_pool_fwd_eval", y, c0)


def qrnn_pool_fwd_split(y, c0=None):
    """The split forward: y [B, T, 3H] (+ c0 [B, H]) -> (h, c_T), no
    gradient, within 1e-5 of the plain version, the same bits on every
    call. On the CPU the plain version of its algebra at its tiling
    (``ops.qrnn.qrnn_pool_split_plain``)."""
    if _cuda_or_plain(y):
        return _plain.qrnn_pool_split_plain(y, c0)
    return _forward_split(y, c0)


def qrnn_pool_fwd_few(y, c0=None):
    """The few-lane forward at any lane count: y [B, T, 3H] (+ c0 [B, H])
    -> (h, c_T), no gradient, within 1e-5 of the plain version. On the CPU
    the plain version of its algebra at its chunking
    (``ops.qrnn.qrnn_pool_few_plain``)."""
    if _cuda_or_plain(y):
        return _plain.qrnn_pool_few_plain(y, c0)
    return _forward("qrnn_pool_fwd_few", y, c0)


def qrnn_pool_fwd_seg(y, c0=None):
    """The segmented serving forward at any lane count: y [B, T, 3H] (+ c0
    [B, H]) -> (h, c_T), no gradient. On the CPU the seeded serial plain
    version (``ops.qrnn.qrnn_pool_serial_plain``)."""
    if _cuda_or_plain(y):
        return _plain.qrnn_pool_serial_plain(y, c0)
    return _forward("qrnn_pool_fwd_seg", y, c0)


def qrnn_pool_fwd_loop(y, c0=None):
    """The one-thread-a-lane serving forward (entry ``qrnn_pool_fwd``) at
    any lane count: y [B, T, 3H] (+ c0 [B, H]) -> (h, c_T), no gradient.
    On the CPU the seeded serial plain version."""
    if _cuda_or_plain(y):
        return _plain.qrnn_pool_serial_plain(y, c0)
    return _forward("qrnn_pool_fwd", y, c0)


def qrnn_pool_fwd_train(y, c0=None):
    """Training forward: y [B, T, 3H] (+ c0 [B, H]) -> (h [B, T, H],
    c [B, T, H], c_T [B, H]); c is the residual of ``qrnn_pool_bwd``."""
    if _cuda_or_plain(y):
        h, c = _plain.qrnn_pool_fwd_train(y, c0)
        return h, c, c[:, -1].clone()
    _check(y, c0)
    bsz, t, h3 = y.shape
    h = torch.empty((bsz, t, h3 // 3), dtype=y.dtype, device=y.device)
    c = torch.empty_like(h)
    c_last = torch.empty((bsz, h3 // 3), dtype=y.dtype, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        _launch("qrnn_pool_fwd_train", y.data_ptr(), _ptr(c0), h.data_ptr(),
                c.data_ptr(), c_last.data_ptr(), bsz, t, h3 // 3, stream)
    return h, c, c_last


def qrnn_pool_bwd(y, c, dh, dc_last=None, c0=None):
    """Backward of ``qrnn_pool``: -> (dy [B, T, 3H], dc0 [B, H] or None
    when c0 is None). Same contract as ``ops.qrnn.qrnn_pool_bwd``."""
    if _cuda_or_plain(y):
        return _plain.qrnn_pool_bwd(y, c, dh, dc_last, c0)
    _check(y, c0)
    _check_steps("c", c, y)
    _check_steps("dh", dh, y)
    _check_lanes("dc_last", dc_last, c[:, 0])
    bsz, t, h3 = y.shape
    dy = torch.empty_like(y)
    dc0 = None if c0 is None else torch.empty_like(c0)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        _launch("qrnn_pool_bwd", y.data_ptr(), c.data_ptr(), dh.data_ptr(),
                _ptr(dc_last), _ptr(c0), dy.data_ptr(), _ptr(dc0), bsz, t,
                h3 // 3, stream)
    return dy, dc0


class QRNNPool(torch.autograd.Function):
    """QRNN pooling with its gradient: the forward stores c through
    ``qrnn_pool_fwd_train``, the backward is ``qrnn_pool_bwd``. On CPU
    tensors both are the plain versions."""

    @staticmethod
    def forward(ctx, y, c0):
        h, c, c_last = qrnn_pool_fwd_train(y, c0)
        ctx.save_for_backward(y, c, c0)
        return h, c_last

    @staticmethod
    def backward(ctx, dh, dc_last):
        y, c, c0 = ctx.saved_tensors
        dy, dc0 = qrnn_pool_bwd(y, c, dh.contiguous(), dc_last.contiguous(),
                                c0)
        return dy, dc0


def qrnn_pool(y, c0=None):
    """Window-2 QRNN pooling: y [B, T, 3H] (+ optional c0 [B, H]) ->
    (h [B, T, H], c_T [B, H]). Same contract as ``ops.qrnn.qrnn_pool``;
    differentiable through ``QRNNPool`` when grad mode is on and y or c0
    requires a gradient."""
    if torch.is_grad_enabled() and (y.requires_grad or (
            c0 is not None and c0.requires_grad)):
        return QRNNPool.apply(y, c0)
    return qrnn_pool_fwd(y, c0)
