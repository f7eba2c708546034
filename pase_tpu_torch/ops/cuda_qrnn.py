"""QRNN pooling through the hand-written CUDA kernels (csrc/qrnn_pool.cu).

The kernels replace the TPU kernels of ``pase_tpu/ops/pallas_qrnn.py``:
the linear scan and the gate math around it (forward), and the
reverse-time scan of its custom VJP (backward). They are built with
``nvcc`` for ``sm_90a`` into one shared library with plain C entry points
at first use, cached under ``build/pase_tpu_torch/`` by a hash of the
source, and loaded with ``ctypes`` (``ops/cuda_build.py``).

Entry points, each with a launch count in ``LAUNCHES``:
  qrnn_pool_fwd_chunked ``qrnn_pool`` without a gradient and without c0,
                        on fewer than CHUNKED_LANES lanes (B * H; serving):
                        the time axis in chunks, their carries composed in
                        the block, so few lanes fill the card; within 1e-5
                        of the plain version;
  qrnn_pool_fwd_seg     ``qrnn_pool`` without a gradient, seeded with c0,
                        on fewer than SEG_LANES lanes (a streaming push):
                        the gates of a segment of steps computed by every
                        thread of a block, then one serial FMA chain per
                        lane seeded with c0, so a block-streamed run (c_T
                        threaded into the next block's c0) equals one full
                        run bit for bit;
  qrnn_pool_fwd         the same function on the other calls (many lanes:
                        eval at batch), one thread a lane, with the same
                        bits as qrnn_pool_fwd_seg;
  qrnn_pool_fwd_train   the forward of ``QRNNPool``: also stores every c_t;
  qrnn_pool_bwd         the backward of ``QRNNPool``.

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
program calls the kernels. The route between the three forward kernels
is taken inside the CUDA implementation, from the shapes of the call, so
one exported program takes each route at the batch sizes that call for
it. Importing this module registers the operator; a process that
loads an exported program needs nothing else of the package.
"""

import torch

from pase_tpu_torch.ops import cuda_build
from pase_tpu_torch.ops import qrnn as _plain

SOURCE = cuda_build.source_path("qrnn_pool")
BUILD_DIR = cuda_build.BUILD_DIR

# kernel launches per entry point since import (or since reset_launches)
LAUNCHES = {"qrnn_pool_fwd_chunked": 0, "qrnn_pool_fwd_seg": 0,
            "qrnn_pool_fwd": 0, "qrnn_pool_fwd_train": 0,
            "qrnn_pool_bwd": 0}
_LIB = None
# unseeded calls on fewer lanes take the chunked kernel. On the H100 the
# chunked kernel took 0.0356 ms at [24,200,512] (12288 lanes) against the
# serial kernel's 0.0489, but 0.0682 at [48,200,512] (24576 lanes) against
# 0.0578 and 0.1313 at [96,200,512] against 0.0715, where the serial kernel
# is bound by bytes (chip_smoke.py phase 3)
CHUNKED_LANES = 16384
# seeded calls on fewer lanes take the segmented kernel, the others the
# one-thread-a-lane loop (the same bits). On the H100, seeded (python -m
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
    "qrnn_pool_fwd_chunked": [_P, _P, _P, _P, _N, _N, _N, _P],
    # (y, c0, h, c, c_T, B, T, H, stream)
    "qrnn_pool_fwd_train": [_P, _P, _P, _P, _P, _N, _N, _N, _P],
    # (y, c, dh, dc_T, c0, dy, dc0, B, T, H, stream)
    "qrnn_pool_bwd": [_P, _P, _P, _P, _P, _P, _P, _N, _N, _N, _P],
    # () -> qrnn_pool_fwd_seg's segment length
    "qrnn_pool_fwd_segment_steps": [],
}


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


# the operator's namespace; its registrations last as long as this object
_OPS = torch.library.Library("pase_tpu_torch", "DEF")
_OPS.define("qrnn_pool_fwd(Tensor y, Tensor? c0) -> (Tensor, Tensor)")


def _qrnn_pool_fwd_cpu(y, c0):
    """The plain version, for CPU tensors (c_T copied: an operator's
    outputs own their memory)."""
    h, c_last = _plain.qrnn_pool(y, c0)
    return h, c_last.clone()


def forward_entry(lanes, seeded):
    """The forward kernel's entry point for a call on ``lanes`` lanes
    (B * H): unseeded on fewer than CHUNKED_LANES the chunked kernel,
    seeded on fewer than SEG_LANES the segmented one, else the
    one-thread-a-lane loop."""
    if not seeded and lanes < CHUNKED_LANES:
        return "qrnn_pool_fwd_chunked"
    if seeded and lanes < SEG_LANES:
        return "qrnn_pool_fwd_seg"
    return "qrnn_pool_fwd"


def _qrnn_pool_fwd_cuda(y, c0):
    """The kernels, routed by this call's shapes (``forward_entry``)."""
    lanes = y.shape[0] * (y.shape[-1] // 3)
    return _forward(forward_entry(lanes, c0 is not None), y, c0)


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


def qrnn_pool_fwd_chunked(y, c0=None):
    """The chunked serving forward: y [B, T, 3H] (+ c0 [B, H]) -> (h,
    c_T), no gradient. On the CPU the chunked plain version
    (``ops.qrnn.qrnn_pool_chunked_plain``)."""
    if _cuda_or_plain(y):
        return _plain.qrnn_pool_chunked_plain(y, c0)
    return _forward("qrnn_pool_fwd_chunked", y, c0)


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
