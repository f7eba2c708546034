"""QRNN pooling through the hand-written CUDA kernels (csrc/qrnn_pool.cu).

The kernels replace the TPU kernels of ``pase_tpu/ops/pallas_qrnn.py``:
the linear scan and the gate math around it (forward), and the
reverse-time scan of its custom VJP (backward). They are built with
``nvcc`` for ``sm_90a`` into one shared library with plain C entry points
at first use, cached under ``build/pase_tpu_torch/`` by a hash of the
source, and loaded with ``ctypes``.

Entry points, each with a launch count in ``LAUNCHES``:
  qrnn_pool_fwd        ``qrnn_pool`` without a gradient (serving, eval);
  qrnn_pool_fwd_train  the forward of ``QRNNPool``: also stores every c_t;
  qrnn_pool_bwd        the backward of ``QRNNPool``.

``qrnn_pool(y, c0=None)`` goes through the ``QRNNPool`` autograd Function
when a gradient is needed, and through the serving forward otherwise. A
tensor on the CPU takes the plain PyTorch versions (``ops/qrnn.py``). For
a CUDA tensor every wrapper launches its kernel or raises: a missing
``nvcc``, a failed build and a refused launch all raise.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

from pase_tpu_torch.ops import qrnn as _plain

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "qrnn_pool.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "pase_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# kernel launches per entry point since import (or since reset_launches)
LAUNCHES = {"qrnn_pool_fwd": 0, "qrnn_pool_fwd_train": 0,
            "qrnn_pool_bwd": 0}
_LIB = None

_P = ctypes.c_void_p
_N = ctypes.c_longlong
_ARGTYPES = {
    # (y, c0, h, c_T, B, T, H, stream)
    "qrnn_pool_fwd": [_P, _P, _P, _P, _N, _N, _N, _P],
    # (y, c0, h, c, c_T, B, T, H, stream)
    "qrnn_pool_fwd_train": [_P, _P, _P, _P, _P, _N, _N, _N, _P],
    # (y, c, dh, dc_T, c0, dy, dc0, B, T, H, stream)
    "qrnn_pool_bwd": [_P, _P, _P, _P, _P, _P, _P, _N, _N, _N, _P],
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        nvcc = cand if os.path.isfile(cand) else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the QRNN CUDA kernels cannot be built")
    return nvcc


def library_path():
    """Where the built library for the current source lives."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libqrnn_pool_{digest}.so")


def build(verbose=False):
    """Compile the kernels if their library is not built yet, load it, and
    return the ``ctypes`` handle. Raises on any failure."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so = library_path()
    if not os.path.isfile(so):
        nvcc = _find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        # compile to a private name, then rename: a concurrent process never
        # loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, SOURCE]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        if verbose:
            print(" ".join(cmd))
            print((proc.stdout + proc.stderr).strip())
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    _LIB = lib
    return lib


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
    lib = build()
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def qrnn_pool_fwd(y, c0=None):
    """Serving forward: y [B, T, 3H] (+ c0 [B, H]) -> (h [B, T, H],
    c_T [B, H]). No gradient."""
    if _cuda_or_plain(y):
        return _plain.qrnn_pool(y, c0)
    _check(y, c0)
    bsz, t, h3 = y.shape
    h = torch.empty((bsz, t, h3 // 3), dtype=y.dtype, device=y.device)
    c_last = torch.empty((bsz, h3 // 3), dtype=y.dtype, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        _launch("qrnn_pool_fwd", y.data_ptr(), _ptr(c0), h.data_ptr(),
                c_last.data_ptr(), bsz, t, h3 // 3, stream)
    return h, c_last


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
