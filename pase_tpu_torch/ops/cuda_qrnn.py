"""QRNN pooling through the hand-written CUDA kernel (csrc/qrnn_pool.cu).

The kernel replaces the TPU kernels of ``pase_tpu/ops/pallas_qrnn.py``
(the linear scan and the gate math around it, forward only). It is built
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C entry
point at first use, cached under ``build/pase_tpu_torch/`` by a hash of
the source, and loaded with ``ctypes``.

``qrnn_pool(y, c0=None)`` takes the plain PyTorch version
(``ops/qrnn.py``) for a tensor on the CPU. For a CUDA tensor it launches
the kernel or raises: a missing ``nvcc``, a failed build and a refused
launch all raise. The backward kernel comes with the training slice, so a
CUDA call that would need a gradient raises too.
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

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0
_LIB = None


def _find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        nvcc = cand if os.path.isfile(cand) else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the QRNN CUDA kernel cannot be built")
    return nvcc


def library_path():
    """Where the built library for the current source lives."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libqrnn_pool_{digest}.so")


def build(verbose=False):
    """Compile the kernel if its library is not built yet, load it, and
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
    lib.qrnn_pool_fwd.restype = ctypes.c_int
    lib.qrnn_pool_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p]
    _LIB = lib
    return lib


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
    if c0 is not None:
        if c0.device != y.device or c0.dtype != torch.float32:
            raise TypeError("c0 must be float32 on y's device")
        if tuple(c0.shape) != (bsz, h3 // 3):
            raise ValueError(f"c0 must be [{bsz}, {h3 // 3}], "
                             f"got {tuple(c0.shape)}")
        if not c0.is_contiguous():
            raise ValueError("c0 must be contiguous")


def qrnn_pool(y, c0=None):
    """Window-2 QRNN pooling: y [B, T, 3H] (+ optional c0 [B, H]) ->
    (h [B, T, H], c_T [B, H]). Same contract as ``ops.qrnn.qrnn_pool``."""
    global LAUNCHES
    if y.device.type == "cpu":
        return _plain.qrnn_pool(y, c0)
    if y.device.type != "cuda":
        raise ValueError(f"qrnn_pool: no kernel for device {y.device}")
    if torch.is_grad_enabled() and (y.requires_grad or (
            c0 is not None and c0.requires_grad)):
        raise NotImplementedError(
            "qrnn_pool CUDA kernel is forward-only: the backward kernel "
            "comes with the training slice (ROADMAP.md, queue 1: encoder "
            "backward)")
    _check(y, c0)
    bsz, t, h3 = y.shape
    hid = h3 // 3
    lib = build()
    h = torch.empty((bsz, t, hid), dtype=y.dtype, device=y.device)
    c_last = torch.empty((bsz, hid), dtype=y.dtype, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.qrnn_pool_fwd(
            y.data_ptr(), None if c0 is None else c0.data_ptr(),
            h.data_ptr(), c_last.data_ptr(), bsz, t, hid, stream)
    if err != 0:
        raise RuntimeError(f"qrnn_pool_fwd launch failed: cudaError {err}")
    LAUNCHES += 1
    return h, c_last
