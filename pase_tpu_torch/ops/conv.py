"""VALID 1-D convolution in the JAX layout through the hand-written CUDA
kernel ``csrc/conv_s1.cu``.

The kernel replaces the TPU kernel of ``experiments/pallas_conv_proto.py``
(``_kernel`` / ``conv_s1_pallas``, K4): a stride-1 convolution of
x [B, Tin, C] with w [K, C, O] into y [B, Tin - K + 1, O], summed in
float32, in float32 or bfloat16 (w cast to x's type, y in x's type).
``conv_strided`` is the prototype's ``conv_pallas``: the exact
space-to-depth reform of a strided convolution into a stride-1 one
(``space_to_depth``), done here in torch outside the kernel.

``conv_s1`` launches the kernel for a CUDA tensor (counted in
``LAUNCHES["conv_s1"]``) or raises; a CPU tensor takes ``conv_s1_plain``.
Neither has a gradient, as the prototype has none. Nothing on the serving
or training path calls them; ``python -m pase_tpu_torch.conv_proto``
drives them at the prototype's trunk shapes.
"""

import torch
import torch.nn.functional as F

from pase_tpu_torch.ops import cuda_build

SOURCE = cuda_build.source_path("conv_s1")
BUILD_DIR = cuda_build.BUILD_DIR
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# grid limit of the kernel's batch and output-channel-tile dimensions
_GRID_YZ = 65535

# kernel launches since import (or since reset_launches)
LAUNCHES = {"conv_s1": 0}
_LIB = None
_P, _N = cuda_build.PTR, cuda_build.SIZE
# (x, w, y, B, Tin, C, K, O, dtype, stream)
_ARGTYPES = {"conv_s1": [_P, _P, _P, _N, _N, _N, _N, _N, cuda_build.INT,
                         _P]}


def reset_launches():
    LAUNCHES["conv_s1"] = 0


def library_path():
    return cuda_build.library_path(SOURCE, BUILD_DIR)


def build(verbose=False):
    """Compile the kernel if its library is not built yet, load it, and
    return the ``ctypes`` handle. Raises on any failure."""
    global _LIB
    if _LIB is None:
        _LIB = cuda_build.load(SOURCE, _ARGTYPES, BUILD_DIR, verbose)
    return _LIB


def conv_s1_plain(x, w):
    """The plain version: the sum over the K taps of
    x[:, j:j + Tout] @ w[j] in float32, cast to x's type."""
    k = w.shape[0]
    tout = x.shape[1] - k + 1
    w = w.to(x.dtype).float()
    acc = x[:, :tout].float() @ w[0]
    for j in range(1, k):
        acc = acc + x[:, j:j + tout].float() @ w[j]
    return acc.to(x.dtype)


def _check(x, w):
    if x.dtype not in DTYPES:
        raise TypeError(f"conv_s1 takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or w.dim() != 3 or w.shape[1] != x.shape[2]:
        raise ValueError(f"x must be [B, Tin, C] and w [K, C, O], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    b, tin, c = x.shape
    k, _, o = w.shape
    if min(b, c, k, o) == 0 or tin < k:
        raise ValueError(f"empty conv: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    if b > _GRID_YZ or -(-o // 64) > _GRID_YZ:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} exceed "
                         "the kernel's grid")
    if w.device != x.device:
        raise ValueError("w must be on x's device")


def conv_s1(x, w):
    """VALID stride-1 conv: x [B, Tin, C], w [K, C, O] -> y [B, Tout, O],
    Tout = Tin - K + 1, in x's type with a float32 sum."""
    if x.device.type == "cpu":
        return conv_s1_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv_s1: no kernel for device {x.device}")
    _check(x, w)
    x = x.contiguous()
    w = w.to(x.dtype).contiguous()
    b, tin, c = x.shape
    k, _, o = w.shape
    y = torch.empty((b, tin - k + 1, o), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        cuda_build.launch(build(), "conv_s1", LAUNCHES, x.data_ptr(),
                          w.data_ptr(), y.data_ptr(), b, tin, c, k, o,
                          DTYPES[x.dtype], stream)
    return y


def space_to_depth(x, w, stride):
    """The exact reform of a VALID conv of stride s into a stride-1 one
    (the prototype's conv_pallas): pad x to whole stride groups and fold
    its time axis by s into the channels ([B, Tin / s, s C]); pad the taps
    to a multiple of s and fold them the same way ([ceil(K / s), s C, O]).
    Returns (xs, ws, tout): the stride-1 conv of xs with ws, cut to its
    first tout = (Tin - K) // s + 1 steps, is the strided conv."""
    k, cin, cout = w.shape
    b, tin, _ = x.shape
    tout = (tin - k) // stride + 1
    if stride == 1:
        return x, w, tout
    kp = -(-k // stride)
    need = (tout - 1 + kp) * stride
    if need > tin:
        x = F.pad(x, (0, 0, 0, need - tin))
    xs = x[:, :need].reshape(b, need // stride, stride * cin)
    ws = F.pad(w, (0, 0, 0, 0, 0, kp * stride - k)).reshape(
        kp, stride * cin, cout)
    return xs, ws, tout


def conv_strided(x, w, stride=1):
    """VALID conv of x [B, Tin, C] with w [K, C, O] at ``stride`` through
    ``conv_s1`` and ``space_to_depth``."""
    xs, ws, tout = space_to_depth(x, w, stride)
    return conv_s1(xs, ws)[:, :tout]
