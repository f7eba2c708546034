"""VALID 1-D convolution in the JAX layout through two hand-written CUDA
kernels, one per input type.

Both replace the TPU kernel of ``experiments/pallas_conv_proto.py``
(``_kernel`` / ``conv_s1_pallas``, K4): a stride-1 convolution of
x [B, Tin, C] with w [K, C, O] into y [B, Tin - K + 1, O], summed in
float32, y in x's type (w is cast to it). The route is chosen by x's type
alone (``ROUTES``):
  conv_s1     float32, on the CUDA cores (``csrc/conv_s1.cu``); the tensor
              cores have no full float32 product;
  conv_s1_tc  bfloat16, an implicit GEMM on the tensor cores: TMA loads,
              wgmma products (``csrc/conv_s1_tc.cu``). It reads x in place
              through a tensor map with x's own strides (``tc_plan``), so
              the strided space-to-depth view of a folded layer goes in
              without a copy.
``conv_strided`` is the prototype's ``conv_pallas``: the exact
space-to-depth reform of a strided convolution into a stride-1 one
(``space_to_depth``), done here in torch outside the kernels.

``conv_s1`` launches its route's kernel for a CUDA tensor (counted in
``LAUNCHES``) or raises; neither route falls back to the other or to the
plain version. A CPU tensor takes ``conv_s1_plain``. None has a gradient,
as the prototype has none. Nothing on the serving or training path calls
them; ``python -m pase_tpu_torch.conv_proto`` drives them at the
prototype's trunk shapes.
"""

import torch
import torch.nn.functional as F

from pase_tpu_torch.ops import cuda_build

SOURCES = {name: cuda_build.source_path(name)
           for name in ("conv_s1", "conv_s1_tc")}
BUILD_DIR = cuda_build.BUILD_DIR
ROUTES = {torch.float32: "conv_s1", torch.bfloat16: "conv_s1_tc"}
# grid limit of conv_s1's batch and output-channel-tile dimensions
_GRID_YZ = 65535
_INT32 = 2 ** 31 - 1
# conv_s1_tc: output rows per block; TMA coordinates are 32-bit signed and
# a block reads up to TC_BM + 15 rows past its first
TC_BM = 256
_TC_MAX_ROWS = 2 ** 31 - 2 * TC_BM

# kernel launches since import (or since reset_launches)
LAUNCHES = {"conv_s1": 0, "conv_s1_tc": 0}
_LIBS = {}
_P, _N = cuda_build.PTR, cuda_build.SIZE
_ARGTYPES = {
    # (x, w, y, B, Tin, C, K, O, stream)
    "conv_s1": [_P, _P, _P, _N, _N, _N, _N, _N, _P],
    # (x, c_dim, rows, slabs, row_bytes, slab_bytes, w, C, w_row_bytes, y,
    #  Tin, Tout, K, O, rows_out, bn, stream)
    "conv_s1_tc": [_P, _N, _N, _N, _N, _N, _P, _N, _N, _P, _N, _N, _N, _N,
                   _N, cuda_build.INT, _P],
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library_path(name):
    return cuda_build.library_path(SOURCES[name], BUILD_DIR)


def build(name, verbose=False):
    """Compile kernel ``name`` if its library is not built yet, load it,
    and return the ``ctypes`` handle. Raises on any failure."""
    if name not in _LIBS:
        _LIBS[name] = cuda_build.load(SOURCES[name], {name: _ARGTYPES[name]},
                                      BUILD_DIR, verbose)
    return _LIBS[name]


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


def route(x):
    """The kernel ``conv_s1`` launches for x's type."""
    if x.dtype not in ROUTES:
        raise TypeError(f"conv_s1 takes float32 or bfloat16, got {x.dtype}")
    return ROUTES[x.dtype]


def _check(x, w):
    if x.dim() != 3 or w.dim() != 3 or w.shape[1] != x.shape[2]:
        raise ValueError(f"x must be [B, Tin, C] and w [K, C, O], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    b, tin, c = x.shape
    k, _, o = w.shape
    if min(b, c, k, o) == 0 or tin < k:
        raise ValueError(f"empty conv: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError("w must be on x's device")


def tc_plan(x, w):
    """How ``conv_s1_tc`` reads bf16 x [B, Tin, C] and w [K, C, O].

    TMA takes x as it lies when its channels are contiguous and a multiple
    of 8, its row and batch strides are multiples of 16 bytes and cover
    the rows below them, and it starts on 16 bytes; else ``copy`` is True
    and the wrapper reads a contiguous copy with C zero-padded to
    ``c_dim``, a multiple of 8 (the plan's strides are then the copy's).
    When the batch rows lie evenly spaced the tensor map has one slab of
    B * Tin rows and the windows that straddle two batch rows are dropped;
    otherwise a slab per batch row. Output row r of slab s is y[s + r //
    Tin, r % Tin] where r % Tin < Tout and r < rows_out.

    w goes in as it lies ([K, C, O], O contiguous; TMA fills channels past
    C with zeros) when it is bf16, contiguous, 16-byte aligned and O is a
    multiple of 8; else ``w_copy`` is True and the wrapper reads a bf16
    copy with O zero-padded to ``o_dim``. y is stored by threads, never
    padded. A tile is TC_BM output rows by ``bn`` output channels;
    ``tiles`` is their number, over all slabs (the kernel's blocks walk
    them)."""
    b, tin, c = x.shape
    k, _, o = w.shape
    tout = tin - k + 1
    c_dim = -(-c // 8) * 8
    row, slab = x.stride(1), x.stride(0)
    as_is = (c_dim == c and x.stride(2) == 1 and row % 8 == 0 and row >= c
             and (b == 1 or (slab % 8 == 0 and slab >= tin * row))
             and x.data_ptr() % 16 == 0)
    if not as_is:
        row, slab = c_dim, tin * c_dim
    if b == 1 or slab == tin * row:
        rows, slabs, rows_out, slab = b * tin, 1, (b - 1) * tin + tout, \
            b * tin * row
    else:
        rows, slabs, rows_out = tin, b, tout
    o_dim = -(-o // 8) * 8
    w_copy = not (w.dtype == torch.bfloat16 and w.is_contiguous()
                  and o_dim == o and w.data_ptr() % 16 == 0)
    bn = 64 if o <= 64 else 128
    tiles = -(-rows_out // TC_BM) * -(-o // bn) * slabs
    if rows > _TC_MAX_ROWS or tiles > _INT32:
        raise ValueError(f"x {tuple(x.shape)} exceeds conv_s1_tc's tensor "
                         f"map ({rows} rows, {tiles} tiles)")
    return {"copy": not as_is, "c_dim": c_dim, "rows": rows, "slabs": slabs,
            "row_bytes": 2 * row, "slab_bytes": 2 * slab,
            "rows_out": rows_out, "tout": tout, "w_copy": w_copy,
            "o_dim": o_dim, "bn": bn, "tiles": tiles}


def _conv_s1_tc(x, w):
    plan = tc_plan(x, w)
    if plan["copy"]:
        x = F.pad(x, (0, plan["c_dim"] - x.shape[2])).contiguous()
        plan = tc_plan(x, w)
    b, tin, _ = x.shape
    k, c, o = w.shape
    if plan["w_copy"]:
        w = w.to(torch.bfloat16)
        w = (F.pad(w, (0, plan["o_dim"] - o)) if plan["o_dim"] != o
             else w).contiguous()
    y = torch.empty((b, plan["tout"], o), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        cuda_build.launch(
            build("conv_s1_tc"), "conv_s1_tc", LAUNCHES, x.data_ptr(),
            plan["c_dim"], plan["rows"], plan["slabs"], plan["row_bytes"],
            plan["slab_bytes"], w.data_ptr(), c, 2 * plan["o_dim"],
            y.data_ptr(), tin, plan["tout"], k, o, plan["rows_out"],
            plan["bn"], stream)
    return y


def conv_s1(x, w):
    """VALID stride-1 conv: x [B, Tin, C], w [K, C, O] -> y [B, Tout, O],
    Tout = Tin - K + 1, in x's type with a float32 sum."""
    if x.device.type == "cpu":
        return conv_s1_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv_s1: no kernel for device {x.device}")
    name = route(x)
    _check(x, w)
    if name == "conv_s1_tc":
        return _conv_s1_tc(x, w)
    b, tin, c = x.shape
    k, _, o = w.shape
    if b > _GRID_YZ or -(-o // 64) > _GRID_YZ:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} exceed "
                         "conv_s1's grid")
    x = x.contiguous()
    w = w.to(x.dtype).contiguous()
    y = torch.empty((b, tin - k + 1, o), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        cuda_build.launch(build("conv_s1"), "conv_s1", LAUNCHES, x.data_ptr(),
                          w.data_ptr(), y.data_ptr(), b, tin, c, k, o,
                          stream)
    return y


def space_to_depth(x, w, stride):
    """The exact reform of a VALID conv of stride s into a stride-1 one
    (the prototype's conv_pallas): pad x to whole stride groups and fold
    its time axis by s into the channels ([B, Tin / s, s C]); pad the taps
    to a multiple of s and fold them the same way ([ceil(K / s), s C, O]).
    Returns (xs, ws, tout): the stride-1 conv of xs with ws, cut to its
    first tout = (Tin - K) // s + 1 steps, is the strided conv. Where x
    holds more steps than the folded layer reads, xs is a strided view of
    x, not a copy."""
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
