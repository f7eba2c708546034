"""VALID 1-D convolution in the JAX layout through hand-written CUDA
kernels on the tensor cores, one per input type.

Both replace the TPU kernel of ``experiments/pallas_conv_proto.py``
(``_kernel`` / ``conv_s1_pallas``, K4): a stride-1 convolution of
x [B, Tin, C] with w [K, C, O] into y [B, Tin - K + 1, O], summed in
float32, y in x's type (w is cast to it). The route is chosen by x's type
alone (``ROUTES``); both are entry points of ``csrc/conv_s1_tc.cu``, an
implicit GEMM with TMA loads and wgmma products:
  conv_s1_tf32x3  float32: x and w each split into a high and a low TF32
                  part (``split_tf32``), three TF32 products summed in
                  float32 (``conv_s1_tf32x3_plain`` repeats the split);
                  within 1e-5 of max|y_plain|, which TF32 alone would
                  miss. w's parts go in as [2K, O, C], written by a small
                  kernel of the same entry point on every call;
  conv_s1_tc      bfloat16 products; within 2^-7 of max|y_plain|.
Both read x in place through a tensor map with x's own strides
(``tc_plan``), so the strided space-to-depth view of a folded layer goes
in without a copy.
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

SOURCE = cuda_build.source_path("conv_s1_tc")
BUILD_DIR = cuda_build.BUILD_DIR
ROUTES = {torch.float32: "conv_s1_tf32x3", torch.bfloat16: "conv_s1_tc"}
_INT32 = 2 ** 31 - 1
# output rows per tile (128 in float32 at bn 128); TMA coordinates are
# 32-bit signed and a block reads up to TC_BM + 15 rows past its first
TC_BM = 256
_TC_MAX_ROWS = 2 ** 31 - 2 * TC_BM
# the w-splitting kernel's grid: taps and O / 32 in its z and y dimensions
_GRID_YZ = 65535

# kernel launches since import (or since reset_launches)
LAUNCHES = {"conv_s1_tf32x3": 0, "conv_s1_tc": 0}
_LIB = None
_P, _N = cuda_build.PTR, cuda_build.SIZE
_ARGTYPES = {
    # (x, c_dim, rows, slabs, row_bytes, slab_bytes, w, C, w_row_bytes, y,
    #  Tin, Tout, K, O, rows_out, bn, stream)
    "conv_s1_tc": [_P, _N, _N, _N, _N, _N, _P, _N, _N, _P, _N, _N, _N, _N,
                   _N, cuda_build.INT, _P],
    # (x, c_dim, rows, slabs, row_bytes, slab_bytes, w, C, ws, y, Tin,
    #  Tout, K, O, rows_out, bn, stream)
    "conv_s1_tf32x3": [_P, _N, _N, _N, _N, _N, _P, _N, _P, _P, _N, _N, _N,
                       _N, _N, cuda_build.INT, _P],
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library_path():
    return cuda_build.library_path(SOURCE, BUILD_DIR)


def build(verbose=False):
    """Compile the kernels if their library is not built yet, load it, and
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


def round_tf32(v):
    """float32 v rounded to TF32 (10 mantissa bits; the 13 below them
    zero), to nearest, ties to even, by integer operations on its bits as
    the kernel's tf32_rne does; inf and nan pass unchanged."""
    u = v.contiguous().view(torch.int32)
    r = (u + 0xFFF + ((u >> 13) & 1)) & ~0x1FFF
    special = (u & 0x7F800000) == 0x7F800000
    return torch.where(special, u, r).view(torch.float32)


def split_tf32(v):
    """(hi, lo) of float32 v: hi = tf32(v), lo = tf32(v - hi), the split
    of ``conv_s1_tf32x3``, bit for bit. v - hi is exact, and hi + lo is
    within about 2^-22 of v."""
    hi = round_tf32(v)
    return hi, round_tf32(v - hi)


def conv_s1_tf32x3_plain(x, w):
    """``conv_s1_tf32x3``'s arithmetic in plain float32: per tap, x_lo w_hi
    + x_hi w_lo + x_hi w_hi of the TF32 parts (x_lo w_lo is dropped).
    x, w float32; returns float32 y. Only the order of the sums differs
    from the kernel's."""
    k = w.shape[0]
    tout = x.shape[1] - k + 1
    xh, xl = split_tf32(x.float())
    wh, wl = split_tf32(w.float())
    acc = 0
    for j in range(k):
        xhj, xlj = xh[:, j:j + tout], xl[:, j:j + tout]
        acc = acc + xlj @ wh[j] + xhj @ wl[j] + xhj @ wh[j]
    return acc


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
    """How the kernel of x's type reads x [B, Tin, C] (bf16 or float32)
    and w [K, C, O].

    TMA takes x as it lies when its channels are contiguous and fill whole
    16-byte units (C a multiple of 8 in bf16, of 4 in float32), its row
    and batch strides are multiples of 16 bytes and cover the rows below
    them, and it starts on 16 bytes; else ``copy`` is True and the wrapper
    reads a contiguous copy with C zero-padded to ``c_dim`` (the plan's
    strides are then the copy's). When the batch rows lie evenly spaced
    the tensor map has one slab of B * Tin rows and the windows that
    straddle two batch rows are dropped; otherwise a slab per batch row.
    Output row r of slab s is y[s + r // Tin, r % Tin] where r % Tin <
    Tout and r < rows_out.

    bf16: w goes in as it lies ([K, C, O], O contiguous; TMA fills
    channels past C with zeros) when it is bf16, contiguous, 16-byte
    aligned and O is a multiple of 8; else ``w_copy`` is True and the
    wrapper reads a bf16 copy with O zero-padded to ``o_dim``. float32: w
    always goes through the kernel's own split into [2K, O, c_dim]
    (``w_copy`` True, ``o_dim`` = O). y is stored by threads, never
    padded. A tile is ``bm`` output rows (TC_BM; 128 in float32 at bn
    128, where the kernel keeps two sets of sums) by ``bn`` output
    channels; ``tiles`` is their number, over all slabs (the kernel's
    blocks walk them)."""
    b, tin, c = x.shape
    k, _, o = w.shape
    tout = tin - k + 1
    esize = x.element_size()
    unit = 16 // esize                  # channels in 16 bytes
    c_dim = -(-c // unit) * unit
    row, slab = x.stride(1), x.stride(0)
    as_is = (c_dim == c and x.stride(2) == 1 and row % unit == 0
             and row >= c
             and (b == 1 or (slab % unit == 0 and slab >= tin * row))
             and x.data_ptr() % 16 == 0)
    if not as_is:
        row, slab = c_dim, tin * c_dim
    if b == 1 or slab == tin * row:
        rows, slabs, rows_out, slab = b * tin, 1, (b - 1) * tin + tout, \
            b * tin * row
    else:
        rows, slabs, rows_out = tin, b, tout
    if x.dtype == torch.float32:
        o_dim, w_copy = o, True
        if k > _GRID_YZ or -(-o // 32) > _GRID_YZ:
            raise ValueError(f"w {tuple(w.shape)} exceeds the w split's "
                             "grid")
    else:
        o_dim = -(-o // 8) * 8
        w_copy = not (w.dtype == torch.bfloat16 and w.is_contiguous()
                      and o_dim == o and w.data_ptr() % 16 == 0)
    bn = 64 if o <= 64 else 128
    bm = TC_BM // 2 if x.dtype == torch.float32 and bn == 128 else TC_BM
    tiles = -(-rows_out // bm) * -(-o // bn) * slabs
    if rows > _TC_MAX_ROWS or tiles > _INT32:
        raise ValueError(f"x {tuple(x.shape)} exceeds the kernel's tensor "
                         f"map ({rows} rows, {tiles} tiles)")
    return {"copy": not as_is, "c_dim": c_dim, "rows": rows, "slabs": slabs,
            "row_bytes": esize * row, "slab_bytes": esize * slab,
            "rows_out": rows_out, "tout": tout, "w_copy": w_copy,
            "o_dim": o_dim, "bn": bn, "bm": bm, "tiles": tiles}


def _conv_s1_tc(name, x, w):
    plan = tc_plan(x, w)
    if plan["copy"]:
        x = F.pad(x, (0, plan["c_dim"] - x.shape[2])).contiguous()
        plan = tc_plan(x, w)
    b, tin, _ = x.shape
    k, c, o = w.shape
    if name == "conv_s1_tf32x3":
        w = w.to(torch.float32).contiguous()
        # scratch for w's TF32 parts, written by the kernel's split
        ws = torch.empty((2 * k, o, plan["c_dim"]), dtype=torch.float32,
                         device=x.device)
        w_args = (w.data_ptr(), c, ws.data_ptr())
    else:
        if plan["w_copy"]:
            w = w.to(torch.bfloat16)
            w = (F.pad(w, (0, plan["o_dim"] - o)) if plan["o_dim"] != o
                 else w).contiguous()
        w_args = (w.data_ptr(), c, 2 * plan["o_dim"])
    y = torch.empty((b, plan["tout"], o), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        cuda_build.launch(
            build(), name, LAUNCHES, x.data_ptr(), plan["c_dim"],
            plan["rows"], plan["slabs"], plan["row_bytes"],
            plan["slab_bytes"], *w_args, y.data_ptr(), tin, plan["tout"], k,
            o, plan["rows_out"], plan["bn"], stream)
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
    return _conv_s1_tc(name, x, w)


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
