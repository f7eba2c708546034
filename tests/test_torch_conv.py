"""The port's stride-1 conv (pase_tpu_torch.ops.conv: the plain version of
the CUDA kernels of csrc/conv_s1_tc.cu, the space-to-depth reform of
strided layers, the float32 route's TF32 split and its 3xTF32 arithmetic,
and the kernels' read plan) against the TPU kernel it replaces, K4 of
experiments/pallas_conv_proto.py, and against pase_tpu.nn.conv1d, on the
CPU.

K4 is loaded without running the prototype's module-level benchmark: only
its FunctionDefs ``_kernel``, ``conv_s1_pallas`` and ``conv_pallas`` are
executed, in a namespace whose ``pl.pallas_call`` runs in interpret mode.

Cases: the prototype's seven trunk layers at B=2, channels / 16 and
T / 100, with K and the strides kept (K=20 s=10 and K=11 s=2 pad the
weights to ceil(K/s)*s taps). Bounds: float32 within 1e-5 of the largest
output (float32 sums in another order); bf16 inputs within 2^-7 of the
largest output (one bf16 rounding of differently ordered float32 sums)."""

import ast
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pase_tpu.nn import conv1d as jax_conv1d
from pase_tpu_torch import conv_proto
from pase_tpu_torch.ops import conv
from torch_port_common import rel_err
from torch_port_common import port_test_guard  # noqa: F401

PROTO = "experiments/pallas_conv_proto.py"
LAYERS = [(t // 100, k, s, cin // 16, cout // 16)
          for t, k, s, cin, cout in conv_proto.LAYERS]
REL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


@pytest.fixture(scope="module")
def k4():
    """The prototype's conv_s1_pallas and conv_pallas, pallas_call in
    interpret mode."""
    with open(PROTO) as f:
        tree = ast.parse(f.read())
    keep = {"_kernel", "conv_s1_pallas", "conv_pallas"}
    defs = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in keep]
    assert {n.name for n in defs} == keep
    ns = {"jax": jax, "jnp": jnp, "functools": functools, "pltpu": pltpu,
          "pl": types.SimpleNamespace(
              pallas_call=functools.partial(pl.pallas_call, interpret=True),
              BlockSpec=pl.BlockSpec)}
    exec(compile(ast.Module(body=defs, type_ignores=[]), PROTO, "exec"), ns)
    return ns


def _inputs(layer, dtype, seed=0):
    t, k, s, cin, cout = layer
    rng = np.random.RandomState(seed)
    x = rng.randn(2, t + k - 1, cin).astype(np.float32)
    w = (rng.randn(k, cin, cout) * 0.05).astype(np.float32)
    if dtype == "bfloat16":
        # round x to bf16 once, so both sides see the same values
        x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(
            jnp.float32))
    return x, w


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", LAYERS, ids=lambda l: "k{1}s{2}c{3}".format(
    *l))
def test_conv_strided_matches_k4_and_conv1d(k4, layer, dtype):
    t, k, s, cin, cout = layer
    x, w = _inputs(layer, dtype)
    jdt = getattr(jnp, dtype)
    want_k4 = np.asarray(k4["conv_pallas"](jnp.asarray(x).astype(jdt),
                                           jnp.asarray(w), stride=s)
                         .astype(jnp.float32))
    want_lax = np.asarray(jax_conv1d(jnp.asarray(x).astype(jdt),
                                     jnp.asarray(w), stride=s)
                          .astype(jnp.float32))
    got = conv.conv_strided(_torch(x, dtype), torch.from_numpy(w), s)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    tout = (t + k - 1 - k) // s + 1
    assert got.shape == want_k4.shape == want_lax.shape == (2, tout, cout)
    assert rel_err(got, want_k4) <= REL[dtype], rel_err(got, want_k4)
    assert rel_err(got, want_lax) <= REL[dtype], rel_err(got, want_lax)


@pytest.mark.parametrize("k", [1, 3, 11])
def test_conv_s1_plain_matches_k4(k4, k):
    """The stride-1 plain version alone, at a few tap counts."""
    x, w = _inputs((37, k, 1, 5, 6), "float32", seed=k)
    want = np.asarray(k4["conv_s1_pallas"](jnp.asarray(x), jnp.asarray(w)))
    got = conv.conv_s1_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (2, 37, 6)
    assert rel_err(got.numpy(), want) <= REL["float32"]


def test_space_to_depth_shapes():
    """K=20 s=10 folds to 2 taps of 10 C; K=11 s=2 pads to 12 taps, 6 of
    2 C; the reform of a stride-1 layer is the layer."""
    x = torch.zeros(2, 339, 4)
    xs, ws, tout = conv.space_to_depth(x, torch.zeros(20, 4, 3), 10)
    assert tuple(xs.shape) == (2, 33, 40) and tuple(ws.shape) == (2, 40, 3)
    assert tout == 32
    xs, ws, tout = conv.space_to_depth(x, torch.zeros(11, 4, 3), 2)
    assert tuple(ws.shape) == (6, 8, 3) and tout == 165
    assert (ws[-1, 4:] == 0).all()
    xs, ws, tout = conv.space_to_depth(x, torch.zeros(11, 4, 3), 1)
    assert xs is x and tout == 329


def test_conv_s1_plain_casts_w_to_x_type():
    x = torch.randn(1, 20, 3).to(torch.bfloat16)
    w = torch.randn(4, 3, 2)
    y = conv.conv_s1_plain(x, w)
    assert y.dtype == torch.bfloat16
    want = conv.conv_s1_plain(x.float(), w.to(torch.bfloat16).float())
    assert torch.equal(y, want.to(torch.bfloat16))


def test_cpu_tensors_launch_nothing():
    before = dict(conv.LAUNCHES)
    conv.conv_strided(torch.randn(2, 40, 3), torch.randn(5, 3, 4), 2)
    assert conv.LAUNCHES == before


def test_conv_proto_bound_and_inputs():
    """conv_proto's bound at the full B=96 layers: bf16, the 393 MB first
    layer is bound by bytes and the rest by operations; 521 GFLOP in all.
    Its inputs at a small size on the CPU run through the plain path."""
    flops = sum(2 * conv_proto.B * (t // s) * k * cin * cout
                for t, k, s, cin, cout in conv_proto.LAYERS)
    assert flops == pytest.approx(521e9, rel=2e-3)
    x = torch.empty((conv_proto.B, 32019, 64), dtype=torch.bfloat16,
                    device="meta")
    ms, by = conv_proto.bound(conv_proto.LAYERS[0], x)
    assert by == "bytes" and ms == pytest.approx(
        (x.numel() * 2 + 20 * 64 * 64 * 4 + 96 * 3200 * 64 * 2) / 3.35e9)
    x = torch.empty((conv_proto.B, 410, 512), dtype=torch.bfloat16,
                    device="meta")
    assert conv_proto.bound(conv_proto.LAYERS[-1], x)[1] == "operations"
    inputs = conv_proto.make_inputs(torch.float32, "cpu", layers=LAYERS[:2],
                                    batch=2)
    ys = conv_proto.forward(inputs)
    assert [tuple(y.shape) for y in ys] == [(2, 32, 4), (2, 16, 8)]


# --- the bf16 route's plan (conv_s1_tc's tensor maps and tiles), which the
# CPU reaches although the kernel runs only on the card


def _bf16(*shape):
    return torch.randn(*shape).to(torch.bfloat16)


def test_route_by_dtype():
    assert conv.route(torch.zeros(1, dtype=torch.float32)) == \
        "conv_s1_tf32x3"
    assert conv.route(torch.zeros(1, dtype=torch.bfloat16)) == "conv_s1_tc"
    for dt in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(TypeError):
            conv.route(torch.zeros(1, dtype=dt))


@pytest.mark.parametrize("c,o,c_dim,o_dim,bn", [
    (5, 3, 8, 8, 64), (48, 70, 48, 72, 128), (640, 64, 640, 64, 64),
    (1024, 512, 1024, 512, 128)])
def test_tc_plan_pads_only_ragged_channels(c, o, c_dim, o_dim, bn):
    """C goes to a multiple of 8 (TMA's 16-byte rows of x) through a copy
    of x, O likewise through a copy of w (its rows); y is never padded
    (stored by threads). A float32 w is copied to bf16 in any case."""
    x = _bf16(3, 40, c)
    plan = conv.tc_plan(x, torch.zeros(4, c, o, dtype=torch.bfloat16))
    assert plan["c_dim"] == c_dim and plan["o_dim"] == o_dim
    assert plan["bn"] == bn
    assert plan["copy"] == (c_dim != c)
    assert plan["w_copy"] == (o_dim != o)
    assert plan["row_bytes"] == 2 * c_dim
    assert plan["slabs"] == 1
    assert plan["tiles"] == -(-plan["rows_out"] // conv.TC_BM) * -(-o // bn)
    assert conv.tc_plan(x, torch.zeros(4, c, o))["w_copy"]


def test_tc_plan_takes_the_l1_view_as_is():
    """L1 (K=20, s=10) folds x [B, 32019, 64] to a strided view [B, 3201,
    640]: the tensor map reads it in place, a slab per batch row."""
    x = torch.empty((2, 32019, 64), dtype=torch.bfloat16)
    xs, ws, tout = conv.space_to_depth(x, torch.zeros(20, 64, 64), 10)
    assert xs.data_ptr() == x.data_ptr() and not xs.is_contiguous()
    plan = conv.tc_plan(xs, ws)
    assert not plan["copy"]
    assert (plan["c_dim"], plan["rows"], plan["slabs"]) == (640, 3201, 2)
    assert plan["row_bytes"] == 640 * 2
    assert plan["slab_bytes"] == 32019 * 64 * 2
    assert plan["rows_out"] == plan["tout"] == tout == 3200
    assert plan["bn"] == 64 and plan["tiles"] == 13 * 2


def test_tc_plan_flattens_contiguous_batches():
    """L7 (400 steps, K=11, s=2, 512 -> 512) folds to x [B, 205, 1024]:
    one slab of B * 205 rows, 5 dropped per batch row, not 56 of 256."""
    x = torch.empty((96, 410, 512), dtype=torch.bfloat16, device="meta")
    xs, ws, tout = conv.space_to_depth(x, torch.zeros(11, 512, 512,
                                                      device="meta"), 2)
    plan = conv.tc_plan(xs, ws)
    assert not plan["copy"] and plan["slabs"] == 1
    assert plan["rows"] == 96 * 205 and plan["tout"] == tout == 200
    assert plan["rows_out"] == 95 * 205 + 200
    assert plan["slab_bytes"] == 96 * 205 * 1024 * 2
    assert plan["tiles"] == 77 * 4


def test_tc_plan_copies_what_tma_cannot_take():
    x = _bf16(2, 30, 16)
    assert not conv.tc_plan(x, torch.zeros(3, 16, 8))["copy"]
    # channels not contiguous; a base 2 bytes past 16-byte alignment; rows
    # 26 channels (52 bytes) apart
    for bad in (_bf16(2, 8, 30).transpose(1, 2), x[:, :, 1:9],
                _bf16(2, 30, 26)[:, :, :8]):
        plan = conv.tc_plan(bad, torch.zeros(3, 8, 8))
        assert plan["copy"], bad.stride()
        assert plan["row_bytes"] == 16 and plan["slabs"] == 1


def test_tc_plan_refuses_what_the_map_cannot_hold():
    big = torch.empty((70000, 40000, 8), dtype=torch.bfloat16,
                      device="meta")
    with pytest.raises(ValueError):
        conv.tc_plan(big, torch.zeros(3, 8, 8, device="meta"))
    many = torch.empty((2 ** 20, 2 ** 21, 8), dtype=torch.bfloat16,
                       device="meta")[:, :2 ** 20]
    with pytest.raises(ValueError):   # 2^20 slabs of 2^12 tiles
        conv.tc_plan(many, torch.zeros(1, 8, 8, device="meta"))


def _emulate_tc(x, w):
    """The tensor-core kernels' work from their plan alone, in float32 on
    the CPU: the tensor map as a strided view of x's storage, zeros past
    its rows, the taps summed over the grid's rows (bf16: products of bf16
    values; float32: the three TF32 products), and the epilogue's row ->
    (b, t) mapping and masks. Returns float32 y."""
    plan = conv.tc_plan(x, w)
    if plan["copy"]:
        x = torch.nn.functional.pad(
            x, (0, plan["c_dim"] - x.shape[2])).contiguous()
        plan = conv.tc_plan(x, w)
    b, tin, _ = x.shape
    k, c, o = w.shape
    cd, rows, slabs = plan["c_dim"], plan["rows"], plan["slabs"]
    es = x.element_size()
    tmap = torch.as_strided(x, (slabs, rows, cd), (
        plan["slab_bytes"] // es, plan["row_bytes"] // es, 1),
        x.storage_offset()).float()
    m = plan["tiles"] // slabs // -(-o // plan["bn"]) * plan["bm"]
    assert m >= plan["rows_out"]
    a = torch.cat([tmap, torch.zeros(slabs, m + k, cd)], 1)
    wt = torch.nn.functional.pad(
        w.to(x.dtype).float().permute(0, 2, 1), (0, cd - c))
    if x.dtype == torch.float32:
        (ah, al), (wh, wl) = conv.split_tf32(a), conv.split_tf32(wt)
        acc = sum(al[:, j:j + m] @ wh[j].T + ah[:, j:j + m] @ wl[j].T
                  + ah[:, j:j + m] @ wh[j].T for j in range(k))
    else:
        acc = sum(a[:, j:j + m] @ wt[j].T for j in range(k))
    r = torch.arange(m)
    keep = (r < plan["rows_out"]) & (r % tin < plan["tout"])
    y = torch.full((b, plan["tout"], o), float("nan"))
    for s in range(slabs):
        y[s + r[keep] // tin, r[keep] % tin] = acc[s, keep]
    assert not torch.isnan(y).any()
    return y


@pytest.mark.parametrize("layer", [(160, 20, 10, 64, 64), (37, 11, 1, 48, 70),
                                   (200, 11, 2, 128, 256), (9, 3, 1, 5, 3),
                                   (50, 1, 1, 24, 40)],
                         ids=lambda l: "T{0}k{1}s{2}c{3}o{4}".format(*l))
def test_tc_plan_emulated_matches_plain(layer):
    """The plan's maps, grid and epilogue cover every output once and
    nothing else, on the card's test layers: the L1 fold (a strided view),
    ragged t / C / O, a flattened batch, K=1."""
    t, k, s, cin, cout = layer
    rng = np.random.RandomState(sum(layer))
    x = torch.from_numpy(rng.randn(3, t + k - 1, cin).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.randn(k, cin, cout) * 0.05).astype(
        np.float32))
    xs, ws, tout = conv.space_to_depth(x, w, s)
    got = _emulate_tc(xs, ws)[:, :tout]
    want = conv.conv_s1_plain(xs.float(), ws.to(torch.bfloat16).float())
    assert got.shape == want[:, :tout].shape
    assert rel_err(got.numpy(), want[:, :tout].numpy()) <= REL["float32"]


@pytest.mark.parametrize("layer", [(160, 20, 10, 64, 64), (37, 11, 1, 48, 70),
                                   (200, 11, 2, 128, 256), (9, 3, 1, 5, 3),
                                   (50, 1, 1, 24, 40)],
                         ids=lambda l: "T{0}k{1}s{2}c{3}o{4}".format(*l))
def test_tc_plan_emulated_matches_plain_float32(layer):
    """The float32 route's plan (C to a multiple of 4, 128-row tiles at
    bn 128) with its 3xTF32 products covers every output once, within
    1e-5 of the plain version, on the card's test layers."""
    t, k, s, cin, cout = layer
    rng = np.random.RandomState(sum(layer) + 1)
    x = torch.from_numpy(rng.randn(3, t + k - 1, cin).astype(np.float32))
    w = torch.from_numpy((rng.randn(k, cin, cout) * 0.05).astype(
        np.float32))
    xs, ws, tout = conv.space_to_depth(x, w, s)
    got = _emulate_tc(xs, ws)[:, :tout]
    want = conv.conv_s1_plain(xs, ws)[:, :tout]
    assert got.shape == want.shape
    assert rel_err(got.numpy(), want.numpy()) <= REL["float32"]


# --- the float32 route's TF32 split (bit for bit with the kernel's integer
# rounding) and its arithmetic


def _tf32_numpy(v):
    """v rounded to TF32 in float64 arithmetic, independently of the bit
    trick: to the nearest multiple of the TF32 quantum of v's binade (11
    significant bits; 2^-136 below 2^-126), ties to even (np.rint)."""
    v = np.asarray(v, np.float32)
    out = v.astype(np.float64)
    a = np.abs(out)
    fin = np.isfinite(a) & (a > 0)
    e = np.frexp(a[fin])[1]
    q = np.where(a[fin] < 2.0 ** -126, 2.0 ** -136, np.ldexp(1.0, e - 11))
    out[fin] = np.copysign(np.rint(a[fin] / q) * q, out[fin])
    with np.errstate(over="ignore"):
        return out.astype(np.float32)


def _tf32_cases(kind):
    rng = np.random.RandomState(3)
    if kind == "random":
        return (rng.randn(4000) * 10.0 ** rng.randint(-30, 30, 4000)
                ).astype(np.float32)
    if kind == "ties":
        # halfway between two TF32 values: even neighbour below, odd below
        # (rounds up), negative, and one ulp either side of a tie
        base = np.float32([1.0, 1.0 + 2 ** -10, 3.0, 1.5 + 2 ** -10])
        tie = base + np.float32(2 ** -11) * np.exp2(np.floor(np.log2(
            base))).astype(np.float32)
        near = np.concatenate([tie, np.nextafter(tie, 2 * tie),
                               np.nextafter(tie, 0 * tie)])
        return np.concatenate([near, -near]).astype(np.float32)
    if kind == "subnormal":
        small = np.float32([2 ** -149, 3 * 2 ** -149, 2 ** -137,
                            3 * 2 ** -137, 2 ** -136 + 2 ** -149,
                            2 ** -126 - 2 ** -149, 2 ** -126, 0.0])
        return np.concatenate([small, -small]).astype(np.float32)
    # float32's largest rounds up to inf; TF32's largest stays
    top, tf32_top = np.finfo(np.float32).max, (2 - 2.0 ** -10) * 2.0 ** 127
    return np.float32([np.inf, -np.inf, np.nan, top, -top, tf32_top,
                       -tf32_top, 0.0, -0.0])


@pytest.mark.parametrize("kind", ["random", "ties", "subnormal", "special"])
def test_round_tf32_matches_numpy_bit_for_bit(kind):
    v = _tf32_cases(kind)
    got = conv.round_tf32(torch.from_numpy(v)).numpy()
    want = _tf32_numpy(v)
    nan = np.isnan(v)
    assert np.isnan(got[nan]).all()
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))
    assert (got.view(np.uint32)[~nan] & 0x1FFF == 0).all()


def test_split_tf32_parts():
    """hi and lo are TF32 values, v - hi is exact, and hi + lo is within
    2^-22 of v (normal v)."""
    v = _tf32_cases("random")
    v = v[np.abs(v) > 2.0 ** -100]
    hi, lo = conv.split_tf32(torch.from_numpy(v))
    hi, lo = hi.numpy(), lo.numpy()
    np.testing.assert_array_equal(hi, _tf32_numpy(v))
    np.testing.assert_array_equal(
        lo, _tf32_numpy((v.astype(np.float64) - hi).astype(np.float32)))
    err = np.abs(hi.astype(np.float64) + lo - v) / np.abs(v)
    assert err.max() <= 2.0 ** -22, err.max()


@pytest.mark.parametrize("layer", [(160, 20, 10, 64, 64), (37, 11, 1, 48, 70),
                                   (200, 11, 2, 128, 256), (9, 3, 1, 5, 3),
                                   (50, 1, 1, 24, 40)],
                         ids=lambda l: "T{0}k{1}s{2}c{3}o{4}".format(*l))
def test_conv_s1_tf32x3_plain_matches_plain(layer):
    """The three TF32 products hold the float32 conv within 1e-6 of
    max|y| at the ragged layers and the L1 fold: the split's arithmetic.
    (The kernel's own order of sums is checked on the card.)"""
    t, k, s, cin, cout = layer
    rng = np.random.RandomState(sum(layer))
    x = torch.from_numpy(rng.randn(2, t + k - 1, cin).astype(np.float32))
    w = torch.from_numpy((rng.randn(k, cin, cout) * 0.05).astype(
        np.float32))
    xs, ws, tout = conv.space_to_depth(x, w, s)
    got = conv.conv_s1_tf32x3_plain(xs, ws)[:, :tout]
    want = conv.conv_s1_plain(xs, ws)[:, :tout]
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), want.numpy()) <= 1e-6


@pytest.mark.parametrize("c,c_dim", [(4, 4), (5, 8), (640, 640), (30, 32)])
def test_tc_plan_float32_pads_c_to_four(c, c_dim):
    """float32 rows are 16 bytes at 4 channels: C a multiple of 4 goes in
    as it lies, else a copy pads it; w always goes through the kernel's
    split (w_copy), O unpadded; 128-row tiles at bn 128."""
    x = torch.randn(3, 40, c)
    for o, bn, bm in ((8, 64, 256), (70, 128, 128)):
        plan = conv.tc_plan(x, torch.zeros(4, c, o))
        assert plan["c_dim"] == c_dim and plan["copy"] == (c_dim != c)
        assert plan["row_bytes"] == 4 * c_dim
        assert plan["w_copy"] and plan["o_dim"] == o
        assert (plan["bn"], plan["bm"]) == (bn, bm)
        assert plan["tiles"] == -(-plan["rows_out"] // bm) * -(-o // bn)


def test_tc_plan_float32_takes_the_l1_view_as_is():
    """L1's space-to-depth view of float32 x [B, 32019, 64] goes in
    without a copy: a slab per batch row, 32019 * 64 * 4 bytes apart."""
    x = torch.empty((2, 32019, 64))
    xs, ws, tout = conv.space_to_depth(x, torch.zeros(20, 64, 64), 10)
    assert xs.data_ptr() == x.data_ptr() and not xs.is_contiguous()
    plan = conv.tc_plan(xs, ws)
    assert not plan["copy"]
    assert (plan["c_dim"], plan["rows"], plan["slabs"]) == (640, 3201, 2)
    assert plan["row_bytes"] == 640 * 4
    assert plan["slab_bytes"] == 32019 * 64 * 4
    assert plan["rows_out"] == plan["tout"] == tout == 3200
    # a ragged C of a strided view is copied
    bad = torch.empty((2, 50, 7))[:, :, :6]
    assert conv.tc_plan(bad, torch.zeros(3, 6, 4))["copy"]
