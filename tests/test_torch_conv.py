"""The port's stride-1 conv (pase_tpu_torch.ops.conv: the plain version of
the CUDA kernel csrc/conv_s1.cu, and the space-to-depth reform of strided
layers) against the TPU kernel it replaces, K4 of
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

PROTO = "experiments/pallas_conv_proto.py"
LAYERS = [(t // 100, k, s, cin // 16, cout // 16)
          for t, k, s, cin, cout in conv_proto.LAYERS]
REL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
