"""The port's streaming encoder (pase_tpu_torch.streaming) against the JAX
package's (pase_tpu.streaming) on the same weights and the same chunks, on
the CPU.

Per push, both emit the same number of frames, and the values agree within
1e-5 of the utterance's largest output (float32 convolutions summed in
different orders; the JAX side runs its scan QRNN at 'highest' matmul
precision, tests/conftest.py). The port's streamed output is also held to
its own offline forward with the JAX contract, rtol 1e-3 / atol 2e-4
(tests/test_streaming.py). The narrow encoder has PASE+'s layer kinds and
its 160x frame rate; one case runs PASE+ at full width.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pase_tpu import frontend as jax_frontend
from pase_tpu.streaming import StreamingEncoder as JaxStream
from pase_tpu_torch import frontend, streaming
from pase_tpu_torch.checkpoint import variables_to_state_dict
from torch_port_common import (NARROW_CFG, PASEP_CFG, flat_variables,
                               jax_variables)
from torch_port_common import port_test_guard  # noqa: F401

CFG = dict(NARROW_CFG, strides=[1, 10, 4, 4])
REL = 1e-5


class _JaxEncoder:
    """The (module, variables) pair pase_tpu.streaming takes."""

    def __init__(self, module, variables):
        self.module = module
        self.variables = variables


def _pair(cfg, seed=0):
    module = jax_frontend.build_wavefe(
        dict(jax_frontend.load_cfg(cfg), qrnn_impl="scan"))
    variables = jax_variables(module, 4000, seed=seed)
    port = frontend.build_wavefe(cfg).eval()
    sd = variables_to_state_dict(flat_variables(variables))
    port.load_state_dict(dict(port.state_dict(), **sd), strict=True)
    return _JaxEncoder(module, variables), port


@pytest.fixture(scope="module")
def narrow():
    return _pair(CFG)


def _wav(b, t, seed):
    return (np.random.RandomState(seed).randn(b, t) * 0.1).astype(
        np.float32)


def _emissions(stream, wav, sizes, to_np):
    """Per push (and the flush) the emitted frames as numpy, None where
    the stream emitted nothing."""
    out, i = [], 0
    for n in sizes:
        out.append(to_np(stream.push(wav[:, i:i + n])))
        i += n
    assert i == wav.shape[1]
    out.append(to_np(stream.flush()))
    return out


def _np(y):
    if y is None:
        return None
    return y.numpy() if torch.is_tensor(y) else np.asarray(y)


def _cat(packets):
    return np.concatenate([p for p in packets if p is not None], axis=2)


def _check_against_jax(pair, wav, sizes):
    """Per push, the port's emissions against the JAX stream's; returns
    the port's concatenated frames."""
    jenc, port = pair
    want = _emissions(JaxStream(jenc), jnp.asarray(wav), sizes, _np)
    got = _emissions(streaming.StreamingEncoder(port), wav, sizes, _np)
    scale = np.abs(_cat(want)).max()
    assert [None if p is None else p.shape for p in got] == \
        [None if p is None else p.shape for p in want]
    for g, w in zip(got, want):
        if w is not None:
            assert np.abs(g - w).max() <= REL * scale
    return _cat(got)


def _offline(port, wav):
    with torch.no_grad():
        return port(torch.from_numpy(wav)).transpose(1, 2).numpy()


@pytest.mark.parametrize("t, sizes", [
    (16000, [1000, 777, 13, 5000, 9210]),      # no relation to the strides
    (16000, [16000]),                          # one push
    (16037, [4000, 4000, 4000, 4000, 37]),     # T not a multiple of 160
    (3200, [60, 3140]),                        # first push under the pad
], ids=["uneven", "single", "ragged_total", "short_first"])
def test_stream_matches_jax_and_offline(narrow, t, sizes):
    wav = _wav(2, t, seed=t)
    got = _check_against_jax(narrow, wav, sizes)
    ref = _offline(narrow[1], wav)
    assert got.shape == ref.shape == (2, 8, t // 160)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=2e-4)


def test_dfactor_quirk_at_31991(narrow):
    """T=31991: the offline fuse_skip pools the first skip in groups of
    31991 // 200 = 159 (the reference quirk) and emits 200 frames; the
    stream uses the canonical 160 and emits floor(T / 160) = 199, as the
    JAX stream does. On the frame-aligned truncation the two agree."""
    wav = _wav(2, 31991, seed=5)
    got = _check_against_jax(narrow, wav, [31991])
    assert _offline(narrow[1], wav).shape[2] == 200
    assert got.shape[2] == 199
    aligned = wav[:, :31991 // 160 * 160]
    st = streaming.stream_frames(narrow[1], aligned, aligned.shape[1])
    np.testing.assert_allclose(st.numpy(), _offline(narrow[1], aligned),
                               rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("cut", [60, 9000], ids=["pre_prime", "post_prime"])
def test_state_round_trip(narrow, cut):
    """get_state after a first push (before the sinc block's 125-sample
    left pad is complete, or after every layer primed), set_state into a
    fresh stream, go on: the frames of the uninterrupted stream, bit for
    bit, and within bounds of the JAX stream fed the same chunks."""
    port = narrow[1]
    wav = _wav(2, 16000, seed=9)
    sizes = [cut] + [4000] * ((16000 - cut) // 4000)
    sizes[-1] += 16000 - sum(sizes)
    whole = _emissions(streaming.StreamingEncoder(port), wav, sizes, _np)
    first = streaming.StreamingEncoder(port)
    head = [_np(first.push(wav[:, :cut]))]
    snap = first.get_state()
    assert snap["convs"][0]["started"] is (cut >= 126)
    second = streaming.StreamingEncoder(port)
    second.set_state(snap)
    tail = _emissions(second, wav[:, cut:], sizes[1:], _np)
    assert [p is None for p in head + tail] == [p is None for p in whole]
    np.testing.assert_array_equal(_cat(head + tail), _cat(whole))
    _check_against_jax(narrow, wav, sizes)


def test_every_pooling_call_is_seeded(narrow, monkeypatch):
    """The QRNN's first push is seeded with a zero carry: every pooling
    call of a stream has a c0 (the serial kernel's route on the card),
    one per QRNN layer per push that reaches the QRNN, which the stream
    counts."""
    from pase_tpu_torch import nn as port_nn
    seen = []
    pool = port_nn.cuda_qrnn.qrnn_pool

    def spy(y, c0=None):
        seen.append(c0 is not None)
        return pool(y, c0)

    monkeypatch.setattr(port_nn.cuda_qrnn, "qrnn_pool", spy)
    st = streaming.StreamingEncoder(narrow[1])
    _emissions(st, _wav(1, 8000, seed=2), [100, 3900, 4000], _np)
    layers = len(narrow[1].rnn.layers)
    assert seen and all(seen)
    assert len(seen) == st.qrnn_calls * layers
    assert st.qrnn_calls == 3          # the 100-sample push reaches nothing


def test_pase_plus_full_width(tmp_path):
    """PASE+ at full width, 8000 samples in two uneven pushes."""
    pair = _pair(PASEP_CFG, seed=3)
    wav = _wav(1, 8000, seed=4)
    got = _check_against_jax(pair, wav, [3000, 5000])
    ref = _offline(pair[1], wav)
    assert got.shape == ref.shape == (1, 256, 50)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=2e-4)


def test_stream_refuses_what_it_cannot_stream(narrow):
    port = narrow[1]
    with pytest.raises(TypeError, match="WaveFe"):
        streaming.StreamingEncoder(torch.nn.Linear(2, 2))
    port.train()
    try:
        with pytest.raises(ValueError, match="eval"):
            streaming.StreamingEncoder(port)
    finally:
        port.eval()


@pytest.mark.parametrize("extra", [
    {"activation": "relu"},
    {"kwidths": [251, 21, 11, 11], "resblocks": True, "activation": "elu"}],
    ids=["feblock_relu", "resblocks_elu"])
def test_named_activations_stream_as_in_jax(extra):
    """A WaveFe whose blocks take a named jax.nn activation streams, as
    the JAX stream does: per push against JAX's, and against its own
    offline forward."""
    pair = _pair(dict(CFG, **extra), seed=4)
    wav = _wav(2, 4800, seed=5)
    got = _check_against_jax(pair, wav, [2000, 2800])
    ref = _offline(pair[1], wav)
    assert got.shape == ref.shape == (2, 8, 30)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=2e-4)
