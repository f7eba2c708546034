"""The port's loss trajectory against the JAX step's
(pase_tpu_torch.trajectory; the fixture tests/fixtures/torch_port_trajectory.json
written by tests/torch_port_make_trajectory.py).

Per worker and 'total', the port's mean relative deviation from the JAX
run of its precision must be at most 1 % or at most twice the JAX run's
own one-ulp floor (the r5 criterion). The fast lane runs the first 5
steps in float32 and in bf16 (no JAX); the full 40 steps run under the
``slow`` marker. One fast test rebuilds the fixture's first 2 float32
steps with the JAX package, so a fixture that no longer matches the
code fails.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from pase_tpu_torch import trajectory as T
from torch_port_common import port_test_guard  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_trajectory.json")
FAST_STEPS = 5


@pytest.fixture(scope="module")
def fixture():
    return T.load_fixture(FIXTURE)


def _gate(fixture, precision, steps):
    traj = T.run_port(fixture, precision, "cpu", steps=steps,
                      save_path=tempfile.mkdtemp())
    rows, ok = T.verdict(fixture, precision, traj)
    assert ok, T.format_rows(rows)
    return rows


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_first_steps_track_the_jax_trajectory(fixture, precision):
    _gate(fixture, precision, FAST_STEPS)


@pytest.mark.slow
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_forty_steps_track_the_jax_trajectory(fixture, precision):
    _gate(fixture, precision, T.STEPS)


def test_fixture_is_the_regression_run(fixture):
    """The fixture's configuration is the port module's and
    tests/test_training_regression.py's (workers, encoder, distortion
    probabilities, assets), with one record per step."""
    import test_training_regression as R
    cfg = fixture["config"]
    assert cfg["frontend"] == T.FRONTEND == R.FRONTEND
    assert cfg["workers"] == T.WORKERS == R.WORKERS
    assert cfg["steps"] == T.STEPS == R.N_STEPS
    assert cfg["dist"] == T.DIST
    for name, run in fixture["runs"].items():
        assert len(run) == T.STEPS, name
    assert len(fixture["draws"]) == T.STEPS
    for got, want in zip(T.synth_assets(), R._synth_assets(T.CHUNK)):
        if got is None:
            assert want is None
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fixture_matches_the_jax_package(fixture):
    """The first 2 float32 JAX steps and their draws, rebuilt now."""
    import torch_port_make_trajectory as M
    steps = 2
    for got, want in zip(M.record_draws(steps), fixture["draws"][:steps]):
        assert set(got) == set(want)
        for k, v in want.items():
            # integer draws exactly; float draws to float32 rounding
            np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
            assert np.asarray(got[k]).dtype.kind == np.asarray(v).dtype.kind
    got = M.jax_run("f32", 0.0, steps=steps)
    for g, w in zip(got, fixture["runs"]["f32"][:steps]):
        assert set(g) == set(w)
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]), (k, g[k], w[k])
