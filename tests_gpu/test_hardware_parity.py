"""Numerical parity on the GPU vs the independent float64 numpy oracle.

The CPU suite checks the same arithmetic under XLA:CPU; this suite asserts
the ≤1e-5 reference-parity contract (BASELINE.json) for the code XLA
compiles for the card — the reference validates its CUDA path the same way
(`test/cuda.jl:2-74` cuda_cpu_agree).  Device results are float32 with
every contraction at Precision.HIGHEST (no TF32); errors are
scale-normalised, max|got - want| / max(max|want|, 1).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dprast
from dprast.utils.testing import (compensated_coords_errors, fixtures,
                                  raster_numpy, raster_pullback_numpy,
                                  scaled_err)

pytestmark = pytest.mark.gpu

TOL = 1e-5


def _pose_args(seed, n_points, batch, n_in=3, n_out=2):
    fx = fixtures(seed=seed, n_points=n_points, batch_size=batch, n_in=n_in,
                  n_out=n_out)
    return tuple(np.asarray(v, np.float32) for v in fx.values())


def _check_against_oracle(backend, grid, args, tol=TOL, seed=7):
    np64 = [a.astype(np.float64) for a in args]
    ref_f = raster_numpy(grid, *np64)
    out = jax.jit(lambda *a: dprast.raster(grid, *a, backend=backend))(*args)
    assert scaled_err(out, ref_f) <= tol

    g = np.random.default_rng(seed).standard_normal(ref_f.shape)
    ref_b = raster_pullback_numpy(grid, *np64, g)
    res = jax.jit(lambda g_, *a: dprast.raster_pullback(
        g_, *a, backend=backend))(jnp.asarray(g, jnp.float32), *args)
    for name in res._fields:
        err = scaled_err(getattr(res, name), ref_b[name])
        assert err <= tol, f"grad {name} on the GPU: {err:.3e}"


@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_parity_flagship(backend):
    _check_against_oracle(backend, (128, 128),
                          _pose_args(seed=4, n_points=2000, batch=4))


@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_parity_1024sq(backend):
    _check_against_oracle(backend, (1024, 1024),
                          _pose_args(seed=6, n_points=5000, batch=2))


@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_1m_points_128cube(backend):
    """BASELINE config 4 at its stated size: 1M points into 128^3, the
    forward and all six gradients against the float64 oracle."""
    args = _pose_args(seed=11, n_points=1_000_000, batch=1, n_out=3)
    _check_against_oracle(backend, (128, 128, 128), args)


def test_compensated_coords_match_f64():
    """The double-float32 coordinate pipeline on the card: float64's
    reference voxel off boundaries, and only dl's float32 rounding (2^-25)
    left at n=1024, where plain float32 is ~3e-5 off."""
    rng = np.random.default_rng(0)
    err, wrong, in_range = compensated_coords_errors(
        rng.standard_normal((100_000, 3)) * 0.5,
        rng.standard_normal((64, 2, 3)),
        rng.standard_normal((64, 2)) * 0.1, (1024, 1024))
    assert err <= 3e-8, err
    assert wrong == 0
    assert in_range


def test_forward_repeats_bitwise_under_deterministic_ops():
    """XLA's GPU scatter-add uses atomics, so sums change order from run
    to run; `--xla_gpu_deterministic_ops=true` makes repeated runs agree
    bit for bit.  Run with that flag in XLA_FLAGS."""
    if "--xla_gpu_deterministic_ops=true" not in os.environ.get(
            "XLA_FLAGS", ""):
        pytest.skip("set XLA_FLAGS=--xla_gpu_deterministic_ops=true")
    args = _pose_args(seed=8, n_points=20_000, batch=2)
    fwd = jax.jit(lambda *a: dprast.raster((128, 128), *a, backend="xla"))
    first = np.asarray(fwd(*args))
    for _ in range(3):
        np.testing.assert_array_equal(np.asarray(fwd(*args)), first)
