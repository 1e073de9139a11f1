"""Every jax backend must agree with the independent numpy float64 oracle
(forward + all six gradients).  This is the repo's strongest statement of
the reference-parity contract: the oracle is a direct loop transcription of
the reference semantics (`src/raster.jl:36-108`,
`src/raster_pullback.jl:39-81`) sharing no code with the jax paths."""

import jax.numpy as jnp
import numpy as np
import pytest

import dprast
from dprast.ops import core, dispatch
from dprast.utils.testing import (fixtures, raster_numpy,
                                  raster_pullback_numpy)


# float32 runs the compensated double-float32 coordinate pipeline and the
# bf16-plane contractions — what the GPU runs; float64 skips both
DTYPES = pytest.mark.parametrize("dtype", ["float64", "float32"])


def _cast(fx, dtype):
    """Inputs in `dtype`, and the same values in float64 for the oracle."""
    vals = [np.asarray(v, dtype) for v in fx.values()]
    return (tuple(jnp.asarray(v) for v in vals),
            [v.astype(np.float64) for v in vals])


@DTYPES
@pytest.mark.parametrize("backend", ["xla", "matmul"])
@pytest.mark.parametrize("n_in,n_out", [(2, 2), (3, 2), (3, 3)])
def test_fwd_matches_numpy_oracle(backend, n_in, n_out, dtype):
    fx = fixtures(seed=11, n_points=200, batch_size=4, n_in=n_in,
                  n_out=n_out)
    grid = (12,) * n_out
    args, args64 = _cast(fx, dtype)
    want = raster_numpy(grid, *args64)
    got = np.asarray(dispatch.fwd_fn(backend)(grid, *args))
    # normalise: kernels compute in f32, so absolute tolerance must sit at
    # f32-roundoff relative to the image scale (still well under 1e-5).
    scale = max(np.max(np.abs(want)), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-5)


@DTYPES
@pytest.mark.parametrize("backend", ["xla", "matmul"])
@pytest.mark.parametrize("n_in,n_out", [(3, 2), (3, 3)])
def test_bwd_matches_numpy_oracle(backend, n_in, n_out, dtype):
    fx = fixtures(seed=12, n_points=150, batch_size=4, n_in=n_in,
                  n_out=n_out)
    grid = (10,) * n_out
    g = np.random.default_rng(3).standard_normal((4,) + grid).astype(dtype)
    args, args64 = _cast(fx, dtype)
    want = raster_pullback_numpy(grid, *args64, g.astype(np.float64))
    got = dispatch.bwd_fn(backend)(grid, *args, jnp.asarray(g))
    for name in want:
        w = want[name]
        scale = max(np.max(np.abs(w)), 1.0)
        np.testing.assert_allclose(np.asarray(getattr(got, name)) / scale,
                                   w / scale, rtol=1e-5, atol=1e-5,
                                   err_msg=f"grad {name}")


@pytest.mark.parametrize("n_in,n_out,grid",
                         [(3, 1, (32,)), (4, 4, (6, 6, 6, 6)),
                          (4, 2, (24, 24))])
def test_generic_rank_oracle_fallback(n_in, n_out, grid):
    """The reference's kernels are N-generic (`src/raster.jl:36-66` via
    type-parameter dims); here N_out outside the kernel backends' {2, 3}
    resolves to the xla scatter oracle under 'auto' — correct and
    differentiable at any rank (documented in docs/api.md)."""
    fx = fixtures(seed=12, n_points=60, batch_size=3, n_in=n_in,
                  n_out=n_out)
    args = tuple(jnp.asarray(v, jnp.float32) for v in fx.values())
    np_args = [np.asarray(a, np.float64) for a in args]
    out = dprast.raster(grid, *args)
    ref = raster_numpy(grid, *np_args)
    sc = max(float(np.max(np.abs(ref))), 1.0)
    np.testing.assert_allclose(np.asarray(out, np.float64) / sc, ref / sc,
                               atol=1e-6)

    g = jnp.asarray(np.random.default_rng(3).standard_normal(ref.shape),
                    jnp.float32)
    res = dprast.raster_pullback(g, *args)
    ref_b = raster_pullback_numpy(grid, *np_args, np.asarray(g, np.float64))
    for name in res._fields:
        rr = ref_b[name]
        sc = max(float(np.max(np.abs(rr))), 1.0)
        np.testing.assert_allclose(
            np.asarray(getattr(res, name), np.float64) / sc, rr / sc,
            atol=1e-6, err_msg=f"grad {name} rank {n_in}->{n_out}")
