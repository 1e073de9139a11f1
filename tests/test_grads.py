"""AD correctness: finite-difference checks + backend agreement.

The `jax.test_util.check_grads` items are the analogue of the reference's
`ChainRulesTestUtils.test_rrule` finite-difference suite
(`test/chainrules.jl:2-90`): single + batched, 3D→3D and 3D→2D projection,
with and without optional args.  Backend cross-agreement is the analogue of
`cuda_cpu_agree` (`test/util.jl:1-34`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.test_util import check_grads

import dprast
from dprast.ops import core, splat_matmul
from dprast.utils.testing import fixtures, tree_allclose

GRID = (8, 8)


def _fx(n_in=3, n_out=2, n_points=16, batch=5, seed=1):
    fx = fixtures(seed=seed, n_points=n_points, batch_size=batch, n_in=n_in,
                  n_out=n_out)
    return {k: jnp.asarray(v) for k, v in fx.items()}


@pytest.mark.parametrize("backend", ["xla", "matmul"])
@pytest.mark.parametrize("n_in,n_out", [(2, 2), (3, 2), (3, 3)])
def test_check_grads_batched(backend, n_in, n_out):
    fx = _fx(n_in=n_in, n_out=n_out)
    grid = (8,) * n_out

    def f(points, rotation, translation, background, out_weight,
          point_weight):
        return dprast.raster(grid, points, rotation, translation, background,
                             out_weight, point_weight, backend=backend)

    # order=1 only: the forward is piecewise-bilinear in the pose args, so
    # second derivatives are discontinuous at voxel boundaries (same reason
    # the reference only tests the rrule, not second order).
    check_grads(f, tuple(fx.values()), order=1, modes=["rev"], atol=1e-6,
                rtol=1e-6)


@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_check_grads_single_pose(backend):
    fx = _fx(n_in=3, n_out=2, batch=1)

    def f(points, rotation, translation):
        return dprast.raster(GRID, points, rotation[0], translation[0],
                             backend=backend)

    check_grads(f, (fx["points"], fx["rotation"], fx["translation"]),
                order=1, modes=["rev"], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n_in,n_out", [(2, 2), (3, 2), (3, 3), (4, 3)])
def test_backends_agree(n_in, n_out):
    """matmul backend ≡ xla oracle, forward and full pullback
    (the cuda_cpu_agree analogue, reference test/cuda.jl:2-74)."""
    fx = _fx(n_in=n_in, n_out=n_out, n_points=64, batch=7)
    grid = (6,) * n_out
    args = tuple(fx.values())
    out_x = core.raster_fwd(grid, *args)
    out_m = splat_matmul.raster_fwd(grid, *args)
    np.testing.assert_allclose(np.asarray(out_m), np.asarray(out_x),
                               rtol=1e-9, atol=1e-9)
    g = jnp.asarray(
        np.random.default_rng(9).standard_normal(out_x.shape))
    pb_x = core.raster_pullback(grid, *args, g)
    pb_m = splat_matmul.raster_pullback(grid, *args, g)
    assert tree_allclose(pb_m, pb_x, rtol=1e-8, atol=1e-8)


def test_grad_matches_analytic_pullback():
    """jax.grad through `raster` == the public `raster_pullback` on the same
    cotangent (the reference's rrule-vs-raster_pullback! contract,
    `ext/DiffPointRasterisationChainRulesCoreExt.jl:48-74`)."""
    fx = _fx()
    args = tuple(fx.values())
    out = dprast.raster(GRID, *args)
    g = jnp.asarray(np.random.default_rng(2).standard_normal(out.shape))

    def loss(*a):
        return jnp.sum(dprast.raster(GRID, *a) * g)

    grads = jax.grad(loss, argnums=tuple(range(6)))(*args)
    pb = dprast.raster_pullback(g, *args)
    assert tree_allclose(tuple(grads), tuple(pb), rtol=1e-9, atol=1e-9)


def test_batched_equals_loop_of_singles():
    """Batched forward/pullback ≡ per-pose loop (the reference's threaded
    consistency items, `src/raster.jl:383-431`,
    `src/raster_pullback.jl:271-345`)."""
    fx = _fx(n_points=32, batch=7)
    out_b = dprast.raster(GRID, *fx.values())
    g = jnp.asarray(np.random.default_rng(5).standard_normal(out_b.shape))
    pb_b = dprast.raster_pullback(g, *fx.values())

    d_points = jnp.zeros_like(fx["points"])
    d_pw = jnp.zeros_like(fx["point_weight"])
    for i in range(out_b.shape[0]):
        out_i = dprast.raster(GRID, fx["points"], fx["rotation"][i],
                              fx["translation"][i], fx["background"][i],
                              fx["out_weight"][i], fx["point_weight"])
        np.testing.assert_allclose(np.asarray(out_i), np.asarray(out_b[i]),
                                   rtol=1e-9, atol=1e-9)
        pb_i = dprast.raster_pullback(g[i], fx["points"], fx["rotation"][i],
                                      fx["translation"][i],
                                      fx["background"][i],
                                      fx["out_weight"][i],
                                      fx["point_weight"])
        d_points = d_points + pb_i.points
        d_pw = d_pw + pb_i.point_weight
        np.testing.assert_allclose(np.asarray(pb_i.rotation),
                                   np.asarray(pb_b.rotation[i]), rtol=1e-8,
                                   atol=1e-9)
        np.testing.assert_allclose(np.asarray(pb_i.translation),
                                   np.asarray(pb_b.translation[i]),
                                   rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(d_points),
                               np.asarray(pb_b.points), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(d_pw),
                               np.asarray(pb_b.point_weight), rtol=1e-8,
                               atol=1e-9)


def test_batched_equals_vmap_of_singles():
    """The batched path must equal vmap over the single-pose path — the
    same contract as the loop consistency test but through JAX's own
    batching machinery."""
    fx = _fx(n_points=24, batch=5)

    out_b = dprast.raster(GRID, *fx.values())

    def single(rot, tr, bg, ow):
        return dprast.raster(GRID, fx["points"], rot, tr, bg, ow,
                             fx["point_weight"])

    out_v = jax.vmap(single)(fx["rotation"], fx["translation"],
                             fx["background"], fx["out_weight"])
    np.testing.assert_allclose(np.asarray(out_v), np.asarray(out_b),
                               rtol=1e-9, atol=1e-9)


def test_jit_vmap_compose():
    """raster composes with jit and vmap over an extra leading axis."""
    fx = _fx()

    @jax.jit
    def f(pts):
        return dprast.raster(GRID, pts, fx["rotation"], fx["translation"])

    out = f(fx["points"])
    many = jnp.stack([fx["points"], fx["points"] * 0.5])
    out_v = jax.vmap(f)(many)
    assert out_v.shape == (2,) + out.shape
    np.testing.assert_allclose(np.asarray(out_v[0]), np.asarray(out),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("grid", [(8, 8), (8, 192)])
def test_matmul_bf16_fast_mode_close(grid):
    """matmul_bf16 (1-plane bf16 values, ~2e-3 error) must stay within its
    documented envelope of the faithful backend, forward, through jax.grad
    and in the standalone pullback (all six fields)."""
    fx = _fx(n_points=64, batch=4, seed=7)
    args = tuple(jnp.asarray(v, jnp.float32) for v in fx.values())
    ref = dprast.raster(grid, *args, backend="matmul")
    fast = dprast.raster(grid, *args, backend="matmul_bf16")
    scale = max(float(jnp.max(jnp.abs(ref))), 1.0)
    np.testing.assert_allclose(np.asarray(fast) / scale,
                               np.asarray(ref) / scale, atol=2e-2)

    g = jnp.asarray(
        np.random.default_rng(4).standard_normal(ref.shape), jnp.float32)

    def loss(backend, pts, tr):
        return jnp.sum(dprast.raster(grid, pts, args[1], tr, *args[3:],
                                     backend=backend) * g)

    g_f = jax.grad(lambda *a: loss("matmul_bf16", *a), argnums=(0, 1))(
        args[0], args[2])
    g_r = jax.grad(lambda *a: loss("matmul", *a), argnums=(0, 1))(
        args[0], args[2])
    for a, b in zip(g_f, g_r):
        sc = max(float(jnp.max(jnp.abs(b))), 1.0)
        np.testing.assert_allclose(np.asarray(a) / sc, np.asarray(b) / sc,
                                   atol=2e-2)

    pb_f = dprast.raster_pullback(g, *args, backend="matmul_bf16")
    pb_r = dprast.raster_pullback(g, *args, backend="matmul")
    for name in pb_r._fields:
        b = np.asarray(getattr(pb_r, name))
        sc = max(float(np.max(np.abs(b))), 1.0)
        np.testing.assert_allclose(np.asarray(getattr(pb_f, name)) / sc,
                                   b / sc, atol=2e-2,
                                   err_msg=f"matmul_bf16 pullback {name}")


@pytest.mark.parametrize("backend", ["matmul"])
@pytest.mark.parametrize("n_in,n_out", [(3, 2), (3, 3)])
def test_check_grads_kernel_backends(backend, n_in, n_out):
    """Finite-difference checks on the contraction backend with float32
    inputs, i.e. through its bf16-plane products — the path the GPU runs
    (the reference runs `test_rrule` on every path it can,
    `test/chainrules.jl:2-90`).  Tolerances are float32-scaled."""
    grid = (8,) * n_out
    fx = _fx(n_in=n_in, n_out=n_out)
    args = tuple(jnp.asarray(v, jnp.float32) for v in fx.values())

    def f(points, rotation, translation, background, out_weight,
          point_weight):
        return dprast.raster(grid, points, rotation, translation,
                             background, out_weight, point_weight,
                             backend=backend)

    check_grads(f, args, order=1, modes=["rev"], atol=5e-3, rtol=5e-3)


def test_grad_matmul_3d_matches_xla():
    """`jax.grad` through the matmul 3D path (float32: bf16-plane
    selections) vs the xla scatter/gather backend on a grid with a wide
    minor axis, where finite differences cross voxel-boundary kinks."""
    grid = (8, 16, 128)
    fx = _fx(n_in=3, n_out=3)
    pts, rot, tr = (jnp.asarray(fx[k], jnp.float32)
                    for k in ("points", "rotation", "translation"))

    def loss(backend, pts, rot, tr):
        return jnp.sum(
            dprast.raster(grid, pts, rot, tr, backend=backend) ** 2)

    g_m = jax.grad(lambda *a: loss("matmul", *a), argnums=(0, 1, 2))(
        pts, rot, tr)
    g_x = jax.grad(lambda *a: loss("xla", *a), argnums=(0, 1, 2))(
        pts, rot, tr)
    for a, b in zip(g_m, g_x):
        sc = max(float(jnp.max(jnp.abs(b))), 1.0)
        np.testing.assert_allclose(np.asarray(a) / sc, np.asarray(b) / sc,
                                   atol=8e-6)
