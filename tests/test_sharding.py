"""Sharded-vs-single-device consistency on a virtual 8-device CPU mesh.

This is the multi-device analogue of the reference's "parallel correctness"
strategy
(`src/raster_pullback.jl:271-345`: threaded batched pullback ≡ serial loop;
`test/data.jl:5-11`: batch size coprime to worker count to exercise uneven
chunking).  Determinism across shardings also plays the role of the
reference's race-freedom validation (SURVEY §5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dprast
from dprast.parallel import make_mesh, raster_sharded
from dprast.utils.testing import fixtures

GRID2 = (16, 16)
MESHES = [(8, 1), (1, 8), (4, 2), (2, 4)]


pytestmark = pytest.mark.slow  # multi-minute on the 8-device virtual mesh

def _args(n_points=37, batch=8, n_in=3, n_out=2):
    # n_points deliberately not divisible by any points-shard count
    # (padding path), batch divisible by every poses-shard count.
    fx = fixtures(seed=3, n_points=n_points, batch_size=batch, n_in=n_in,
                  n_out=n_out)
    return fx


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_forward_matches_single_device(mesh_shape):
    fx = _args()
    mesh = make_mesh(*mesh_shape)
    out_sharded = raster_sharded(GRID2, **fx, mesh=mesh)
    out_ref = dprast.raster(GRID2, **fx)
    np.testing.assert_allclose(np.asarray(out_sharded), np.asarray(out_ref),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4)])
def test_grads_match_single_device(mesh_shape):
    fx = _args()
    mesh = make_mesh(*mesh_shape)
    keys = ("points", "rotation", "translation", "background", "out_weight",
            "point_weight")
    vals = tuple(jnp.asarray(fx[k]) for k in keys)

    def loss_sharded(*args):
        out = raster_sharded(GRID2, *args, mesh=mesh)
        return jnp.sum(jnp.sin(out))

    def loss_single(*args):
        out = dprast.raster(GRID2, *args)
        return jnp.sum(jnp.sin(out))

    g_sh = jax.grad(loss_sharded, argnums=tuple(range(6)))(*vals)
    g_si = jax.grad(loss_single, argnums=tuple(range(6)))(*vals)
    for name, a, b in zip(keys, g_sh, g_si):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-9,
                                   atol=1e-10, err_msg=f"grad {name}")


def test_mesh_validation():
    with pytest.raises(ValueError):
        make_mesh(3, 3)
    # 7 poses on an 8-wide poses axis: padded with inert poses, not an error
    mesh = make_mesh(8, 1)
    fx = _args(batch=7)
    out = raster_sharded(GRID2, **fx, mesh=mesh)
    ref = dprast.raster(GRID2, **fx)
    assert out.shape == ref.shape
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-9)


def test_uneven_pose_batch():
    """Batch coprime to the poses axis must match single-device — the
    reference's coprime chunking contract (`test/data.jl:5-11`)."""
    mesh = make_mesh(2, 4)
    fx = fixtures(seed=11, n_points=29, batch_size=7, n_in=3, n_out=2)
    args = {k: jnp.asarray(v) for k, v in fx.items()}
    out = raster_sharded(GRID2, **args, mesh=mesh)
    ref = dprast.raster(GRID2, **args)
    assert out.shape == ref.shape
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-9)

    def loss_sh(pts, rot, tr):
        a = dict(args, points=pts, rotation=rot, translation=tr)
        return jnp.sum(raster_sharded(GRID2, **a, mesh=mesh) ** 2)

    def loss_1(pts, rot, tr):
        a = dict(args, points=pts, rotation=rot, translation=tr)
        return jnp.sum(dprast.raster(GRID2, **a) ** 2)

    g_sh = jax.grad(loss_sh, argnums=(0, 1, 2))(
        args["points"], args["rotation"], args["translation"])
    g_1 = jax.grad(loss_1, argnums=(0, 1, 2))(
        args["points"], args["rotation"], args["translation"])
    for a, b in zip(g_sh, g_1):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-9)


def test_sharded_default_weights_fast_path():
    """Defaulted point_weight through the sharded path: with the point
    count divisible by the points axis no padding is inserted; with a
    non-divisible count the weight-0 padding rows must still drop out;
    and the gradient w.r.t. a SCALAR weight sums over every shard."""
    fx = fixtures(seed=19, n_points=64, batch_size=8, n_in=3, n_out=2)
    args64 = {k: jnp.asarray(v) for k, v in fx.items()}  # f64 under x64
    del args64["point_weight"]
    mesh = make_mesh(2, 4)
    for n_points in (64, 37):   # divisible by 4 -> no padding; else padding
        a = dict(args64, points=args64["points"][:n_points])
        out = raster_sharded(GRID2, **a, mesh=mesh)
        ref = dprast.raster(GRID2, **a)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=1e-12, atol=1e-12)

    pw0 = jnp.asarray(1.3)

    def loss_sh(pts, tr, w):
        return jnp.sum(raster_sharded(
            GRID2, pts, args64["rotation"], tr, point_weight=w,
            mesh=mesh) ** 2)

    def loss_1(pts, tr, w):
        return jnp.sum(dprast.raster(
            GRID2, pts, args64["rotation"], tr, point_weight=w) ** 2)

    g_sh = jax.grad(loss_sh, argnums=(0, 1, 2))(
        args64["points"], args64["translation"], pw0)
    g_1 = jax.grad(loss_1, argnums=(0, 1, 2))(
        args64["points"], args64["translation"], pw0)
    for name, a_, b_ in zip(("points", "translation", "point_weight"),
                            g_sh, g_1):
        np.testing.assert_allclose(np.asarray(a_), np.asarray(b_),
                                   rtol=1e-9, atol=1e-10,
                                   err_msg=f"grad {name}")


def test_sharded_empty_cloud():
    """P=0 returns the background image (regression: the matmul backend's
    chunking divided by zero through the sharded path)."""
    mesh = make_mesh(2, 4)
    out = raster_sharded((8, 8), jnp.zeros((0, 2)),
                         jnp.tile(jnp.eye(2)[None], (4, 1, 1)),
                         jnp.zeros((4, 2)), 3.0, mesh=mesh)
    assert out.shape == (4, 8, 8)
    np.testing.assert_allclose(np.asarray(out), 3.0)
