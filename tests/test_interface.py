"""Interface / argument-normalisation tests.

Analogue of the reference's inline interface testitems
(`src/interface.jl:414-596`): every accepted argument form must agree with
the canonical form, defaults must fill correctly, and dimension mismatches
must raise the reference's error wording (`src/interface.jl:137-162`).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import dprast
from dprast.ops import geometry
from dprast.utils.testing import fixtures

GRID = (8, 8)


def _fx(**kw):
    return fixtures(seed=4, n_points=12, batch_size=5, n_in=3, n_out=2, **kw)


def test_arg_forms_agree():
    """Lists, numpy arrays and jnp arrays all give the same result."""
    fx = _fx()
    ref = dprast.raster(GRID, **fx)
    as_lists = dprast.raster(
        GRID, fx["points"].tolist(), fx["rotation"].tolist(),
        fx["translation"].tolist(), fx["background"].tolist(),
        fx["out_weight"].tolist(), fx["point_weight"].tolist())
    as_jnp = dprast.raster(GRID, *(jnp.asarray(v) for v in fx.values()))
    np.testing.assert_allclose(np.asarray(as_lists), np.asarray(ref))
    np.testing.assert_allclose(np.asarray(as_jnp), np.asarray(ref))


def test_defaults_match_explicit():
    """Omitted optional args == explicit zeros/ones
    (the FillArrays defaults, reference src/interface.jl:87-92)."""
    fx = _fx()
    b, p = fx["rotation"].shape[0], fx["points"].shape[0]
    ref = dprast.raster(GRID, fx["points"], fx["rotation"],
                        fx["translation"], np.zeros(b), np.ones(b),
                        np.ones(p))
    out = dprast.raster(GRID, fx["points"], fx["rotation"],
                        fx["translation"])
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref))


def test_scalar_broadcast_matches_vector():
    fx = _fx()
    b, p = fx["rotation"].shape[0], fx["points"].shape[0]
    ref = dprast.raster(GRID, fx["points"], fx["rotation"],
                        fx["translation"], np.full(b, 0.3), np.full(b, 2.0),
                        np.full(p, 1.5))
    out = dprast.raster(GRID, fx["points"], fx["rotation"],
                        fx["translation"], 0.3, 2.0, 1.5)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref))


def test_single_pose_equals_batch_of_one():
    """Singleton-batch promotion (reference src/interface.jl:100-120)."""
    fx = _fx()
    single = dprast.raster(GRID, fx["points"], fx["rotation"][0],
                           fx["translation"][0], fx["background"][0],
                           fx["out_weight"][0], fx["point_weight"])
    batched = dprast.raster(GRID, fx["points"], fx["rotation"][:1],
                            fx["translation"][:1], fx["background"][:1],
                            fx["out_weight"][:1], fx["point_weight"])
    assert single.shape == GRID
    assert batched.shape == (1,) + GRID
    np.testing.assert_allclose(np.asarray(single), np.asarray(batched[0]))


def test_dtype_promotion():
    """Mixed input dtypes promote (reference src/interface.jl:63-64),
    floored at float32."""
    fx = _fx()
    out = dprast.raster(GRID, np.asarray(fx["points"], np.float32),
                        np.asarray(fx["rotation"], np.float64),
                        fx["translation"])
    assert out.dtype == jnp.float64
    out32 = dprast.raster(GRID, np.asarray(fx["points"], np.float32),
                          np.asarray(fx["rotation"], np.float32),
                          np.asarray(fx["translation"], np.float32))
    assert out32.dtype == jnp.float32
    outi = dprast.raster(GRID, np.asarray(10 * fx["points"], np.int32) / 10,
                         fx["rotation"], fx["translation"], dtype=jnp.float32)
    assert outi.dtype == jnp.float32


DIM_ERRORS = [
    # (kwargs-overrides, match)
    (dict(translation_ndim=3), "Dimension of translation"),
    (dict(rotation_rows=3), "Row dimension of rotation"),
    (dict(rotation_cols=2), "Column dimension of rotation"),
    (dict(batch_mismatch=True), "Batch size of rotation"),
]


@pytest.mark.parametrize("case", range(len(DIM_ERRORS)))
def test_dimension_errors(case):
    """Shape-mismatch messages with the reference's wording
    (src/interface.jl:146-160), raised eagerly at trace time."""
    overrides, match = DIM_ERRORS[case]
    fx = _fx()
    rot, tr = fx["rotation"], fx["translation"]
    if overrides.get("translation_ndim"):
        tr = np.concatenate([tr, tr[:, :1]], axis=1)
    if overrides.get("rotation_rows"):
        rot = np.concatenate([rot, rot[:, :1, :]], axis=1)
    if overrides.get("rotation_cols"):
        rot = rot[:, :, :2]
    if overrides.get("batch_mismatch"):
        tr = tr[:-1]
    with pytest.raises(ValueError, match=match):
        dprast.raster(GRID, fx["points"], rot, tr)


def test_point_weight_shape_error():
    fx = _fx()
    with pytest.raises(ValueError, match="point_weight"):
        dprast.raster(GRID, fx["points"], fx["rotation"], fx["translation"],
                      point_weight=np.ones(3))


def test_pullback_shape_check():
    fx = _fx()
    bad_g = np.zeros((2,) + GRID)
    with pytest.raises(ValueError, match="ds_dout"):
        dprast.raster_pullback(bad_g, fx["points"], fx["rotation"],
                               fx["translation"])


def test_pullback_scalar_grad_reduction():
    """Scalar optional args get scalar (summed) gradients; vector ones get
    per-pose gradients (the reference's tangent-shape contract)."""
    fx = _fx()
    out = dprast.raster(GRID, fx["points"], fx["rotation"],
                        fx["translation"], 0.1, 2.0, 1.0)
    g = np.random.default_rng(0).standard_normal(out.shape)
    pb = dprast.raster_pullback(g, fx["points"], fx["rotation"],
                                fx["translation"], 0.1, 2.0, 1.0)
    assert pb.background.shape == ()
    assert pb.out_weight.shape == ()
    assert pb.point_weight.shape == ()
    pb_vec = dprast.raster_pullback(g, fx["points"], fx["rotation"],
                                    fx["translation"], fx["background"],
                                    fx["out_weight"], fx["point_weight"])
    assert pb_vec.background.shape == (5,)
    assert pb_vec.point_weight.shape == (12,)
    np.testing.assert_allclose(float(pb.background),
                               float(np.sum(np.asarray(pb_vec.background))))


def test_single_pose_pullback_shapes():
    fx = _fx()
    out = dprast.raster(GRID, fx["points"], fx["rotation"][0],
                        fx["translation"][0])
    g = np.random.default_rng(1).standard_normal(out.shape)
    pb = dprast.raster_pullback(g, fx["points"], fx["rotation"][0],
                                fx["translation"][0])
    assert pb.rotation.shape == (2, 3)
    assert pb.translation.shape == (2,)
    assert pb.background.shape == ()
    assert pb.points.shape == fx["points"].shape


# --- util-level tests (reference src/util.jl:10-46 testitems) ---

def test_voxel_shifts():
    s = geometry.voxel_shifts(2)
    assert s.tolist() == [[0, 0], [1, 0], [0, 1], [1, 1]]
    s3 = geometry.voxel_shifts(3)
    assert s3.shape == (8, 3)
    assert sorted(tuple(r) for r in s3.tolist()) == sorted(
        (i & 1, (i >> 1) & 1, (i >> 2) & 1) for i in range(8))


def test_flat_strides():
    np.testing.assert_array_equal(geometry.flat_strides((4, 5, 6)),
                                  [30, 6, 1])


def test_splat_weights_sum_to_one():
    rng = np.random.default_rng(0)
    dl = jnp.asarray(rng.uniform(0, 1, (10, 3)))
    shifts = jnp.asarray(geometry.voxel_shifts(3))
    w = geometry.splat_weights(dl, shifts)
    np.testing.assert_allclose(np.asarray(jnp.sum(w, axis=-1)), 1.0,
                               rtol=1e-12)


def test_empty_point_cloud():
    """Zero points renders the background and returns empty/zero grads."""
    out = dprast.raster(GRID, np.zeros((0, 2)), np.eye(2), np.zeros(2), 0.7)
    np.testing.assert_allclose(np.asarray(out), 0.7)
    g = np.ones(GRID)
    pb = dprast.raster_pullback(g, np.zeros((0, 2)), np.eye(2),
                                np.zeros(2), 0.7)
    assert pb.points.shape == (0, 2)
    np.testing.assert_allclose(float(pb.background), float(np.sum(g)))
    np.testing.assert_allclose(np.asarray(pb.translation), 0.0)


def test_empty_cloud_still_validates_backend():
    import jax.numpy as jnp
    pts = jnp.zeros((0, 3), jnp.float32)
    rot = jnp.eye(3, dtype=jnp.float32)[:2]
    tr = jnp.zeros((2,), jnp.float32)
    with pytest.raises(ValueError, match="backend"):
        dprast.raster((8, 8), pts, rot, tr, backend="bogus")
    with pytest.raises(ValueError, match="backend"):
        dprast.raster_pullback(jnp.zeros((8, 8), jnp.float32), pts, rot, tr,
                               backend="bogus")


def test_backend_registry_surface():
    """The public backend names are a stable API surface: all three
    registered, 'auto' the default, every name resolvable where
    supported."""
    names = dprast.available_backends()
    assert set(names) == {"xla", "matmul", "matmul_bf16"}
    assert dprast.default_backend() == "auto"
    from dprast.ops import dispatch
    for n in names:
        if dispatch._REGISTRY[n][2](2):
            assert dispatch.resolve(n, 2) == n
