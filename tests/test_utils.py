"""Utility-layer tests: profiling hooks, backend registry hygiene, and
public API surface (the Aqua QA analogue, reference `test/runtests.jl:3-6`)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dprast
from dprast.ops import dispatch, geometry
from dprast.utils import compile_cache, profiling
from dprast.utils.testing import compensated_coords_errors, fixtures


def test_public_api_surface():
    for name in dprast.__all__:
        assert hasattr(dprast, name), name
    assert set(dprast.available_backends()) >= {"xla", "matmul"}
    assert dprast.default_backend() == "auto"


def test_resolve_explicit_and_errors():
    """'auto' is xla at every rank; explicit names resolve to themselves
    where supported; unknown names and unsupported ranks raise."""
    for n_out in (1, 2, 3, 4):
        assert dispatch.resolve("auto", n_out) == "xla"
    assert dispatch.resolve("matmul", 2) == "matmul"
    assert dispatch.resolve("xla", 4) == "xla"
    with pytest.raises(ValueError, match="Unknown backend"):
        dispatch.resolve("binned", 2)
    with pytest.raises(ValueError, match="does not support"):
        dispatch.resolve("matmul", 4)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_on_gpu_probe(monkeypatch, platform):
    """The one platform probe reads JAX's default backend."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert dispatch.on_gpu() is (platform == "gpu")


def test_resolve_consistency():
    """Every registered backend that claims support must actually run the
    canonical small case."""
    fx = fixtures(seed=0, n_points=8, batch_size=2, n_in=2, n_out=2)
    for name in dispatch.available_backends():
        if not dispatch._REGISTRY[name][2](2):
            continue
        out = dispatch.fwd_fn(name)(
            (8, 8), *(jnp.asarray(v, jnp.float32) for v in fx.values()))
        assert out.shape == (2, 8, 8), name
        assert np.all(np.isfinite(np.asarray(out))), name


def test_time_fn_runs():
    stats = profiling.time_fn(jax.jit(lambda c: c + 1.0), jnp.float32(0),
                              iters=4)
    assert stats["n"] == 4
    assert 0.0 <= stats["min_ms"] <= stats["median_ms"] <= stats["max_ms"]


def test_device_record_names_the_device():
    rec = profiling.device_record()
    assert rec["platform"] == "cpu" and rec["card"] is None
    assert rec["device_count"] == jax.device_count()


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(monkeypatch, tmp_path, env_set):
    """$JAX_COMPILATION_CACHE_DIR wins when set; otherwise one fixed,
    git-ignored directory inside the checkout."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(repo, ".jax_cache")
        with open(os.path.join(repo, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    old = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_annotate_and_trace(tmp_path):
    with profiling.annotate("unit-test"):
        x = jnp.ones((4,)) * 2
    assert float(x.sum()) == 8.0


def test_compensated_coords_match_f64():
    """grid_coords_2f must pick float64's reference voxel and leave only
    dl's own float32 rounding (2^-25) at n=1024, where plain float32 is
    ~3e-5 off (above the parity target alone).  Points sit on exact voxel
    centers too, where the voxel choice is a gradient kink."""
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((20_000, 3)) * 0.5
    rot = rng.standard_normal((16, 2, 3))
    tr = rng.standard_normal((16, 2)) * 0.1
    err, wrong, in_range = compensated_coords_errors(pts, rot, tr,
                                                     (1024, 1024))
    assert err <= 3e-8, err
    assert wrong == 0
    assert in_range


def test_compensated_coords_just_past_a_center():
    """u = 511 + 2^-24 exactly (p = -2^-10 + 2^-33 on a 1024 grid): the
    double-float32 pair is (511, 2^-24), and 1 + 2^-24 rounds to 1 in
    float32 — the voxel must still come from the exact sum, as float64
    picks it (r0 = 511, dl = 2^-24), not (510, 1.0)."""
    p = np.float32(-2.0 ** -10 + 2.0 ** -33)
    assert float(p) == -2.0 ** -10 + 2.0 ** -33
    r0, dl = geometry.pose_voxel_and_deltas(
        jnp.asarray([[p, p]], jnp.float32), jnp.eye(2, dtype=jnp.float32)[None],
        jnp.zeros((1, 2), jnp.float32), (1024, 1024))
    assert np.asarray(r0).ravel().tolist() == [511, 511]
    np.testing.assert_array_equal(np.asarray(dl).ravel(), [2.0 ** -24] * 2)
    err, wrong, _ = compensated_coords_errors([[p, p]], np.eye(2)[None],
                                              np.zeros((1, 2)), (1024, 1024))
    assert wrong == 0 and err <= 3e-8


def test_compensated_coords_exact_centers():
    """Points on exact voxel centers keep the reference dl == 1 contract.
    The centers of an 8-wide grid are exact in float32; those of a 5-wide
    one (q = 0.4, ...) are not, and there the rounded point lies just past
    or short of the center — its voxel must then be float64's."""
    grid = (8, 8)
    # voxel j center: q = (j + 0.5) * 2/8 - 1  ->  u = j exactly
    pts = np.array([[(j + 0.5) * 2 / 8 - 1, 0.0] for j in range(8)],
                   np.float32)
    r0, dl = geometry.pose_voxel_and_deltas(
        jnp.asarray(pts), jnp.eye(2, dtype=jnp.float32)[None],
        jnp.zeros((1, 2), jnp.float32), grid)
    assert np.all(np.asarray(dl[0, :, 0]) == 1.0)
    assert list(np.asarray(r0[0, :, 0])) == [j - 1 for j in range(8)]
    pts5 = np.array([[(j + 0.5) * 2 / 5 - 1, 0.0] for j in range(5)],
                    np.float32)
    err, wrong, in_range = compensated_coords_errors(
        pts5, np.eye(2)[None], np.zeros((1, 2)), (5, 5))
    assert wrong == 0 and in_range and err <= 3e-8
