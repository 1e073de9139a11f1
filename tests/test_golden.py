"""Golden-value kernel-semantics tests.

The expected 5x5 images are the reference's hand-computed correctness oracle
(`src/raster.jl:110-310` "raster correctness" testitem, also README.md:41-68)
— exact-value parity is required of every backend, in float64 and in
float32 (which runs the compensated coordinate pipeline the GPU runs).
"""

import numpy as np
import pytest

import dprast

GRID = (5, 5)

CENTER = [[0.0, 0.0]]
RIGHT = [[0.0, 0.4]]
UP = [[-0.4, 0.0]]
LEFT = [[0.0, -0.4]]
DOWN = [[0.4, 0.0]]
HALF_DOWN = [[0.2, 0.0]]
HALF_DOWN_RIGHT = [[0.2, 0.2]]
CROSS = RIGHT + UP + LEFT + DOWN

EYE = [[1.0, 0.0], [0.0, 1.0]]
ROT90 = [[0.0, -1.0], [1.0, 0.0]]
NO_T = [0.0, 0.0]
T_HALF_RIGHT = [0.0, 0.2]
T_1PIX_DOWN = [0.4, 0.0]

BACKENDS = ["xla", "matmul"]
# absolute tolerance per result dtype: float64 is exact to roundoff;
# float32 carries ~2^-24 relative coordinate error into weights of
# values up to 4, i.e. a few float32 ulps
ATOL = {"float64": 1e-12, "float32": 2e-6}
DTYPES = pytest.mark.parametrize("dtype", list(ATOL))

CASES = [
    # (points, rotation, translation, background, out_weight, point_weight,
    #  expected)
    (CENTER, EYE, NO_T, 0.0, 4.0, None, [
        [0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0],
        [0, 0, 4, 0, 0],
        [0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0]]),
    (RIGHT, EYE, NO_T, 0.0, 4.0, None, [
        [0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0],
        [0, 0, 0, 4, 0],
        [0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0]]),
    (HALF_DOWN, EYE, NO_T, 0.0, 4.0, None, [
        [0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0],
        [0, 0, 2, 0, 0],
        [0, 0, 2, 0, 0],
        [0, 0, 0, 0, 0]]),
    (HALF_DOWN_RIGHT, EYE, NO_T, 0.0, 4.0, None, [
        [0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0],
        [0, 0, 1, 1, 0],
        [0, 0, 1, 1, 0],
        [0, 0, 0, 0, 0]]),
    (CROSS, EYE, NO_T, 0.0, 4.0, None, [
        [0, 0, 0, 0, 0],
        [0, 0, 4, 0, 0],
        [0, 4, 0, 4, 0],
        [0, 0, 4, 0, 0],
        [0, 0, 0, 0, 0]]),
    (CROSS, EYE, T_HALF_RIGHT, 0.0, 4.0, None, [
        [0, 0, 0, 0, 0],
        [0, 0, 2, 2, 0],
        [0, 2, 2, 2, 2],
        [0, 0, 2, 2, 0],
        [0, 0, 0, 0, 0]]),
    (CROSS, EYE, T_1PIX_DOWN, 0.0, 4.0, None, [
        [0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0],
        [0, 0, 4, 0, 0],
        [0, 4, 0, 4, 0],
        [0, 0, 4, 0, 0]]),
    (RIGHT, ROT90, NO_T, 0.0, 4.0, None, [
        [0, 0, 0, 0, 0],
        [0, 0, 4, 0, 0],
        [0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0]]),
    (CROSS, EYE, NO_T, 0.0, 1.0, [1.0, 2.0, 3.0, 4.0], [
        [0, 0, 0, 0, 0],
        [0, 0, 2, 0, 0],
        [0, 3, 0, 1, 0],
        [0, 0, 4, 0, 0],
        [0, 0, 0, 0, 0]]),
    (CROSS, EYE, T_HALF_RIGHT, 0.0, 2.0, [1.0, 2.0, 3.0, 4.0], [
        [0, 0, 0, 0, 0],
        [0, 0, 2, 2, 0],
        [0, 3, 3, 1, 1],
        [0, 0, 4, 4, 0],
        [0, 0, 0, 0, 0]]),
]


@DTYPES
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_golden_tables(backend, case, dtype):
    pts, rot, t, bg, ow, pw, expected = CASES[case]
    out = dprast.raster(GRID, pts, rot, t, bg, ow, pw, backend=backend,
                        dtype=dtype)
    assert out.dtype == dtype
    np.testing.assert_allclose(np.asarray(out), np.asarray(expected,
                                                           dtype=float),
                               atol=ATOL[dtype])


@DTYPES
@pytest.mark.parametrize("backend", BACKENDS)
def test_golden_batched(backend, dtype):
    """All golden cases sharing identity rotation, run as one batch."""
    sub = [c for c in CASES if c[0] == CROSS and c[5] is None]
    rots = [c[1] for c in sub]
    trans = [c[2] for c in sub]
    bgs = [c[3] for c in sub]
    ows = [c[4] for c in sub]
    out = dprast.raster(GRID, CROSS, rots, trans, bgs, ows, backend=backend,
                        dtype=dtype)
    assert out.shape == (len(sub),) + GRID
    for i, c in enumerate(sub):
        np.testing.assert_allclose(np.asarray(out[i]),
                                   np.asarray(c[6], dtype=float),
                                   atol=ATOL[dtype])


@DTYPES
@pytest.mark.parametrize("backend", BACKENDS)
def test_background(backend, dtype):
    out = dprast.raster(GRID, CENTER, EYE, NO_T, 0.5, 4.0, backend=backend,
                        dtype=dtype)
    expected = np.full(GRID, 0.5)
    expected[2, 2] += 4.0
    np.testing.assert_allclose(np.asarray(out), expected, atol=ATOL[dtype])


@DTYPES
@pytest.mark.parametrize("backend", BACKENDS)
def test_out_of_grid_points_dropped(backend, dtype):
    """Out-of-grid contributions are silently dropped per-neighbour
    (reference src/raster.jl:62)."""
    pts = [[5.0, 5.0], [-5.0, 0.0], [0.0, 0.0]]
    out = dprast.raster(GRID, pts, EYE, NO_T, backend=backend, dtype=dtype)
    expected = np.zeros(GRID)
    expected[2, 2] = 1.0
    np.testing.assert_allclose(np.asarray(out), expected, atol=ATOL[dtype])


@DTYPES
@pytest.mark.parametrize("backend", BACKENDS)
def test_edge_partial_drop(backend, dtype):
    """A point whose stencil straddles the boundary keeps only the in-grid
    neighbours."""
    # u = (q+1)*2.5 - 0.5; q = -1.0 → u = -0.5 → r0 = -1, dl = 0.5:
    # only neighbour row 0 (shift 1) survives with weight 0.5.
    pts = [[-1.0, 0.0]]
    out = dprast.raster(GRID, pts, EYE, NO_T, 0.0, 1.0, backend=backend,
                        dtype=dtype)
    expected = np.zeros(GRID)
    expected[0, 2] = 0.5
    np.testing.assert_allclose(np.asarray(out), expected, atol=ATOL[dtype])


def test_3d_center():
    out = dprast.raster((5, 5, 5), [[0.0, 0.0, 0.0]], np.eye(3),
                        np.zeros(3), 0.0, 8.0)
    expected = np.zeros((5, 5, 5))
    expected[2, 2, 2] = 8.0
    np.testing.assert_allclose(np.asarray(out), expected, atol=1e-12)


@DTYPES
@pytest.mark.parametrize("backend", BACKENDS)
def test_projection_3d_to_2d(backend, dtype):
    """Orthographic projection: 3D point rasterised into a 2D grid; the
    dropped coordinate must not matter."""
    proj = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    for z in (-0.9, 0.0, 2.5):
        out = dprast.raster(GRID, [[0.0, 0.4, z]], proj, NO_T, 0.0, 4.0,
                            backend=backend, dtype=dtype)
        expected = np.zeros(GRID)
        expected[2, 3] = 4.0
        np.testing.assert_allclose(np.asarray(out), expected,
                                   atol=ATOL[dtype])
