"""Shared test fixtures, mirroring the reference's `test/data.jl`:
random points / rotations / orthographic projections / translations /
per-pose backgrounds & weights / per-point weights, with a batch size chosen
coprime to the device count to exercise uneven sharding (the reference keeps
it coprime to the thread count, `test/data.jl:5-11`)."""

from __future__ import annotations

import numpy as np


def batch_size_coprime_to(n: int, minimum: int = 6) -> int:
    b = max(minimum, 2)
    while np.gcd(b, max(n, 1)) != 1:
        b += 1
    return b


def random_rotation(rng: np.random.Generator, n: int) -> np.ndarray:
    """Random proper rotation matrix via QR (the Rotations.jl analogue)."""
    q, r = np.linalg.qr(rng.standard_normal((n, n)))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def fixtures(seed=0, n_points=10, batch_size=None, n_in=3, n_out=None,
             devices=8):
    """Random-but-deterministic argument set, as a dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    if batch_size is None:
        batch_size = batch_size_coprime_to(devices)
    if n_out is None:
        n_out = n_in
    rotations = np.stack(
        [random_rotation(rng, n_in) for _ in range(batch_size)])
    if n_out < n_in:
        # orthographic projection: drop rows (reference test/data.jl:13-16
        # uses P @ R with P = [I 0])
        rotations = rotations[:, :n_out, :]
    return dict(
        points=0.4 * rng.standard_normal((n_points, n_in)),
        rotation=rotations,
        translation=0.1 * rng.standard_normal((batch_size, n_out)),
        background=0.1 * rng.standard_normal(batch_size),
        out_weight=rng.uniform(0.1, 10.0, batch_size),
        point_weight=rng.uniform(0.1, 10.0, n_points),
    )


def raster_numpy(grid_size, points, rotation, translation, background,
                 out_weight, point_weight):
    """Independent float64 numpy oracle for the forward splat — a direct
    transcription of the reference semantics (`src/raster.jl:36-108`) with
    explicit loops, sharing no code with the jax backends.

    Canonical batched args -> (B, *grid_size) float64.
    """
    points = np.asarray(points, np.float64)
    rotation = np.asarray(rotation, np.float64)
    translation = np.asarray(translation, np.float64)
    background = np.asarray(background, np.float64)
    out_weight = np.asarray(out_weight, np.float64)
    point_weight = np.asarray(point_weight, np.float64)
    b = rotation.shape[0]
    n_out = len(grid_size)
    out = np.empty((b,) + tuple(grid_size))
    sizes = np.asarray(grid_size)
    for ib in range(b):
        out[ib] = background[ib]
        q = points @ rotation[ib].T + translation[ib]        # (P, n_out)
        u = (q + 1.0) * (sizes / 2.0) - 0.5
        r0 = np.ceil(u) - 1
        dl = u - r0
        for s in range(2 ** n_out):
            shift = [(s >> i) & 1 for i in range(n_out)]
            idx = (r0 + shift).astype(np.int64)              # (P, n_out)
            wgt = out_weight[ib] * point_weight.copy()
            for i in range(n_out):
                wgt = wgt * np.where(shift[i], dl[:, i], 1 - dl[:, i])
            ok = np.all((idx >= 0) & (idx < sizes), axis=1)
            np.add.at(out[ib], tuple(idx[ok].T), wgt[ok])
    return out


def raster_pullback_numpy(grid_size, points, rotation, translation,
                          background, out_weight, point_weight, ds_dout):
    """Independent float64 numpy oracle for the analytic pullback — direct
    transcription of `src/raster_pullback.jl:39-81`.  Returns a dict with
    the six gradient arrays."""
    points = np.asarray(points, np.float64)
    rotation = np.asarray(rotation, np.float64)
    translation = np.asarray(translation, np.float64)
    out_weight = np.asarray(out_weight, np.float64)
    point_weight = np.asarray(point_weight, np.float64)
    g = np.asarray(ds_dout, np.float64)
    b = rotation.shape[0]
    p, n_in = points.shape
    n_out = len(grid_size)
    sizes = np.asarray(grid_size)
    d_points = np.zeros((p, n_in))
    d_rot = np.zeros_like(rotation)
    d_tr = np.zeros_like(translation)
    d_bg = g.reshape(b, -1).sum(axis=1)
    d_ow = np.zeros(b)
    d_pw = np.zeros(p)
    scale = sizes / 2.0
    for ib in range(b):
        q = points @ rotation[ib].T + translation[ib]
        u = (q + 1.0) * scale - 0.5
        r0 = np.ceil(u) - 1
        dl = u - r0
        ds_du = np.zeros((p, n_out))
        for s in range(2 ** n_out):
            shift = [(s >> i) & 1 for i in range(n_out)]
            idx = (r0 + shift).astype(np.int64)
            ok = np.all((idx >= 0) & (idx < sizes), axis=1)
            gv = np.zeros(p)
            gv[ok] = g[ib][tuple(idx[ok].T)]
            wsel = np.stack([np.where(shift[i], dl[:, i], 1 - dl[:, i])
                             for i in range(n_out)], axis=1)  # (P, n_out)
            w = wsel.prod(axis=1)
            d_ow[ib] += np.sum(gv * w * point_weight)
            d_pw += gv * w * out_weight[ib]
            for i in range(n_out):
                exact = np.prod(np.delete(wsel, i, axis=1), axis=1)
                sign = 1.0 if shift[i] else -1.0
                ds_du[:, i] += gv * sign * exact * out_weight[ib] \
                    * point_weight
        scaled = ds_du * scale                                # (P, n_out)
        d_tr[ib] = scaled.sum(axis=0)
        d_rot[ib] = scaled.T @ points
        d_points += scaled @ rotation[ib]
    return dict(points=d_points, rotation=d_rot, translation=d_tr,
                background=d_bg, out_weight=d_ow, point_weight=d_pw)


def compensated_coords_errors(points, rotation, translation, grid_size):
    """Check `geometry.pose_voxel_and_deltas` (float32 inputs, compensated
    pipeline) against a float64 transform of the same values.

    Returns ``(max |r0 + dl - u64|, n_wrong_voxel, dl_in_range)``.  The
    first is bounded by dl's own float32 rounding, 2^-25 ≈ 2.98e-8; the
    second counts reference voxels that differ from float64's where u64 is
    more than 1e-9 from a voxel boundary (it must be 0).
    """
    import jax
    import jax.numpy as jnp

    from dprast.ops import geometry

    pts, rot, tr = (np.asarray(a, np.float32)
                    for a in (points, rotation, translation))
    r0, dl = jax.jit(lambda *a: geometry.pose_voxel_and_deltas(
        *a, tuple(grid_size)))(jnp.asarray(pts), jnp.asarray(rot),
                               jnp.asarray(tr))
    q64 = np.einsum("boi,pi->bpo", rot.astype(np.float64),
                    pts.astype(np.float64)) + tr.astype(np.float64)[:, None]
    u64 = (q64 + 1) * np.asarray(grid_size, np.float64) / 2 - 0.5
    r0 = np.asarray(r0, np.int64)
    dl = np.asarray(dl, np.float64)
    err = float(np.max(np.abs(r0 + dl - u64), initial=0.0))
    clear = np.abs(u64 - np.round(u64)) > 1e-9
    wrong = int(np.sum((r0 != np.ceil(u64) - 1) & clear))
    return err, wrong, bool(np.all((dl > 0) & (dl <= 1)))


def scaled_err(got, want) -> float:
    """Max absolute error of `got` against the float64 oracle `want`,
    divided by ``max(max|want|, 1)`` — the scale-normalised error that the
    ≤1e-5 reference-parity contract bounds."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want), initial=0.0)), 1.0)
    return float(np.max(np.abs(got - want), initial=0.0)) / scale


def tree_allclose(a, b, rtol=1e-5, atol=1e-7):
    """Field-wise comparison of PullbackResult/RasterGrads-like tuples
    (the reference's `cuda_cpu_agree`, `test/util.jl:6-34`)."""
    import jax

    flat_a, _ = jax.tree.flatten(a)
    flat_b, _ = jax.tree.flatten(b)
    assert len(flat_a) == len(flat_b)
    return all(
        np.allclose(np.asarray(x), np.asarray(y), rtol=rtol, atol=atol)
        for x, y in zip(flat_a, flat_b))
