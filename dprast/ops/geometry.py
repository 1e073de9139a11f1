"""Shared splat geometry: pose transform, reference-voxel/delta computation,
and the 2^N neighbour-shift enumeration.

Semantics match the reference exactly (reference `src/raster.jl:85-108`,
`src/util.jl:7-27`), restated in 0-based indexing:

The output grid of size ``n`` along an axis discretises the interval (-1, 1);
voxel ``j`` (0-based) has its center at coordinate ``u = j`` in the "grid
coordinate system" defined by

    u = (q + 1) * (n / 2) - 1/2,        q = R @ p + t

The reference voxel is ``r0 = ceil(u) - 1`` and the fractional offset
``dl = u - r0`` lies in ``(0, 1]``.  A point splats onto voxels ``r0 + s`` for
each shift ``s in {0,1}^N`` with multilinear weight
``prod_i(s_i ? dl_i : 1 - dl_i)``; neighbours outside the grid are dropped.

(The reference works 1-based: ``coord = (q - origin) * scale`` with
``origin = -1 - t``, ``ref = ceil(coord - 1/2)``, ``dl = coord - ref + 1/2``;
the formulas above are the exact 0-based translation.)
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def vma_union(*like) -> frozenset:
    """Union of the varying-manual-axes of `like` (shard_map vma typing)."""
    vma = frozenset()
    for a in like:
        vma |= getattr(jax.typeof(a), "vma", frozenset())
    return vma


def zeros_vma(shape, dtype, *like):
    """`jnp.zeros` whose varying-manual-axes match the union of `like`'s.

    Needed so backend-internal accumulators (e.g. `lax.scan` carries) are
    well-typed when a backend runs inside `jax.shard_map` (check_vma=True):
    a plain `jnp.zeros` is axis-invariant while the scan output varies over
    the mesh axes of the inputs.
    """
    z = jnp.zeros(shape, dtype)
    vma = vma_union(*like)
    if vma:
        z = jax.lax.pcast(z, tuple(vma), to="varying")
    return z


def voxel_shifts(n_out: int) -> np.ndarray:
    """All 2^N neighbour shifts, LSB-first bit order (reference `src/util.jl:26-27`).

    Returns an int32 array of shape (2**n_out, n_out) with
    ``shifts[k, i] = (k >> i) & 1``.
    """
    k = np.arange(2**n_out, dtype=np.int32)
    i = np.arange(n_out, dtype=np.int32)
    return ((k[:, None] >> i[None, :]) & 1).astype(np.int32)


def transform_points(points: jnp.ndarray, rotation: jnp.ndarray,
                     translation: jnp.ndarray) -> jnp.ndarray:
    """Apply the batched rigid/projective pose transform ``q = R @ p + t``.

    points: (P, N_in); rotation: (B, N_out, N_in); translation: (B, N_out)
    → (B, P, N_out).  (reference `src/raster.jl:88` ``projected_point``)

    Always full precision: a DEFAULT-precision contraction may run in
    bf16 or TF32 on an accelerator, which would perturb coordinates by
    ~1e-3 relative and flip reference voxels — a discrete,
    precision-knob-proof error.  The contraction is K = N_in ≤ 4, so this
    costs nothing.
    """
    q = jnp.einsum("boi,pi->bpo", rotation, points,
                   precision=jax.lax.Precision.HIGHEST)
    return q + translation[:, None, :]


def grid_coords(q: jnp.ndarray, grid_size: tuple[int, ...]) -> jnp.ndarray:
    """Map transformed points to 0-based fractional grid coordinates ``u``.

    q: (..., N_out) → u: (..., N_out) with ``u = (q + 1) * n/2 - 1/2``.
    (reference `src/raster.jl:25,53,92`: ``scale = n/2``, ``origin = -1 - t``,
    ``coord = (q - origin) * scale``; here ``u = coord - 1``.)
    """
    scale = jnp.asarray(grid_size, dtype=q.dtype) / 2
    return (q + 1) * scale - jnp.asarray(0.5, dtype=q.dtype)


def reference_voxel_and_deltas(
    q: jnp.ndarray, grid_size: tuple[int, ...]
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """0-based reference voxel index and lower-corner delta.

    Returns ``(r0, dl)`` with ``r0 = ceil(u) - 1`` (int32) and
    ``dl = u - r0 in (0, 1]`` so that a point exactly on a voxel center gets
    ``dl == 1`` and sends its full weight to shift ``s = 1``.
    (reference `src/raster.jl:94-97`.)
    """
    u = grid_coords(q, grid_size)
    r0f = jnp.ceil(u) - 1
    dl = u - r0f
    return r0f.astype(jnp.int32), dl


def splat_weights(dl: jnp.ndarray, shifts: jnp.ndarray) -> jnp.ndarray:
    """Multilinear weights for every neighbour shift.

    dl: (..., N_out); shifts: (S, N_out) → (..., S) with
    ``w[..., k] = prod_i (shifts[k,i] ? dl_i : 1 - dl_i)``
    (reference `src/raster.jl:103-108` ``voxel_weight``).
    """
    sel = jnp.where(shifts.astype(bool), dl[..., None, :], 1 - dl[..., None, :])
    return jnp.prod(sel, axis=-1)


def splat_weight_grads(dl: jnp.ndarray, shifts: jnp.ndarray) -> jnp.ndarray:
    """d(splat_weights)/d(dl): (..., S, N_out).

    ``dw_k/ddl_i = (shifts[k,i] ? +1 : -1) * prod_{j != i} (s_j ? dl_j : 1-dl_j)``
    (reference `src/raster_pullback.jl:150-160` ``interpolation_weight``).
    Computed with a masked product (no division) so ``dl -> 0`` is exact.
    """
    n = dl.shape[-1]
    sel = jnp.where(shifts.astype(bool), dl[..., None, :], 1 - dl[..., None, :])
    # prod over j != i: substitute 1 at position i, take full product.
    eye = jnp.eye(n, dtype=bool)
    sel_exp = jnp.where(eye, jnp.ones_like(sel[..., None, :]), sel[..., None, :])
    prod_exc = jnp.prod(sel_exp, axis=-1)  # (..., S, N)
    sign = jnp.where(shifts.astype(bool), 1, -1).astype(dl.dtype)
    return sign * prod_exc


# ---------------------------------------------------------------------------
# Compensated (double-float32) coordinate pipeline.
#
# A plain f32 transform gives grid coordinates with absolute error
# ~n/2 * 2^-23 (3e-5 at n=1024) — above the 1e-5 reference-parity target all
# by itself.  These helpers carry an (hi, lo) double-f32 pair through
# q = R@p + t and u = (q+1)*n/2 - 1/2 so `dl` is accurate to ~2^-23 absolute
# for any grid size.  TwoSum and TwoProd are exact only if XLA keeps the
# IEEE operation order: no reassociation and no contraction of `a*b+c`
# into an FMA.  Checked against float64 at n=1024 on the CPU
# (`tests/test_utils.py`) and on the GPU (`tests_gpu/`, `chip_smoke.py`).
# ---------------------------------------------------------------------------


def _two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly (s = fl(a+b))."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def _split_f32(a):
    """Veltkamp split of an f32 into 12+12-bit halves."""
    c = a * jnp.float32(4097.0)  # 2^12 + 1
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """Dekker TwoProd: p + e == a * b exactly (p = fl(a*b))."""
    p = a * b
    ah, al = _split_f32(a)
    bh, bl = _split_f32(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def grid_coords_2f(points: jnp.ndarray, rotation: jnp.ndarray,
                   translation: jnp.ndarray, grid_size: tuple[int, ...]):
    """Double-f32 fractional grid coordinates of transformed points.

    points: (P, N_in); rotation: (B, N_out, N_in); translation: (B, N_out)
    → (u_hi, u_lo) each (B, P, N_out) with
    ``u_hi + u_lo ≈ (R@p + t + 1) * n/2 - 1/2`` to ~2^-46 relative.
    """
    f32 = jnp.float32
    pts = points.astype(f32)
    rot = rotation.astype(f32)
    tr = translation.astype(f32)
    b, n_out, n_in = rot.shape
    p = pts.shape[0]
    hi = jnp.broadcast_to(tr[:, None, :], (b, p, n_out))
    lo = jnp.zeros((b, p, n_out), f32)
    for j in range(n_in):
        pr, pe = _two_prod(rot[:, None, :, j], pts[None, :, None, j])
        hi, e = _two_sum(hi, pr)
        lo = lo + (pe + e)
    # u = (q + 1) * scale - 1/2   (scale = n/2 is exact in f32)
    hi, e = _two_sum(hi, f32(1.0))
    lo = lo + e
    scale = jnp.asarray(grid_size, f32) / 2
    hi, e = _two_prod(hi, scale)
    lo = lo * scale + e
    hi, e = _two_sum(hi, f32(-0.5))
    lo = lo + e
    hi, e = _two_sum(hi, lo)  # renormalise
    return hi, e


def reference_voxel_and_deltas_2f(u_hi: jnp.ndarray, u_lo: jnp.ndarray):
    """(r0, dl) from a double-f32 coordinate, keeping ``dl in (0, 1]``.

    Same contract as :func:`reference_voxel_and_deltas` (``r0 = ceil(u)-1``,
    point on a voxel center → ``dl == 1``), with the voxel chosen from the
    exact ``u_hi + u_lo`` and `dl` off by float32 rounding only (≤2^-25).

    ``u_hi - (ceil(u_hi) - 1)`` is in (0, 1], and a renormalised pair has
    ``|u_lo| <= ulp(u_hi)/2``, so the exact ``dl`` leaves (0, 1] only when
    `u_hi` is an integer and ``u_lo > 0``: the point is then just past that
    voxel center, in the next voxel, with ``dl = u_lo`` exactly.  (Rounding
    ``1 + u_lo`` first would keep the old voxel for ``u_lo <= 2^-24`` — the
    other side of a gradient kink from float64's choice.)  The subtraction
    is exact except for ``-1/2 < u_hi < 0``; TwoSum keeps its remainder, so
    `dl` is rounded once.
    """
    c = jnp.ceil(u_hi)
    up = (u_hi == c) & (u_lo > 0)
    r0f = c - 1
    t, te = _two_sum(u_hi, -r0f)
    dl = jnp.where(up, u_lo, t + (te + u_lo))
    return (r0f + up.astype(r0f.dtype)).astype(jnp.int32), dl


def pose_voxel_and_deltas(points: jnp.ndarray, rotation: jnp.ndarray,
                          translation: jnp.ndarray,
                          grid_size: tuple[int, ...]):
    """(r0, dl) for the full pose pipeline at double-f32 accuracy.

    Drop-in replacement for
    ``reference_voxel_and_deltas(transform_points(...), grid_size)`` used by
    every backend; the compensated pipeline costs ~60 elementwise flops per
    (point, pose, axis) — negligible next to the splat itself.
    """
    if jnp.result_type(points, rotation, translation) == jnp.float64:
        # f64 inputs are already beyond the target accuracy — keep them.
        q = transform_points(points, rotation, translation)
        return reference_voxel_and_deltas(q, grid_size)
    u_hi, u_lo = grid_coords_2f(points, rotation, translation, grid_size)
    return reference_voxel_and_deltas_2f(u_hi, u_lo)


def flat_strides(grid_size: tuple[int, ...]) -> np.ndarray:
    """Row-major strides for flattening an N-d grid index."""
    return np.array(
        [int(np.prod(grid_size[i + 1:], dtype=np.int64)) for i in range(len(grid_size))],
        dtype=np.int32,
    )
