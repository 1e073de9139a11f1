"""Public API: argument normalisation cascade + shape validation.

This replaces the reference's multiple-dispatch cascade
(`src/interface.jl:62-162`: allocate → defaults → singleton-batch promotion →
canonicalise → dim errors → kernel) with explicit trace-time Python:

1. coerce everything to jnp arrays (lists of vectors/matrices stack
   naturally — the `inner_to_sized` analogue, `src/util.jl:52-64`),
2. fill defaults (background=0, out_weight=1, point_weight=1 — the
   FillArrays analogue, `src/interface.jl:368-394`),
3. detect single-vs-batched mode from `rotation.ndim` (the reference
   dispatches on Matrix vs Vector-of-Matrix, `src/interface.jl:67-75`),
4. promote dtypes (`src/interface.jl:63-64` `promote_type(deep_eltype...)`),
5. validate dimensions with the reference's error wording
   (`src/interface.jl:137-162`),
6. call the backend through the `custom_vjp`-wrapped canonical function.

Layout conventions (JAX-idiomatic; semantic parity with the reference, not
layout parity — its batch axis is trailing and memory is column-major):

    points       (P, N_in)
    rotation     (N_out, N_in)  or (B, N_out, N_in)
    translation  (N_out,)       or (B, N_out)
    background   scalar         or (B,)
    out_weight   scalar         or (B,)
    point_weight scalar or (P,)
    output       (*grid_size)   or (B, *grid_size)
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from dprast import ad
from dprast.ops import dispatch


class RasterGrads(NamedTuple):
    """Gradients of a scalar loss w.r.t. the six `raster` inputs
    (the reference pullback's NamedTuple, `src/raster_pullback.jl:74-81`)."""

    points: jnp.ndarray
    rotation: jnp.ndarray
    translation: jnp.ndarray
    background: jnp.ndarray
    out_weight: jnp.ndarray
    point_weight: jnp.ndarray


def _normalise(grid_size, points, rotation, translation, background,
               out_weight, point_weight, dtype):
    """Coerce to canonical batched form. Returns
    (canonical 6-tuple, batched: bool, squeeze info for pullback)."""
    grid_size = tuple(int(s) for s in grid_size)
    n_out = len(grid_size)
    if n_out < 1:
        raise ValueError("grid_size must have at least one dimension")

    points = jnp.asarray(points)
    if points.ndim != 2:
        raise ValueError(
            f"points must have shape (n_points, N_in); got {points.shape}")
    n_points, n_in = points.shape

    rotation = jnp.asarray(rotation)
    if rotation.ndim == 2:
        batched = False
        rotation = rotation[None]
    elif rotation.ndim == 3:
        batched = True
    else:
        raise ValueError(
            "rotation must be a (N_out, N_in) matrix or a (B, N_out, N_in) "
            f"batch of matrices; got shape {rotation.shape}")
    b = rotation.shape[0]

    translation = jnp.asarray(translation)
    if not batched:
        if translation.ndim != 1:
            raise ValueError(
                "translation must be a vector for a single pose; got shape "
                f"{translation.shape}")
        translation = translation[None]
    else:
        if translation.ndim != 2:
            raise ValueError(
                "translation must have shape (B, N_out) for batched poses; "
                f"got shape {translation.shape}")

    # --- dimension errors, with the reference's wording
    #     (src/interface.jl:146-160) ---
    n_out_trans = translation.shape[-1]
    n_out_rot, n_in_rot = rotation.shape[-2], rotation.shape[-1]
    if n_out_trans != n_out:
        raise ValueError(
            f"Dimension of translation (got {n_out_trans}) and output "
            f"dimension (got {n_out}) must agree!")
    if n_out_rot != n_out:
        raise ValueError(
            f"Row dimension of rotation (got {n_out_rot}) and output "
            f"dimension (got {n_out}) must agree!")
    if n_in_rot != n_in:
        raise ValueError(
            f"Column dimension of rotation (got {n_in_rot}) and points "
            f"(got {n_in}) must agree!")

    # --- batch-size consistency (src/raster.jl:17-21) ---
    if translation.shape[0] != b:
        raise ValueError(
            f"Batch size of rotation (got {b}) and translation (got "
            f"{translation.shape[0]}) must agree!")

    def _per_pose(name, value, default):
        if value is None:
            value = default
        value = jnp.asarray(value)
        if value.ndim == 0:
            return jnp.broadcast_to(value, (b,))
        if value.ndim == 1:
            if value.shape[0] != b:
                raise ValueError(
                    f"Batch size of rotation (got {b}) and {name} (got "
                    f"{value.shape[0]}) must agree!")
            if not batched:
                raise ValueError(
                    f"{name} must be a scalar for a single pose; got shape "
                    f"{value.shape}")
            return value
        raise ValueError(
            f"{name} must be a scalar or a (B,) vector; got shape "
            f"{value.shape}")

    background = _per_pose("background", background, 0.0)
    out_weight = _per_pose("out_weight", out_weight, 1.0)

    if point_weight is None:
        point_weight = 1.0
    point_weight = jnp.asarray(point_weight)
    if point_weight.ndim == 0:
        point_weight = jnp.broadcast_to(point_weight, (n_points,))
    elif point_weight.ndim != 1 or point_weight.shape[0] != n_points:
        raise ValueError(
            f"point_weight must be a scalar or a (n_points,) vector; got "
            f"shape {point_weight.shape} for {n_points} points")

    # --- dtype promotion (src/interface.jl:63-64), floored at float32 ---
    if dtype is None:
        dtype = jnp.promote_types(
            jnp.result_type(points, rotation, translation, background,
                            out_weight, point_weight),
            jnp.float32,
        )
    args = tuple(
        a.astype(dtype)
        for a in (points, rotation, translation, background, out_weight,
                  point_weight))
    return grid_size, args, batched


def raster(grid_size, points, rotation, translation, background=None,
           out_weight=None, point_weight=None, *, dtype=None,
           backend: str = "auto"):
    """Rasterise a point cloud into an N-dimensional grid (differentiable).

    Each point ``p`` is transformed to ``q = rotation @ p + translation`` and,
    if it falls inside the hypercube (-1, 1)^N, its total weight
    ``out_weight * point_weight`` is distributed onto the 2^N nearest voxels
    by multilinear interpolation.  The output is initialised to `background`.
    (Reference semantics: `src/interface.jl:1-48`, `src/raster.jl:5-108`.)

    Args:
      grid_size: tuple of N_out ints — output grid shape (static).
      points: (P, N_in) array of point coordinates.
      rotation: (N_out, N_in) matrix — or (B, N_out, N_in) for a batch of
        poses.  May include an orthographic projection (N_out < N_in).
      translation: (N_out,) — or (B, N_out) — applied *after* rotation, in
        output-space units.
      background: scalar — or (B,) per pose. Default 0.
      out_weight: scalar — or (B,) per pose. Default 1.
      point_weight: scalar or (P,) per point. Default 1.
      dtype: result dtype; defaults to the promoted input dtype (>= float32).
      backend: 'auto' | 'xla' | 'matmul' | 'matmul_bf16' kernel strategy
        (`dispatch.resolve`; 'matmul_bf16' is `matmul` with ~2e-3
        relative error).

    Returns:
      (*grid_size) array for a single pose, (B, *grid_size) for a batch.
    """
    grid_size, args, batched = _normalise(
        grid_size, points, rotation, translation, background, out_weight,
        point_weight, dtype)
    resolved = dispatch.resolve(backend, len(grid_size))
    if args[0].shape[0] == 0:
        # empty cloud: the background image (all backends chunk by points)
        b = args[1].shape[0]
        out = jnp.broadcast_to(
            args[3].reshape((b,) + (1,) * len(grid_size)),
            (b,) + grid_size)
        return out if batched else out[0]
    out = ad.raster_canonical(grid_size, resolved, *args)
    return out if batched else out[0]


def raster_pullback(ds_dout, points, rotation, translation, background=None,
                    out_weight=None, point_weight=None, *, dtype=None,
                    backend: str = "auto") -> RasterGrads:
    """Analytic pullback of :func:`raster` (gradients for all six inputs).

    Takes the cotangent `ds_dout` of the output (shape (*grid_size) or
    (B, *grid_size)) plus the *same arguments* given to `raster`, and returns
    a :class:`RasterGrads`.  Equivalent of the reference's `raster_pullback!`
    (`src/interface.jl:165-190`).  Gradient shapes mirror the input forms:
    batched inputs get per-pose gradients; a single pose gets squeezed ones;
    scalars that were broadcast get summed gradients.
    """
    ds_dout = jnp.asarray(ds_dout)
    bg_scalar = background is None or jnp.ndim(background) == 0
    ow_scalar = out_weight is None or jnp.ndim(out_weight) == 0
    pw_scalar = point_weight is not None and jnp.ndim(point_weight) == 0
    grid_size, args, batched = _normalise(
        tuple(ds_dout.shape[1:] if jnp.ndim(rotation) == 3 else ds_dout.shape),
        points, rotation, translation, background, out_weight, point_weight,
        dtype)
    if not batched:
        ds_dout = ds_dout[None]
    if ds_dout.shape != (args[1].shape[0],) + grid_size:
        raise ValueError(
            f"ds_dout shape {ds_dout.shape} does not match output shape "
            f"{(args[1].shape[0],) + grid_size}")
    resolved = dispatch.resolve(backend, len(grid_size))
    if args[0].shape[0] == 0:
        b = args[1].shape[0]
        g = ds_dout.astype(args[0].dtype)
        res = (jnp.zeros_like(args[0]), jnp.zeros_like(args[1]),
               jnp.zeros_like(args[2]), jnp.sum(g.reshape(b, -1), axis=-1),
               jnp.zeros((b,), args[0].dtype),
               jnp.zeros((0,), args[0].dtype))
    else:
        res = dispatch.bwd_fn(resolved)(grid_size, *args,
                                        ds_dout.astype(args[0].dtype))
    d_points, d_rot, d_trans, d_bg, d_ow, d_pw = res
    if not batched:
        d_rot, d_trans = d_rot[0], d_trans[0]
        d_bg, d_ow = d_bg[0], d_ow[0]
    else:
        if bg_scalar and background is not None:
            d_bg = jnp.sum(d_bg)
        if ow_scalar and out_weight is not None:
            d_ow = jnp.sum(d_ow)
    if pw_scalar:
        d_pw = jnp.sum(d_pw)
    return RasterGrads(points=d_points, rotation=d_rot, translation=d_trans,
                       background=d_bg, out_weight=d_ow, point_weight=d_pw)
