"""Pure-jnp reference implementation (the oracle, and the any-dims fallback).

Works for any static (N_in, N_out) with N_in >= N_out, on CPU and GPU.  The
forward uses an XLA scatter-add with `mode='drop'`, which XLA lowers to
atomic adds on the GPU — the reference's own CUDA forward
(`src/raster.jl:64`, `Atomix.@atomic`).  The pullback is a pure gather plus
reductions and therefore needs no conflict resolution at all (reference
`src/raster_pullback.jl:39-73`; its CUDA kernel,
`ext/DiffPointRasterisationCUDAExt.jl:19-210`, does the same gather with
hand-written shared-memory reductions).

Because the GPU scatter-add uses atomics, the order of each output sum
changes from run to run; results agree to float32 rounding, not bit for
bit.  `XLA_FLAGS=--xla_gpu_deterministic_ops=true` makes repeats bitwise
equal, but XLA then serialises the scatter: the 128^2 x 8 poses x 1e5
points forward took ~34 s instead of ~0.8 ms on an H100 (PERF.md) — an
option for debugging, not for training.

All functions here take *canonical batched* arguments:

    points       (P, N_in)
    rotation     (B, N_out, N_in)
    translation  (B, N_out)
    background   (B,)
    out_weight   (B,)
    point_weight (P,)
    out          (B, *grid_size)       # leading batch axis (JAX-idiomatic;
                                       # the reference uses a trailing one)
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dprast.ops import geometry


class PullbackResult(NamedTuple):
    """Gradients w.r.t. the six canonical inputs
    (reference `src/raster_pullback.jl:74-81` NamedTuple)."""

    points: jnp.ndarray        # (P, N_in)
    rotation: jnp.ndarray      # (B, N_out, N_in)
    translation: jnp.ndarray   # (B, N_out)
    background: jnp.ndarray    # (B,)
    out_weight: jnp.ndarray    # (B,)
    point_weight: jnp.ndarray  # (P,)


def _neighbour_data(points, rotation, translation, grid_size):
    """Shared forward/backward recompute: neighbour indices, validity mask,
    per-shift multilinear weights and deltas.

    Returns (idx_flat (B,P,S) int32 with OOB mapped to `total`,
             wsplat (B,P,S), dl (B,P,N_out), shifts (S,N_out)).
    """
    n_out = len(grid_size)
    shifts = jnp.asarray(geometry.voxel_shifts(n_out))
    # compensated double-f32 coordinates: a plain-f32 transform has
    # ~n/2*2^-23 absolute coordinate error (3e-5 at n=1024) — above the
    # 1e-5 parity contract on its own.
    r0, dl = geometry.pose_voxel_and_deltas(points, rotation, translation,
                                            grid_size)
    idx = r0[..., None, :] + shifts  # (B, P, S, N_out)
    sizes = jnp.asarray(grid_size, dtype=jnp.int32)
    inb = jnp.all((idx >= 0) & (idx < sizes), axis=-1)  # (B, P, S)
    strides = jnp.asarray(geometry.flat_strides(grid_size))
    total = int(math.prod(grid_size))
    idx_flat = jnp.sum(idx * strides, axis=-1)
    # out-of-bounds → one-past-the-end so scatter mode='drop' / masked gather
    # reproduce the reference's silent per-neighbour drop (src/raster.jl:62).
    idx_flat = jnp.where(inb, idx_flat, total)
    wsplat = geometry.splat_weights(dl, shifts)  # (B, P, S)
    return idx_flat, wsplat, dl, shifts


def raster_fwd(grid_size, points, rotation, translation, background,
               out_weight, point_weight):
    """Forward rasterisation on canonical batched args → (B, *grid_size).

    Semantics per reference `src/raster.jl:5-66`: output initialised to the
    per-pose background, every point splats ``out_weight[b] * point_weight[p]``
    multilinearly onto its 2^N neighbours, OOB neighbours dropped.
    """
    out, _ = raster_fwd_res(grid_size, points, rotation, translation,
                            background, out_weight, point_weight)
    # (the unused residuals are dead code XLA eliminates)
    return out


def raster_fwd_res(grid_size, points, rotation, translation, background,
                   out_weight, point_weight):
    """Forward + reusable neighbour-geometry residuals.

    The fused `jax.grad` pair (see `dprast.ad`): residuals are the
    recompute-shared `(idx_flat, wsplat, dl)` of `_neighbour_data` —
    (B, P, S) int32/f32 + (B, P, N_out) f32, a few MB at every supported
    size — so the pullback skips the compensated double-f32 transform and
    the neighbour/validity enumeration.  (The reference recomputes these,
    `src/raster_pullback.jl:20-22`, because its CPU loop is cache-hot;
    under XLA the recompute is whole extra HBM passes.)"""
    b = rotation.shape[0]
    total = int(math.prod(grid_size))
    idx_flat, wsplat, dl, _ = _neighbour_data(points, rotation, translation,
                                              grid_size)
    w = wsplat * out_weight[:, None, None] * point_weight[None, :, None]

    def scatter_one(flat_idx, vals, bg):
        out = jnp.full((total,), bg, dtype=vals.dtype)
        return out.at[flat_idx.reshape(-1)].add(
            vals.reshape(-1), mode="drop", indices_are_sorted=False,
            unique_indices=False)

    out_flat = jax.vmap(scatter_one)(idx_flat, w, background)
    return (out_flat.reshape((b,) + tuple(grid_size)),
            (idx_flat, wsplat, dl))


def raster_pullback_res(grid_size, residuals, args,
                        ds_dout) -> PullbackResult:
    """Pullback reusing `raster_fwd_res` residuals (skips
    `_neighbour_data`'s transform + neighbour enumeration)."""
    points, rotation, _, _, out_weight, point_weight = args
    idx_flat, wsplat, dl = residuals
    return _pullback_impl(grid_size, points, rotation, out_weight,
                          point_weight, ds_dout, idx_flat, wsplat, dl)


def raster_pullback(grid_size, points, rotation, translation, background,
                    out_weight, point_weight, ds_dout) -> PullbackResult:
    """Analytic pullback on canonical batched args.

    Pure gather: recomputes the forward neighbour geometry (the reference's
    recompute-not-cache strategy, `src/raster_pullback.jl:20-22`), reads the
    2^N cotangent values per (point, pose) and contracts:

      ds/du_i     = sum_s g * ow * pw * dW_s/ddl_i          (.jl:60-65)
      scaled      = ds/du * (n/2)                            (.jl:67)
      ds/dt       = sum_p scaled                             (.jl:68)
      ds/dR       = sum_p scaled ⊗ p                         (.jl:69)
      ds/dp       = sum_b R^T scaled                         (.jl:70-71)
      ds/dbg      = sum_grid ds_dout                         (.jl:78)
      ds/dow      = sum_{p,s} g * W_s * pw                   (.jl:57)
      ds/dpw      = sum_{b,s} g * W_s * ow                   (.jl:58)
    """
    idx_flat, wsplat, dl, _ = _neighbour_data(points, rotation,
                                              translation, grid_size)
    return _pullback_impl(grid_size, points, rotation, out_weight,
                          point_weight, ds_dout, idx_flat, wsplat, dl)


def _pullback_impl(grid_size, points, rotation, out_weight, point_weight,
                   ds_dout, idx_flat, wsplat, dl) -> PullbackResult:
    shifts = jnp.asarray(geometry.voxel_shifts(len(grid_size)))
    b = rotation.shape[0]
    g_flat = ds_dout.reshape(b, -1)

    def gather_one(gf, flat_idx):
        # OOB indices were mapped to `total`; mode='fill' returns 0 there.
        return gf.at[flat_idx.reshape(-1)].get(mode="fill", fill_value=0)

    g = jax.vmap(gather_one)(g_flat, idx_flat).reshape(idx_flat.shape)  # (B,P,S)

    gw = g * wsplat
    ds_dout_weight = jnp.einsum("bps,p->b", gw, point_weight,
                                precision=jax.lax.Precision.HIGHEST)
    ds_dpoint_weight = jnp.einsum("bps,b->p", gw, out_weight,
                                  precision=jax.lax.Precision.HIGHEST)

    factor = g * (out_weight[:, None] * point_weight[None, :])[..., None]
    dw_ddl = geometry.splat_weight_grads(dl, shifts)  # (B,P,S,N_out)
    ds_du = jnp.einsum("bps,bpsn->bpn", factor, dw_ddl,
                       precision=jax.lax.Precision.HIGHEST)
    scale = jnp.asarray(grid_size, dtype=ds_du.dtype) / 2
    scaled = ds_du * scale  # (B, P, N_out)

    ds_dtranslation = jnp.sum(scaled, axis=1)
    ds_drotation = jnp.einsum("bpo,pi->boi", scaled, points,
                              precision=jax.lax.Precision.HIGHEST)
    ds_dpoints = jnp.einsum("boi,bpo->pi", rotation, scaled,
                            precision=jax.lax.Precision.HIGHEST)
    ds_dbackground = jnp.sum(g_flat, axis=-1)

    return PullbackResult(
        points=ds_dpoints,
        rotation=ds_drotation,
        translation=ds_dtranslation,
        background=ds_dbackground,
        out_weight=ds_dout_weight,
        point_weight=ds_dpoint_weight,
    )
