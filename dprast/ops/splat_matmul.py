"""Scatter-free one-hot contraction formulation of the multilinear splat.

The splat weight factorises over output axes.  Split the stencil of the
LAST (minor) axis into its two branches ``sx in {0, 1}`` and write the
one-hot of column ``r0_x + sx`` as an EXACT 0/1 matrix ``O_sx`` (exactly
representable in bf16); everything else — the product of the leading-axis
pair factors, the per-point weight and the branch weight ``w_sx(dl_x)`` —
is a dense f32 "value" operand ``V_sx``.  The forward is then

    out[b] = bg[b] + ow[b] * sum_sx einsum('pr,px->rx', V_sx, O_sx)

i.e. dense batched matrix products with **no scatter and no atomics**, in
place of the reference's atomic adds (`src/raster.jl:64`) and its CUDA
shared-memory reductions (`ext/DiffPointRasterisationCUDAExt.jl:107-191`).
Out-of-grid neighbours drop out automatically because the iota comparison
never matches (`src/raster.jl:62` drop semantics).

Precision: each ``V`` is decomposed into an error-free sum of `terms` bf16
planes (via `lax.reduce_precision` — an ``astype`` round-trip would be
elided by XLA's excess-precision pass, silently collapsing the
decomposition) and each plane meets the exact one-hot in one bf16 product
with float32 accumulation (`preferred_element_type`): on the GPU's tensor
cores every bf16 x {0,1} product is exact and only the float32 sums
round.  With no cross terms, 3 planes reproduce
every product to ~2^-24 and 2 planes to ~2^-17; both sit inside the
≤1e-5 reference-parity contract against the f64 oracle.

The backward reuses the SAME selection family: ``T_sx = O_sx @ g`` gathers,
per point, the two x-stencil columns of the cotangent across all
leading-axis rows; every gradient then follows from fused elementwise row
reductions against the leading-axis pair factors.  ONE exact selection
(2 branches, all `terms` planes concatenated along the contraction axis)
replaces the two dense f32 contractions a direct transpose needs.
Point/pose/weight gradients follow exactly as in the reference
(`src/raster_pullback.jl:67-72`).

Points are processed in static-size chunks via `lax.scan` so transient
operands stay bounded.  float64 inputs (CPU tests; the reference runs its
suite in Float64) skip the bf16 decomposition and run the same branch dots
at `Precision.HIGHEST` in the input dtype.  Every other float32
contraction here also passes `Precision.HIGHEST`, so none runs in TF32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from dprast.ops import geometry
from dprast.ops.core import PullbackResult

# Error-free bf16 planes per value operand; 1 plane = the
# 'matmul_bf16' backend (~2e-3 relative error).  The forward pays one
# product per plane, so it takes 2 planes (~2^-17 relative per product);
# the backward concatenates its planes along the contraction axis of a
# single selection product (a plane only deepens K), so it takes 3.
FWD_TERMS = 2
BWD_TERMS = 3


def supported(n_out: int) -> bool:
    return n_out in (1, 2, 3)


def _split_planes(x, terms):
    """Error-free decomposition of f32 `x` into `terms` bf16 planes via
    `lax.reduce_precision` (see module docstring for why not astype)."""
    planes = []
    rem = x
    for i in range(terms):
        t = rem if i == terms - 1 else lax.reduce_precision(rem, 8, 7)
        planes.append(t.astype(jnp.bfloat16))
        rem = rem - t
    return planes


def _branch_dot(spec, value, onehot_mask, terms):
    """``einsum(spec, value, onehot)``: bf16 planes x exact 0/1 one-hot
    with f32 accumulation; float64 runs one HIGHEST dot instead."""
    if value.dtype == jnp.float64:
        return jnp.einsum(spec, value, onehot_mask.astype(jnp.float64),
                          precision=lax.Precision.HIGHEST)
    o = onehot_mask.astype(jnp.bfloat16)
    out = None
    for vt in _split_planes(value, terms):
        part = jnp.einsum(spec, vt, o, preferred_element_type=jnp.float32)
        out = part if out is None else out + part
    return out


def _pick_chunk(n_points: int, batch: int, grid_size) -> int:
    """Static point-chunk size: bound the transient (B, C, R) value operand
    to ~128 MiB while keeping the contraction dimension large."""
    if len(grid_size) == 3:
        width = grid_size[0] * grid_size[1] + sum(grid_size)
    else:
        width = sum(grid_size)
    budget = 128 * 1024 * 1024
    chunk = budget // max(1, 4 * batch * width)
    chunk = max(8, min(n_points, chunk))
    # lower bound 8 also covers the degenerate P=0 call (a zero chunk
    # would divide by zero in _chunked)
    return max(8, min(int(-(-n_points // 8) * 8), int(-(-chunk // 8) * 8)))


def _chunked(points, point_weight, chunk):
    """Pad the point axis to a multiple of `chunk` and reshape to
    (K, chunk, ...) for lax.scan. Padded entries are masked via `valid`."""
    p = points.shape[0]
    k = -(-p // chunk)
    pad = k * chunk - p
    pts = jnp.pad(points, ((0, pad), (0, 0)))
    pw = jnp.pad(point_weight, (0, pad))
    valid = jnp.arange(k * chunk) < p
    return (pts.reshape(k, chunk, -1), pw.reshape(k, chunk),
            valid.reshape(k, chunk), k, pad)


def _axis_pair(r0_ax, dl_ax, n, cdt):
    """Dense pair factor (A, dA) for one leading axis: (B, C, n) with
    ``1-dl`` at row r0 and ``dl`` at row r0+1 (dA: -1/+1 there);
    out-of-grid rows never match."""
    h = lax.broadcasted_iota(jnp.int32, (1, 1, n), 2)
    lo = h == r0_ax[..., None]
    hi = h == (r0_ax[..., None] + 1)
    dl = dl_ax[..., None].astype(cdt)
    one = jnp.asarray(1, cdt)
    a = jnp.where(lo, 1 - dl, 0) + jnp.where(hi, dl, 0)
    da = jnp.where(hi, one, 0) - jnp.where(lo, one, 0)
    return a, da


def _compute_dtype(*dtypes):
    d = jnp.result_type(*dtypes)
    return jnp.dtype(jnp.float64 if d == jnp.float64 else jnp.float32)


def raster_fwd(grid_size, points, rotation, translation, background,
               out_weight, point_weight, *, chunk: int | None = None,
               terms: int = FWD_TERMS):
    """Forward rasterisation via exact-one-hot branch contractions.

    Canonical batched args (see `dprast.ops.core`) → (B, *grid_size).
    """
    n_out = len(grid_size)
    assert supported(n_out), \
        f"matmul path supports N_out in (1,2,3), got {n_out}"
    b = rotation.shape[0]
    p, _ = points.shape
    if chunk is None:
        chunk = _pick_chunk(p, b, grid_size)
    pts_k, pw_k, valid_k, k, _ = _chunked(points, point_weight, chunk)
    dtype = jnp.result_type(points.dtype, rotation.dtype, translation.dtype)
    cdt = _compute_dtype(points.dtype, rotation.dtype, translation.dtype)
    nx = grid_size[-1]

    def step(acc, xs):
        pts_c, pw_c, valid_c = xs
        r0, dl = geometry.pose_voxel_and_deltas(pts_c, rotation,
                                                translation, grid_size)
        # leading-axis dense value factor (B, C, R), point weight folded in
        lead = (pw_c.astype(cdt)[None, :]
                * valid_c[None, :].astype(cdt))[..., None]
        for i in range(n_out - 1):
            a_i, _ = _axis_pair(r0[..., i], dl[..., i], grid_size[i], cdt)
            lead = (lead * a_i if i == 0 else
                    (lead[..., :, None] * a_i[..., None, :]).reshape(
                        b, chunk, -1))
        dlx = dl[..., n_out - 1].astype(cdt)
        xiota = lax.broadcasted_iota(jnp.int32, (1, 1, nx), 2)
        upd = None
        for s, wx in ((0, 1 - dlx), (1, dlx)):
            o = xiota == (r0[..., n_out - 1] + s)[..., None]
            part = _branch_dot("bpr,bpx->brx", lead * wx[..., None], o,
                               terms)
            upd = part if upd is None else upd + part
        return acc + upd.reshape(acc.shape), None

    acc0 = geometry.zeros_vma((b,) + tuple(grid_size), cdt, points,
                              rotation, translation, out_weight,
                              point_weight)
    acc, _ = lax.scan(step, acc0, (pts_k, pw_k, valid_k))
    out = acc * out_weight.reshape((b,) + (1,) * n_out).astype(cdt)
    out = out + background.reshape((b,) + (1,) * n_out).astype(cdt)
    return out.astype(dtype)


def raster_pullback(grid_size, points, rotation, translation, background,
                    out_weight, point_weight, ds_dout, *,
                    chunk: int | None = None,
                    terms: int = BWD_TERMS) -> PullbackResult:
    """Analytic pullback via one exact selection-matmul family per chunk
    (gather-free AND scatter-free).  Returns `PullbackResult`."""
    n_out = len(grid_size)
    assert supported(n_out)
    b = rotation.shape[0]
    p, n_in = points.shape
    if chunk is None:
        chunk = _pick_chunk(p, b, grid_size)
    pts_k, pw_k, valid_k, k, pad = _chunked(points, point_weight, chunk)
    dtype = jnp.result_type(points.dtype, rotation.dtype, ds_dout.dtype)
    cdt = _compute_dtype(points.dtype, rotation.dtype, ds_dout.dtype)

    nx = grid_size[-1]
    r_lead = 1
    for g_ in grid_size[:-1]:
        r_lead *= g_
    g = ds_dout.astype(cdt)
    gf = g.reshape(b, r_lead, nx)
    light = lax.Precision.HIGHEST
    # hoisted: the cotangent's bf16 planes, CONCATENATED along the lane
    # axis, are shared by every chunk.  Each branch selection is then ONE
    # dot whose contraction runs over all planes at once (a separate dot
    # per plane would materialise a full (B, C, R) f32 output each).
    if cdt == jnp.float64:
        g_cat = gf
        xiota = lax.broadcasted_iota(jnp.int32, (1, 1, nx), 2)
    else:
        g_cat = jnp.concatenate(_split_planes(gf, terms), axis=-1)
        xiota = lax.broadcasted_iota(jnp.int32, (1, 1, terms * nx), 2) % nx

    def selection(o_mask):
        """T = O @ g_cat over the (plane-tiled) lane axis: (B, C, R)
        per-point selected cotangent columns, exact to the plane sum."""
        if cdt == jnp.float64:
            return jnp.einsum("bpx,brx->bpr", o_mask.astype(cdt), g_cat,
                              precision=light)
        return jnp.einsum("bpx,brx->bpr", o_mask.astype(jnp.bfloat16),
                          g_cat, preferred_element_type=jnp.float32)

    def step(carry, xs):
        pts_c, pw_c, valid_c = xs
        r0, dl = geometry.pose_voxel_and_deltas(pts_c, rotation,
                                                translation, grid_size)
        t0 = selection(xiota == r0[..., n_out - 1][..., None])
        t1 = selection(xiota == (r0[..., n_out - 1] + 1)[..., None])
        dlx = dl[..., n_out - 1].astype(cdt)[..., None]
        v1 = (1 - dlx) * t0 + dlx * t1                    # (B, C, R)
        dvx = t1 - t0

        vmask = valid_c[None, :].astype(cdt)
        if n_out == 1:
            gW = v1[..., 0] * vmask
            ds_du = (dvx[..., 0] * vmask)[..., None]
        elif n_out == 2:
            ay, day = _axis_pair(r0[..., 0], dl[..., 0], grid_size[0], cdt)
            gW = jnp.sum(ay * v1, axis=-1) * vmask
            du_y = jnp.sum(day * v1, axis=-1) * vmask
            du_x = jnp.sum(ay * dvx, axis=-1) * vmask
            ds_du = jnp.stack([du_y, du_x], axis=-1)
        else:
            gz, gy = grid_size[0], grid_size[1]
            az, daz = _axis_pair(r0[..., 0], dl[..., 0], gz, cdt)
            ay, day = _axis_pair(r0[..., 1], dl[..., 1], gy, cdt)
            v1zy = v1.reshape(b, chunk, gz, gy)
            dvzy = dvx.reshape(b, chunk, gz, gy)
            ey = jnp.einsum("bpy,bpzy->bpz", ay, v1zy, precision=light)
            gW = jnp.sum(az * ey, axis=-1) * vmask
            du_z = jnp.sum(daz * ey, axis=-1) * vmask
            du_y = jnp.einsum("bpz,bpy,bpzy->bp", az, day, v1zy,
                              precision=light) * vmask
            du_x = jnp.einsum("bpz,bpy,bpzy->bp", az, ay, dvzy,
                              precision=light) * vmask
            ds_du = jnp.stack([du_z, du_y, du_x], axis=-1)

        # weight gradients from gW = sum_s g · W_s per (b, p)
        d_ow = jnp.einsum("bp,p->b", gW, pw_c.astype(cdt), precision=light)
        d_pw = jnp.einsum("bp,b->p", gW, out_weight.astype(cdt),
                          precision=light)

        scale = jnp.asarray(grid_size, cdt) / 2
        coeff = (out_weight.astype(cdt)[:, None]
                 * pw_c.astype(cdt)[None, :])[..., None]
        scaled = ds_du * coeff * scale                    # (B, C, N_out)

        d_t = jnp.sum(scaled, axis=1)
        d_r = jnp.einsum("bpo,pi->boi", scaled, pts_c.astype(cdt),
                         precision=light)
        d_p = jnp.einsum("boi,bpo->pi", rotation.astype(cdt), scaled,
                         precision=light)

        c_t, c_r, c_ow = carry
        return (c_t + d_t, c_r + d_r, c_ow + d_ow), (d_p, d_pw)

    like = (points, rotation, translation, out_weight, point_weight, ds_dout)
    carry0 = (geometry.zeros_vma((b, n_out), cdt, *like),
              geometry.zeros_vma((b, n_out, n_in), cdt, *like),
              geometry.zeros_vma((b,), cdt, *like))
    (d_t, d_r, d_ow), (d_p_k, d_pw_k) = lax.scan(
        step, carry0, (pts_k, pw_k, valid_k))

    d_points = d_p_k.reshape(k * chunk, n_in)[:p]
    d_pw = d_pw_k.reshape(k * chunk)[:p]
    d_bg = jnp.sum(g.reshape(b, -1), axis=-1)

    cast = lambda a: a.astype(dtype)
    return PullbackResult(points=cast(d_points), rotation=cast(d_r),
                          translation=cast(d_t), background=cast(d_bg),
                          out_weight=cast(d_ow), point_weight=cast(d_pw))
