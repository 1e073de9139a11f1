"""`shard_map`-based multi-device rasterisation over a ("poses", "points") mesh.

Sharding layout (SURVEY §7.5; the multi-device counterpart of the reference's
atomics/thread-slabs, see `dprast.parallel` module docstring):

    points       (P, N_in)        sharded over "points", replicated over "poses"
    point_weight (P,)             sharded over "points"
    rotation     (B, N_out, N_in) sharded over "poses",  replicated over "points"
    translation  (B, N_out)       sharded over "poses"
    background   (B,)             sharded over "poses"
    out_weight   (B,)             sharded over "poses"
    output       (B, *grid)       sharded over "poses",  replicated over "points"

Forward: every points-shard rasterises its point subset into a full partial
image per local pose (background excluded), the partials are `psum`-reduced
over the "points" axis, and the per-pose background is added once after the
reduction.  Backward (derived automatically by JAX from the vma-typed
forward): point gradients are shard-local then `psum`-ed over "poses";
pose gradients (rotation/translation/out_weight) are `psum`-ed over "points";
background gradients need no collective at all.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dprast import ad, api
from dprast.ops import dispatch

POSES_AXIS = "poses"
POINTS_AXIS = "points"


def make_mesh(n_poses_shards: int | None = None,
              n_points_shards: int | None = None,
              devices=None) -> Mesh:
    """A 2-axis device mesh ("poses", "points").

    Defaults: all available devices on the "poses" axis (pose batches are the
    embarrassingly-parallel axis, like the reference's CPU batch chunking,
    `src/raster_pullback.jl:117`), one "points" shard.
    """
    devices = jax.devices() if devices is None else list(devices)
    n = len(devices)
    if n_poses_shards is None and n_points_shards is None:
        n_poses_shards, n_points_shards = n, 1
    elif n_poses_shards is None:
        n_poses_shards = n // n_points_shards
    elif n_points_shards is None:
        n_points_shards = n // n_poses_shards
    if n_poses_shards * n_points_shards != n:
        raise ValueError(
            f"mesh {n_poses_shards}x{n_points_shards} != {n} devices")
    dev_grid = np.asarray(devices).reshape(n_poses_shards, n_points_shards)
    return Mesh(dev_grid, (POSES_AXIS, POINTS_AXIS))


def _under_trace() -> bool:
    """True inside a jit/grad trace (constants must then stay host-local:
    global arrays created at trace time become non-addressable jit
    constants XLA cannot fetch).  Uses a private JAX probe with a
    conservative fallback — `put` additionally guards the global-array
    path with try/except."""
    try:  # pragma: no branch
        from jax._src import core as _core
        return not _core.trace_state_clean()
    except Exception:  # pragma: no cover - private API moved
        return False


def _pad_to_multiple(x, multiple, axis=0, fill=0.0):
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - size)
    return jnp.pad(x, pad, constant_values=fill)


def shard_raster_args(mesh: Mesh, points, rotation, translation, background,
                      out_weight, point_weight):
    """Pad canonical batched args to shardable sizes and place them on the
    mesh with the module-level layout.  Padded points get weight 0 (their
    splats are dropped by the zero weight, not by masking); padded poses
    get out_weight 0 and background 0 (all-zero images the caller slices
    away).

    Returns (placed 6-tuple, original n_points, original batch).
    """
    np_shards = mesh.shape[POINTS_AXIS]
    nb_shards = mesh.shape[POSES_AXIS]
    p = points.shape[0]
    b = rotation.shape[0]
    points = _pad_to_multiple(points, np_shards)
    point_weight = _pad_to_multiple(point_weight, np_shards)
    # uneven pose batches: pad with inert poses (out_weight 0 — their
    # splats vanish; background 0 — their images are all-zero) and let the
    # caller slice the output back to `b`.  Mirrors the reference's
    # any-batch-vs-any-worker-count chunking contract (`test/data.jl:5-11`
    # keeps the fixture batch coprime to nthreads on purpose).
    rotation = _pad_to_multiple(rotation, nb_shards)
    translation = _pad_to_multiple(translation, nb_shards)
    background = _pad_to_multiple(background, nb_shards)
    out_weight = _pad_to_multiple(out_weight, nb_shards)

    def put(x, spec):
        sh = NamedSharding(mesh, spec)
        # Multi-process meshes: `device_put` cannot reshard onto devices
        # this process does not address; assemble the global array from
        # the (process-replicated) host value instead.  Tracers (e.g.
        # `jax.grad` through `raster_sharded` — wrap it in `jax.jit` on
        # multi-process runs) and single-process meshes keep the plain
        # `device_put`, which also works under tracing.
        if (not isinstance(x, jax.core.Tracer) and not _under_trace()
                and not sh.is_fully_addressable):
            arr = np.asarray(x)
            try:
                return jax.make_array_from_callback(
                    arr.shape, sh, lambda idx: arr[idx])
            except Exception:  # pragma: no cover - trace-detect fallback
                pass
        return jax.device_put(x, sh)

    placed = (
        put(points, P(POINTS_AXIS, None)),
        put(rotation, P(POSES_AXIS, None, None)),
        put(translation, P(POSES_AXIS, None)),
        put(background, P(POSES_AXIS)),
        put(out_weight, P(POSES_AXIS)),
        put(point_weight, P(POINTS_AXIS)),
    )
    return placed, p, b


def raster_sharded(grid_size, points, rotation, translation, background=None,
                   out_weight=None, point_weight=None, *, mesh: Mesh,
                   dtype=None, backend: str = "auto"):
    """Differentiable multi-device rasterisation.

    Same semantics as :func:`dprast.raster` on batched args, executed as a
    `jax.shard_map` over `mesh` (axes "poses" and "points").  Inputs may be
    numpy/unplaced (they will be padded + placed via
    :func:`shard_raster_args`) or already placed with the documented layout.

    Returns a (B, *grid_size) array sharded over the "poses" axis.
    """
    grid_size, args, batched = api._normalise(
        grid_size, points, rotation, translation, background, out_weight,
        point_weight, dtype)
    if not batched:
        raise ValueError("raster_sharded requires batched poses")
    if args[0].shape[0] == 0:
        # empty cloud: the background image, sharded over poses (mirrors
        # api.raster's guard; backends chunk by points and cannot run P=0)
        dispatch.resolve(backend, len(grid_size))  # validate
        b = args[1].shape[0]
        out = jnp.broadcast_to(
            args[3].reshape((b,) + (1,) * len(grid_size)),
            (b,) + grid_size)
        # replicated placement: valid for any batch vs poses-axis size
        return jax.device_put(out, NamedSharding(mesh, P()))
    args, _, b = shard_raster_args(mesh, *args)
    resolved = dispatch.resolve(backend, len(grid_size))
    out = _raster_shard_map(grid_size, resolved, mesh, *args)
    return out if out.shape[0] == b else out[:b]


def _raster_shard_map(grid_size, backend, mesh, points, rotation, translation,
                      background, out_weight, point_weight):
    n_out = len(grid_size)

    def vary(x, axis):
        return lax.pcast(x, axis, to="varying")

    def local(pts, rot, tr, bg, ow, pw):
        # Cross-axis operands: points vary over "points", poses over "poses";
        # the kernel output varies over both until the psum.
        pts = vary(pts, POSES_AXIS)
        pw = vary(pw, POSES_AXIS)
        rot = vary(rot, POINTS_AXIS)
        tr = vary(tr, POINTS_AXIS)
        ow = vary(ow, POINTS_AXIS)
        zero_bg = jnp.zeros_like(vary(bg, POINTS_AXIS))
        partial = ad.raster_canonical(grid_size, backend, pts, rot, tr,
                                      zero_bg, ow, pw)
        # Replaces the reference's atomic adds on the shared output image
        # (src/raster.jl:64): partial per-shard images, one reduction
        # across devices.
        total = lax.psum(partial, POINTS_AXIS)
        return total + bg.reshape((-1,) + (1,) * n_out)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(POINTS_AXIS, None), P(POSES_AXIS, None, None),
                  P(POSES_AXIS, None), P(POSES_AXIS), P(POSES_AXIS),
                  P(POINTS_AXIS)),
        out_specs=P(POSES_AXIS, *([None] * n_out)),
        check_vma=True,
    )
    return fn(points, rotation, translation, background, out_weight,
              point_weight)
