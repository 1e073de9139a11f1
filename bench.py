"""Flagship benchmark: fwd+bwd points·splats/s on one GPU.

Config = BASELINE config 3 (the reference README's best-GPU row): 10^5
points, 64 poses, 3D→2D orthographic projection onto a 128² grid, default
(unit) point weights as in the reference's timing table.  Baseline = the
A100 reference number, 10^5·64·4 splats / (153 ms fwd + 9 ms bwd) ≈
1.58e8 points·splats/s.  The backward computes the reference's three
gradients (points, rotation, translation).

Each direction is the median of 10 calls on a host clock around
`block_until_ready`, after warm-up.  Refuses to run anywhere but a GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "detail"}.
"""

from __future__ import annotations

import json
import sys

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    import dprast
    from dprast.ops import dispatch
    from dprast.utils import compile_cache, profiling

    device = profiling.device_record()
    if device["platform"] != "gpu":
        sys.exit(f"bench.py times the GPU; JAX's device is "
                 f"{device['platform']}")
    compile_cache.enable()

    n_points, batch, grid = 100_000, 64, (128, 128)
    rng = np.random.default_rng(0)
    points = jnp.asarray(rng.standard_normal((n_points, 3)) * 0.4,
                         jnp.float32)
    angles = rng.uniform(0, 2 * np.pi, batch)
    c, s = np.cos(angles), np.sin(angles)
    rot = np.zeros((batch, 2, 3), np.float32)
    rot[:, 0, 0], rot[:, 0, 2] = c, -s
    rot[:, 1, 1] = 1.0
    rotation = jnp.asarray(rot)
    translation = jnp.asarray(rng.standard_normal((batch, 2)) * 0.1,
                              jnp.float32)
    ds_dout = jnp.asarray(
        rng.standard_normal((batch,) + grid), jnp.float32)

    fwd = jax.jit(lambda p, r, t: dprast.raster(grid, p, r, t))

    @jax.jit
    def bwd(g, p, r, t):
        res = dprast.raster_pullback(g, p, r, t)
        return res.points, res.rotation, res.translation

    t_fwd = profiling.time_fn(fwd, points, rotation, translation)
    t_bwd = profiling.time_fn(bwd, ds_dout, points, rotation, translation)

    splats = n_points * batch * 2 ** len(grid)
    value = splats / ((t_fwd["median_ms"] + t_bwd["median_ms"]) / 1e3)
    baseline = 1.58e8  # A100, reference README (153 ms fwd + 9 ms bwd)
    print(json.dumps({
        "metric": "points_splats_per_s_fwd_bwd_3d_to_2d_128sq",
        "value": value,
        "unit": "splats/s",
        "vs_baseline": value / baseline,
        "detail": {
            "backend": dispatch.resolve("auto", len(grid)),
            **device,
            "t_fwd_ms": t_fwd, "t_bwd_ms": t_bwd,
            "n_points": n_points, "batch": batch, "grid": list(grid),
        },
    }))


if __name__ == "__main__":
    main()
