"""Multi-device point-cloud fitting with `raster_sharded` — the scaling
showcase (no reference counterpart: the Julia package is single-process,
its parallelism being CPU threads / CUDA atomics; here the same model
spans every local device through one `("poses", "points")` mesh).

A 3D cloud is fitted to multi-view 2D projections (the tomography setup)
with `jax.grad` flowing THROUGH the `shard_map`: per-shard splats, one
`psum` of partial images over the points axis, gradient
collectives derived automatically from the vma-typed forward
(`dprast/parallel/sharded.py`, `docs/scaling.md`).

Run (any device count; 8 virtual CPU devices work):
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/sharded_fit.py [--steps 200]
"""

from __future__ import annotations

import os
import sys

# runnable straight from a checkout (no install needed)
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import argparse

import numpy as np

import jax
import jax.numpy as jnp

from dprast.parallel import make_mesh, raster_sharded
from dprast.utils import compile_cache

GRID = (64, 64)
N_VIEWS = 6          # deliberately NOT divisible by typical mesh axes
N_POINTS = 501       # (uneven batches pad with inert poses / 0-weight points)


def view_matrices(n=N_VIEWS):
    """n orthographic 3D->2D projections around the z axis."""
    a = np.linspace(0, np.pi, n, endpoint=False)
    rot = np.zeros((n, 2, 3), np.float32)
    rot[:, 0, 0], rot[:, 0, 2] = np.cos(a), -np.sin(a)
    rot[:, 1, 1] = 1.0
    return jnp.asarray(rot)


def blur(imgs):
    k = jnp.asarray([0.25, 0.5, 0.25])
    imgs = jnp.apply_along_axis(lambda r: jnp.convolve(r, k, "same"), 1, imgs)
    return jnp.apply_along_axis(lambda r: jnp.convolve(r, k, "same"), 2, imgs)


def fit(steps=200, lr=30.0, seed=0, mesh=None, log_every=50):
    """Gradient-descend a 3D cloud onto blurred multi-view targets.

    Returns (points, loss_history)."""
    if mesh is None:
        mesh = make_mesh()          # all local devices on the poses axis
    rng = np.random.default_rng(seed)
    rots = view_matrices()
    trans = jnp.zeros((N_VIEWS, 2), jnp.float32)
    truth = jnp.asarray(rng.standard_normal((N_POINTS, 3)) * 0.35,
                        jnp.float32)
    targets = blur(raster_sharded(GRID, truth, rots, trans, mesh=mesh))

    def loss_fn(pts):
        imgs = raster_sharded(GRID, pts, rots, trans, mesh=mesh)
        return jnp.mean((blur(imgs) - targets) ** 2)

    @jax.jit
    def step(p):
        loss, g = jax.value_and_grad(loss_fn)(p)
        return loss, p - lr * g

    pts = truth + jnp.asarray(rng.standard_normal((N_POINTS, 3)) * 0.05,
                              jnp.float32)
    hist = []
    for i in range(steps):
        loss, pts = step(pts)
        if i % log_every == 0 or i == steps - 1:
            hist.append((i, float(loss)))
            print(f"step {i:4d}  loss {float(loss):.3e}", flush=True)
    return pts, hist


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=30.0)
    args = ap.parse_args()
    compile_cache.enable()
    print(f"devices: {jax.device_count()} "
          f"({jax.default_backend()})", flush=True)
    _, hist = fit(steps=args.steps, lr=args.lr)
    print(f"loss {hist[0][1]:.3e} -> {hist[-1][1]:.3e}")


if __name__ == "__main__":
    main()
