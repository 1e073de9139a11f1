"""Tomographic point-cloud reconstruction — the 3D→2D projection use case
the reference was built for (cryo-EM style: `README.md` of the reference
motivates `raster` with projections of volumetric point models).

A ground-truth 3D point cloud (two interlocked rings) is rendered to B
2D projections at known rotations (orthographic `(2, 3)` pose matrices);
a randomly initialised cloud is then fitted to those projections by
gradient descent through the analytic pullback — all six gradient paths
(points, per-pose out-weights, background) exercised at once.

Run: python examples/tomography.py [--steps 300]
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

import dprast
from dprast.utils import compile_cache

GRID = (96, 96)
N_POINTS = 2000
N_VIEWS = 24


def make_truth(key):
    k1, k2 = jax.random.split(key)
    a1 = jax.random.uniform(k1, (N_POINTS // 2,)) * 2 * jnp.pi
    ring1 = jnp.stack([0.5 * jnp.cos(a1), 0.5 * jnp.sin(a1),
                       jnp.zeros_like(a1)], axis=1)
    a2 = jax.random.uniform(k2, (N_POINTS // 2,)) * 2 * jnp.pi
    ring2 = jnp.stack([0.25 + 0.5 * jnp.cos(a2), jnp.zeros_like(a2),
                       0.5 * jnp.sin(a2)], axis=1)
    return jnp.concatenate([ring1, ring2])


def view_matrices():
    """B orthographic (2, 3) projection matrices: rotate about z then
    project away the third axis (the reference's `P * R` pattern,
    `test/data.jl:13-16`)."""
    mats = []
    for a in np.linspace(0, np.pi, N_VIEWS, endpoint=False):
        c, s = np.cos(a), np.sin(a)
        rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        rx = np.array([[1.0, 0, 0], [0, 0, -1], [0, 1, 0]])
        mats.append((rx @ rz)[:2])
    return jnp.asarray(np.stack(mats), jnp.float32)


def blur(imgs, sigma=1.5):
    x = jnp.arange(-4, 5.0)
    k = jnp.exp(-x ** 2 / (2 * sigma ** 2))
    k = k / k.sum()
    imgs = jax.vmap(lambda im: jnp.apply_along_axis(
        lambda r: jnp.convolve(r, k, "same"), 0, im))(imgs)
    return jax.vmap(lambda im: jnp.apply_along_axis(
        lambda r: jnp.convolve(r, k, "same"), 1, im))(imgs)


def fit(steps=300, backend="auto", log_every=50):
    """Reconstruct the rings from their projections by gradient descent.

    Returns (points, [(step, loss), ...])."""
    rots = view_matrices()
    trans = jnp.zeros((N_VIEWS, 2), jnp.float32)
    truth = make_truth(jax.random.PRNGKey(1))
    target = blur(dprast.raster(GRID, truth, rots, trans))

    points = jax.random.uniform(jax.random.PRNGKey(2), (N_POINTS, 3),
                                minval=-0.6, maxval=0.6)

    def loss(points):
        pred = blur(dprast.raster(GRID, points, rots, trans,
                                  backend=backend))
        return jnp.mean((pred - target) ** 2)

    @jax.jit
    def step(points):
        val, g = jax.value_and_grad(loss)(points)
        return points - 3.0 * g, val

    history = []
    for i in range(steps):
        points, val = step(points)
        if i % log_every == 0 or i == steps - 1:
            history.append((i, float(val)))
            print(f"step {i:4d}  projection loss {float(val):.3e}")
    return points, history


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args()
    compile_cache.enable()
    _, history = fit(args.steps)
    first, final = history[0][1], history[-1][1]
    print(f"loss {first:.3e} -> {final:.3e} "
          f"({final / first:.1%} of initial)")
    assert final < 0.5 * first, "reconstruction failed to converge"


if __name__ == "__main__":
    main()
