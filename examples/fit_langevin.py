"""Langevin-dynamics point-cloud fitting — the reference's logo demo
(the reference's `examples/logo.jl:18-77`) rebuilt JAX-native.

Model: raster points into an image with a global log-weight, blur with an
FFT gaussian of a learnable log-bandwidth, L2-compare to a target image
(reference `model` :18-25, `loss` :40-44).  Optimisation: Langevin dynamics
on the points + plain gradient steps on the two scalars (reference
`langevin!` :48-76), all through `jax.grad` on the analytic pullback.

Run: python examples/fit_langevin.py [--steps 400] [--out fit_out]
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

GRID = (128, 128)
N_POINTS = 3000


def gaussian_blur_fft(img, sigma):
    """FFT gaussian blur (the FFTW convolution in logo.jl:33-38)."""
    h, w = img.shape[-2:]
    fy = jnp.fft.fftfreq(h)
    fx = jnp.fft.fftfreq(w)
    # gaussian transfer function: exp(-2 pi^2 sigma^2 f^2)
    gy = jnp.exp(-2 * (jnp.pi * sigma * fy) ** 2)
    gx = jnp.exp(-2 * (jnp.pi * sigma * fx) ** 2)
    ker = gy[:, None] * gx[None, :]
    return jnp.real(jnp.fft.ifft2(jnp.fft.fft2(img) * ker))


def model(points, log_bandwidth, log_weight, backend="auto"):
    """Differentiable image formation: splat + blur
    (reference logo.jl:18-25)."""
    img = dprast.raster(GRID, points, jnp.eye(2), jnp.zeros(2), 0.0,
                        jnp.exp(log_weight), backend=backend)
    return gaussian_blur_fft(img, jnp.exp(log_bandwidth))


def loss(points, log_bandwidth, log_weight, target, backend="auto"):
    pred = model(points, log_bandwidth, log_weight, backend)
    return jnp.mean((pred - target) ** 2)


def make_target(key):
    """A procedural target: three rings of points (stands in for the logo
    image asset)."""
    ks = jax.random.split(key, 3)
    centers = jnp.asarray([[-0.35, -0.35], [-0.35, 0.35], [0.35, 0.0]])
    pts = []
    for i, k in enumerate(ks):
        ang = jax.random.uniform(k, (N_POINTS // 3,)) * 2 * jnp.pi
        r = 0.25 + 0.02 * jax.random.normal(k, (N_POINTS // 3,))
        pts.append(centers[i]
                   + jnp.stack([r * jnp.sin(ang), r * jnp.cos(ang)], -1))
    target_pts = jnp.concatenate(pts)
    img = dprast.raster(GRID, target_pts, jnp.eye(2), jnp.zeros(2), 0.0, 1.0)
    return gaussian_blur_fft(img, 2.0)


def langevin_fit(target, steps=400, seed=0, step_size=5.0, noise=1e-5,
                 log_every=50, backend="auto"):
    """reference langevin!: x += eps*grad + sqrt(2 eps T) xi (logo.jl:55-60);
    plain gradient steps for the scalars (logo.jl:62-66)."""
    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    points = jax.random.uniform(k0, (N_POINTS, 2), minval=-0.8, maxval=0.8)
    log_bw, log_w = jnp.log(2.0), jnp.log(1.0)

    import functools
    grad_fn = jax.jit(jax.value_and_grad(
        functools.partial(loss, backend=backend), argnums=(0, 1, 2)))

    @jax.jit
    def step(points, log_bw, log_w, key):
        (val, (g_p, g_bw, g_w)) = grad_fn(points, log_bw, log_w, target)
        key, kn = jax.random.split(key)
        xi = jax.random.normal(kn, points.shape)
        points = points - step_size * g_p \
            + jnp.sqrt(2 * step_size * noise) * xi
        log_bw = log_bw - 1e-2 * g_bw
        log_w = log_w - 1e-2 * g_w
        return points, log_bw, log_w, key, val

    history = []
    for i in range(steps):
        points, log_bw, log_w, key, val = step(points, log_bw, log_w, key)
        if i % log_every == 0 or i == steps - 1:
            history.append((i, float(val)))
            print(f"step {i:5d}  loss {float(val):.3e}  "
                  f"bw {float(jnp.exp(log_bw)):.2f}  "
                  f"w {float(jnp.exp(log_w)):.3f}")
    return points, log_bw, log_w, history


def load_image_target(path):
    """PNG -> blurred target image, the reference's image-asset workflow
    (`examples/logo.jl:27-38` loads julia.png, grayscales and blurs it).
    An original asset ships at examples/data/logo.png."""
    from PIL import Image

    img = Image.open(path).convert("L").resize(GRID[::-1])
    arr = jnp.asarray(np.asarray(img, np.float32) / 255.0)
    arr = arr * (N_POINTS / jnp.clip(jnp.sum(arr), 1e-6))  # total mass ~ N
    return gaussian_blur_fft(arr, 2.0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--out", default="fit_out")
    ap.add_argument("--image", default=None,
                    help="PNG target (e.g. examples/data/logo.png); "
                         "default: procedural three-ring target")
    args = ap.parse_args()
    compile_cache.enable()

    if args.image:
        target = load_image_target(args.image)
    else:
        target = make_target(jax.random.PRNGKey(42))
    points, log_bw, log_w, history = langevin_fit(target, steps=args.steps)

    os.makedirs(args.out, exist_ok=True)
    final = np.asarray(model(points, log_bw, log_w))
    np.save(os.path.join(args.out, "target.npy"), np.asarray(target))
    np.save(os.path.join(args.out, "final.npy"), final)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 2, figsize=(8, 4))
        axes[0].imshow(np.asarray(target)); axes[0].set_title("target")
        axes[1].imshow(final); axes[1].set_title("fit")
        fig.savefig(os.path.join(args.out, "fit.png"), dpi=120)
        print("wrote", os.path.join(args.out, "fit.png"))
    except ImportError:
        print("matplotlib unavailable; wrote .npy arrays to", args.out)
    assert history[-1][1] < history[0][1], "loss did not decrease"


if __name__ == "__main__":
    main()
