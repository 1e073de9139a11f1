"""Zero-copy training loops via buffer donation.

The reference exposes `raster!(out, ...)` and pre-allocated pullback
buffers (`src/interface.jl:50-56,165-190`) so optimisation loops do not
re-allocate per step.  The JAX analogue is `donate_argnums`: the caller
marks loop-carried buffers as consumed and XLA aliases them input→output
instead of allocating fresh ones.  These tests pin that story down at the
compiler level (the alias table of the compiled executable), which holds
on any backend — actual buffer reuse additionally requires a device whose
runtime honours donation (the GPU; the CPU may copy).
"""

import jax
import jax.numpy as jnp

import dprast
from dprast.utils.testing import fixtures

GRID = (16, 16)


def _train_step(points, target, rotation, translation):
    def loss(p):
        img = dprast.raster(GRID, p, rotation, translation)
        return jnp.mean((img - target) ** 2)

    return points - 0.1 * jax.grad(loss)(points)


def test_donated_points_alias_output():
    """`jit(step, donate_argnums=0)` must alias the donated points buffer
    to the updated-points output (the `raster!` zero-copy analogue)."""
    fx = fixtures(n_points=64, batch_size=4, n_in=2, n_out=2, seed=0)
    pts = fx["points"]
    target = jnp.zeros((4,) + GRID, pts.dtype)
    compiled = (
        jax.jit(_train_step, donate_argnums=(0,))
        .lower(pts, target, fx["rotation"], fx["translation"])
        .compile()
    )
    hlo = compiled.as_text()
    assert "input_output_alias" in hlo.splitlines()[0], (
        "donated points buffer was not aliased into the output")


def test_donation_preserves_values():
    """The donated step computes the same update as the plain one."""
    fx = fixtures(n_points=64, batch_size=4, n_in=2, n_out=2, seed=1)
    pts = fx["points"]
    target = jnp.zeros((4,) + GRID, pts.dtype)
    args = (target, fx["rotation"], fx["translation"])
    plain = jax.jit(_train_step)(pts, *args)
    donated = jax.jit(_train_step, donate_argnums=(0,))(pts, *args)
    assert jnp.allclose(plain, donated)


def test_donated_image_accumulator():
    """A streaming accumulator (`accum += raster(...)`, the tomography
    pattern) donates the carried image so each step updates it in place —
    the closest analogue of the reference's `raster!(out, ...)`."""
    fx = fixtures(n_points=64, batch_size=4, n_in=3, n_out=2, seed=2)
    accum = jnp.zeros((4,) + GRID, fx["points"].dtype)

    def accumulate(accum, translation, fx=fx):
        return accum + dprast.raster(
            GRID, fx["points"], fx["rotation"], translation)

    step = jax.jit(accumulate, donate_argnums=(0,))
    compiled = step.lower(accum, fx["translation"]).compile()
    assert "input_output_alias" in compiled.as_text().splitlines()[0], (
        "carried image buffer was not aliased input->output")
    for i in range(3):
        accum = step(accum, fx["translation"] * (i + 1))
    assert jnp.isfinite(accum).all()
