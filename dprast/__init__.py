"""dprast — differentiable point rasterisation in JAX.

A JAX framework with the capabilities of DiffPointRasterisation.jl:
multilinear splatting of rigidly transformed point clouds into
N-dimensional grids, with an analytic pullback for all six inputs, wrapped
in `jax.custom_vjp` so `jax.grad` just works, and scaled over device meshes
with `shard_map` collectives.

Public API (mirrors the reference's three exported functions,
reference `src/DiffPointRasterisation.jl:17`):

- :func:`raster`            — forward rasterisation (allocating)
- :func:`raster_pullback`   — analytic pullback / gradients for all inputs
- :class:`RasterGrads`      — NamedTuple of the six input gradients
"""

from dprast.api import (
    RasterGrads,
    raster,
    raster_pullback,
)
from dprast.ops.dispatch import available_backends, default_backend

__all__ = [
    "raster",
    "raster_pullback",
    "RasterGrads",
    "available_backends",
    "default_backend",
]

__version__ = "0.2.0"
