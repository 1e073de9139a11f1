"""Backend registry and selection.

The reference selects backends implicitly from array types
(`src/raster.jl:29` get_backend; CUDA dispatch in
`ext/DiffPointRasterisationCUDAExt.jl:231-245`).  In JAX device placement is
orthogonal (arrays are already committed to devices), so a backend here means
a *kernel strategy*:

- ``"xla"``     scatter-add forward / gather pullback (`dprast.ops.core`)
                — any dims; on the GPU XLA lowers the scatter to atomic
                adds, the reference's own CUDA design
- ``"matmul"``  scatter-free exact one-hot contractions
                (`dprast.ops.splat_matmul`) — N_out <= 3
- ``"auto"``    the measured choice for the given dims / grid / platform

plus ``"matmul_bf16"``, `matmul` with 1-term bf16 value operands
(~2e-3 relative error, outside the ≤1e-5 parity contract; never
auto-selected, and slower than ``"xla"`` on the GPU).
"""

from __future__ import annotations

import functools

import jax

from dprast.ops import core, splat_matmul

_REGISTRY = {}


def register(name: str, fwd, bwd, supports, vjp_pair=None):
    """supports: (n_out) -> bool.

    `vjp_pair` is an optional fused custom-vjp pair
    ``(fwd_res(grid, *args) -> (out, residuals),
    bwd_res(grid, residuals, args, ds_dout) -> PullbackResult)`` used by
    `dprast.ad` under differentiation, so the pullback reuses the
    forward's neighbour geometry instead of recomputing it.
    """
    _REGISTRY[name] = (fwd, bwd, supports, vjp_pair)


register("xla", core.raster_fwd, core.raster_pullback,
         lambda n_out: True,
         vjp_pair=(core.raster_fwd_res, core.raster_pullback_res))
register("matmul", splat_matmul.raster_fwd, splat_matmul.raster_pullback,
         splat_matmul.supported)
# 1-plane bf16 value operands (~2e-3 relative error, outside the 1e-5
# reference-parity contract; the exact one-hot side is unaffected).
register("matmul_bf16",
         functools.partial(splat_matmul.raster_fwd, terms=1),
         functools.partial(splat_matmul.raster_pullback, terms=1),
         splat_matmul.supported)


def available_backends() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def default_backend() -> str:
    return "auto"


def on_gpu() -> bool:
    """True when JAX's default backend is a GPU — the one platform probe.
    'auto' needs none today (below); the on-card suite (`tests_gpu/`)
    reads it to skip off the card."""
    return jax.default_backend() == "gpu"


def resolve(backend: str, n_out: int) -> str:
    """Map 'auto' to a concrete strategy; validate an explicit name.

    'auto' is the xla scatter/gather on every platform.  On the GPU it
    beat both matmul variants on every measured row, forward / pullback
    (three gradients) / fused step, median ms on an H100 80GB HBM3 at a
    400 W power limit
    (`benchmarks/run.py --grad --backends xla,matmul,matmul_bf16`):

        128^2  x64 x1e4   xla 0.21/0.41/0.41   matmul 1.2/2.4/3.3
                                               matmul_bf16 0.82/1.8/2.5
        128^2  x64 x1e5   xla 0.65/1.05/1.57   matmul 9.7/19.4/28.4
                                               matmul_bf16 5.9/15.1/20.3
        1024^2 x64 x1e5   xla 0.71/1.15/1.71   matmul 477/247/730
                                               matmul_bf16 276/142/428
        128^3  x1  x1e6   xla 0.36/0.88/1.03   matmul 116/276/394
                                               matmul_bf16 65/296/365

    On the CPU the O(splats) scatter beats the dense one-hot
    contractions too (4-core XLA:CPU, 128^2 x 64 x 1e4: matmul 637/381 ms
    fwd/bwd vs xla 49/26).
    """
    if backend == "auto":
        return "xla"
    if backend not in _REGISTRY:
        raise ValueError(
            f"Unknown backend {backend!r}; available: {available_backends()}")
    if not _REGISTRY[backend][2](n_out):
        raise ValueError(
            f"Backend {backend!r} does not support N_out={n_out}")
    return backend


def fwd_fn(backend: str):
    return _REGISTRY[backend][0]


def bwd_fn(backend: str):
    return _REGISTRY[backend][1]


def vjp_pair(backend: str):
    """Fused custom-vjp pair for `backend`, or None."""
    return _REGISTRY[backend][3]
