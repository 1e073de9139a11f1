"""`jax.custom_vjp` wiring on canonical batched arguments.

This is the JAX-native equivalent of the reference's ChainRulesCore rrules
(`ext/DiffPointRasterisationChainRulesCoreExt.jl:6-92`): the forward runs the
selected backend and the backward calls the analytic pullback of the same
backend.  A backend with a fused pair (`dispatch.vjp_pair`) keeps its
neighbour geometry as residuals; otherwise the residuals are just the six
inputs (recompute-not-cache, as in the reference
`src/raster_pullback.jl:20-22`).
"""

from __future__ import annotations

from functools import partial

import jax

from dprast.ops import dispatch


@partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def raster_canonical(grid_size, backend, points, rotation, translation,
                     background, out_weight, point_weight):
    """Forward rasterisation on canonical batched args → (B, *grid_size).

    `grid_size` (tuple of python ints) and `backend` (a resolved name) are
    static; the six array args are differentiable.
    """
    return dispatch.fwd_fn(backend)(grid_size, points, rotation, translation,
                                    background, out_weight, point_weight)


def _fwd(grid_size, backend, points, rotation, translation, background,
         out_weight, point_weight):
    args = (points, rotation, translation, background, out_weight,
            point_weight)
    pair = dispatch.vjp_pair(backend)
    if pair is None:
        return raster_canonical(grid_size, backend, *args), (None, args)
    # `_fwd` only runs under differentiation — plain forward calls take
    # the residual-free primal path above.
    out, res = pair[0](grid_size, *args)
    return out, (res, args)


def _bwd(grid_size, backend, residuals, ds_dout):
    res, args = residuals
    if res is None:
        grads = dispatch.bwd_fn(backend)(grid_size, *args, ds_dout)
    else:
        grads = dispatch.vjp_pair(backend)[1](grid_size, res, args, ds_dout)
    # PullbackResult field order == canonical argument order.
    return tuple(grads)


raster_canonical.defvjp(_fwd, _bwd)
