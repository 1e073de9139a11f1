"""Multi-chip distribution layer (the capability the reference lacks).

The reference is single-process (SURVEY §2: no NCCL/MPI anywhere); its only
"parallelism" is CUDA atomics + CPU threads.  Here the same two logical work
axes — points and poses — become axes of a `jax.sharding.Mesh`, and the
conflict-resolution/reduction story is XLA collectives, which XLA hands to
NCCL on GPUs (NVLink between the cards of one host):

- forward: per-shard partial images, `psum` over the ``points`` axis
  (replaces the reference's atomic adds on the output image,
  `src/raster.jl:64`),
- backward: pose grads `psum` over ``points``; point grads `psum` over
  ``poses`` (replaces the CUDA global-atomic gradient accumulation,
  `ext/DiffPointRasterisationCUDAExt.jl:195-207`, and the CPU thread-private
  slabs, `src/interface.jl:402-406`) — inserted automatically by shard_map's
  vma-aware transpose.
"""

from dprast.parallel.sharded import (
    make_mesh,
    raster_sharded,
    shard_raster_args,
)

__all__ = ["make_mesh", "raster_sharded", "shard_raster_args"]
