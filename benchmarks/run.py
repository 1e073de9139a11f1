"""Benchmark suite over the reference's headline table (BASELINE.md).

Times, per configuration and backend, on the GPU:

- the forward (`dprast.raster`);
- the pullback with the reference's three gradients (points, rotation,
  translation; `raster_pullback!(ds, points, rotation, translation)` in
  the reference's table);
- with --grad, one fused `jax.value_and_grad` step through the custom VJP
  w.r.t. the same three inputs.

Each time is the median, min and max of 10 calls on a host clock
around `block_until_ready`, after warm-up (`dprast.utils.profiling`).
Prints one JSON line per (configuration, backend), each naming the device
and the card's power limit, then a summary table.  Refuses to run
anywhere but a GPU.

Usage: python benchmarks/run.py [--configs 128sq_1e5,...]
                                [--backends auto,xla,matmul] [--grad]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# (name, n_points, batch, grid, n_in, A100 fwd ms, A100 bwd ms[, weighted])
#
# Headline rows time the DEFAULT-weight call — the reference's timing
# table benchmarks `raster(points, rotation, translation)` whose weights
# are lazy FillArray Ones (`src/interface.jl:87-92`).  The `_pw` variants
# re-time the big 2D rows with a random per-point weight.
CONFIGS = [
    ("64sq_2d_1e4", 10_000, 64, (64, 64), 2, None, None),  # BASELINE cfg 2
    ("128sq_1e4", 10_000, 64, (128, 128), 3, 15.0, 1.0),
    ("1024sq_1e4", 10_000, 64, (1024, 1024), 3, 16.0, 2.0),
    ("128sq_1e5", 100_000, 64, (128, 128), 3, 153.0, 9.0),
    ("1024sq_1e5", 100_000, 64, (1024, 1024), 3, 154.0, 10.0),
    # no vs_a100 on the weighted rows: the A100 reference timed the
    # default-weight call, so the ratio would be apples-to-oranges
    ("128sq_1e5_pw", 100_000, 64, (128, 128), 3, None, None, True),
    ("1024sq_1e5_pw", 100_000, 64, (1024, 1024), 3, None, None, True),
    ("128cube_1e5", 100_000, 1, (128, 128, 128), 3, None, None),
    # BASELINE cfg 4 at its stated size: 1M points, full gradients
    ("128cube_1e6", 1_000_000, 1, (128, 128, 128), 3, None, None),
    ("1024cube_1e5", 100_000, 1, (1024, 1024, 1024), 3, 24.0, 17.0),
]


def _args_for(n_points, batch, grid, n_in):
    import jax
    import jax.numpy as jnp

    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    pts = jax.random.normal(ks[0], (n_points, n_in), jnp.float32) * 0.4
    n_out = len(grid)
    rot = np.zeros((batch, n_out, n_in), np.float32)
    angles = np.linspace(0, 2 * np.pi, batch, endpoint=False)
    for i, a in enumerate(angles):
        c, s = np.cos(a), np.sin(a)
        r = np.eye(n_in, dtype=np.float32)
        r[0, 0], r[0, -1], r[-1, 0], r[-1, -1] = c, -s, s, c
        rot[i] = r[:n_out]
    rot = jnp.asarray(rot)
    tr = jax.random.normal(ks[1], (batch, n_out), jnp.float32) * 0.1
    bg = jnp.zeros((batch,), jnp.float32)
    ow = jnp.ones((batch,), jnp.float32)
    pw = jax.random.uniform(ks[2], (n_points,), jnp.float32, 0.5, 2.0)
    g = jax.random.normal(jax.random.PRNGKey(7), (batch,) + tuple(grid),
                          jnp.float32)
    return (pts, rot, tr, bg, ow, pw), g


def run_config(name, n_points, batch, grid, n_in, ref_fwd, ref_bwd,
               weighted=False, *, backend="auto", with_grad=False,
               device=None):
    import jax
    import jax.numpy as jnp

    import dprast
    from dprast.ops import dispatch
    from dprast.utils.profiling import time_fn

    (pts, rot, tr, bg, ow, pw), g = _args_for(n_points, batch, grid, n_in)
    if not weighted:
        pw = None       # the default-weight call, as the reference timed

    @jax.jit
    def fwd(pts, rot, tr):
        return dprast.raster(grid, pts, rot, tr, bg, ow, pw, backend=backend)

    @jax.jit
    def bwd(g, pts, rot, tr):
        res = dprast.raster_pullback(g, pts, rot, tr, bg, ow, pw,
                                     backend=backend)
        return res.points, res.rotation, res.translation

    @jax.jit
    def step(g, pts, rot, tr):
        def loss(pts, rot, tr):
            return jnp.sum(dprast.raster(grid, pts, rot, tr, bg, ow, pw,
                                         backend=backend) * g)
        return jax.value_and_grad(loss, argnums=(0, 1, 2))(pts, rot, tr)

    rec = {"config": name,
           "backend": dispatch.resolve(backend, len(grid)),
           **(device or {})}
    timings = [("fwd", fwd, (pts, rot, tr)), ("bwd", bwd, (g, pts, rot, tr))]
    if with_grad:
        timings.append(("grad", step, (g, pts, rot, tr)))
    for key, fn, args in timings:
        t = time_fn(fn, *args)
        rec[f"t_{key}_ms"] = t["median_ms"]
        rec[f"t_{key}_ms_min"] = t["min_ms"]
        rec[f"t_{key}_ms_max"] = t["max_ms"]
    rec["n"] = t["n"]
    t_sum = (rec["t_fwd_ms"] + rec["t_bwd_ms"]) / 1e3
    rec["splats_per_s"] = n_points * batch * 2 ** len(grid) / t_sum
    if ref_fwd is not None:
        rec["vs_a100"] = (ref_fwd + ref_bwd) / 1e3 / t_sum
    print(json.dumps(rec), flush=True)
    return rec


def run_multihost(args):
    """Weak-scaling benchmark of the fused step over a multi-process mesh.

    Launch the SAME command in every process (or pass --coordinator /
    --num-processes / --process-id explicitly, e.g. for the two-process
    CPU-transport validation in tests/test_multihost_bench.py).  Work
    scales with the mesh: poses with the "poses" axis, points with the
    "points" axis, so per-device work is constant and

        efficiency = per-device splats/s  /  --baseline (the 1-device row)

    Process 0 prints one JSON line, with the device it ran on.
    """
    import jax

    from dprast.parallel import multihost

    multihost.initialize(args.coordinator, args.num_processes,
                         args.process_id)

    import jax.numpy as jnp

    from dprast.parallel import raster_sharded
    from dprast.utils.profiling import time_fn

    mesh = multihost.pod_mesh()
    n_chips = jax.device_count()
    n_poses_sh = mesh.shape["poses"]
    n_points_sh = mesh.shape["points"]
    grid = tuple(int(x) for x in args.mh_grid.split(","))
    b = args.mh_poses if args.mh_poses else 64 * n_poses_sh
    p = args.mh_points if args.mh_points else 100_000 * n_points_sh

    rng = np.random.default_rng(0)          # identical data everywhere
    pts = jnp.asarray(rng.standard_normal((p, 3)) * 0.4, jnp.float32)
    angles = np.linspace(0, 2 * np.pi, b, endpoint=False)
    rot = np.zeros((b, len(grid), 3), np.float32)
    rot[:, 0, 0] = np.cos(angles)
    rot[:, 0, 2] = -np.sin(angles)
    rot[:, 1, 1] = 1.0
    if len(grid) == 3:
        # full rotation: without the third row every point collapses
        # onto one z-plane
        rot[:, 2, 0] = np.sin(angles)
        rot[:, 2, 2] = np.cos(angles)
    rot = jnp.asarray(rot)
    tr = jnp.asarray(rng.standard_normal((b, len(grid))) * 0.1, jnp.float32)
    g = jnp.asarray(rng.standard_normal((b,) + grid), jnp.float32)

    def loss_fn(pts_, tr_, g_):
        out = raster_sharded(grid, pts_, rot, tr_, mesh=mesh)
        return jnp.sum(out * g_)

    step = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))
    t = time_fn(step, pts, tr, g)["median_ms"] / 1e3
    splats = p * b * 2 ** len(grid)
    per_chip = splats / t / n_chips
    devs = jax.devices()
    rec = {"multihost": True, "n_processes": jax.process_count(),
           "n_chips": n_chips, "platform": devs[0].platform,
           "device_kind": devs[0].device_kind,
           "mesh": {k: int(v) for k, v in mesh.shape.items()},
           "grid": list(grid), "n_points": p, "batch": b,
           "t_step_ms": t * 1e3,
           "splats_per_s_per_chip": per_chip}
    if args.baseline:
        rec["efficiency_vs_1chip"] = round(per_chip / args.baseline, 4)
    if jax.process_index() == 0:
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default=None,
                    help="comma-separated subset of config names")
    ap.add_argument("--backends", default="auto",
                    help="comma-separated backends to time per config")
    ap.add_argument("--multihost", action="store_true",
                    help="weak-scaling fused-step benchmark over a "
                    "multi-process mesh (see run_multihost)")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--mh-grid", default="128,128")
    ap.add_argument("--mh-points", type=int, default=None,
                    help="total points (default 1e5 per points-shard)")
    ap.add_argument("--mh-poses", type=int, default=None,
                    help="total poses (default 64 per poses-shard)")
    ap.add_argument("--baseline", type=float, default=None,
                    help="1-device splats/s for the efficiency ratio")
    ap.add_argument("--out", default=None,
                    help="also append result rows to this JSON-lines file")
    ap.add_argument("--grad", action="store_true",
                    help="also time the fused jax.value_and_grad step")
    args = ap.parse_args()
    if args.multihost:
        run_multihost(args)
        return

    from dprast.utils import compile_cache, profiling

    device = profiling.device_record()
    if device["platform"] != "gpu":
        sys.exit(f"benchmarks/run.py times the GPU; JAX's device is "
                 f"{device['platform']}")
    compile_cache.enable()
    want = set(args.configs.split(",")) if args.configs else None
    rows = []
    for cfg in CONFIGS:
        if want and cfg[0] not in want:
            continue
        for backend in args.backends.split(","):
            try:
                rows.append(run_config(*cfg, backend=backend,
                                       with_grad=args.grad, device=device))
            except Exception as e:  # keep going; report the failure
                rows.append({"config": cfg[0], "backend": backend,
                             "error": str(e)[:300]})
                print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    print(f"\n{device['card']} ({device['device_kind']})")
    print(f"{'config':<14} {'backend':<7} {'fwd ms':>9} {'bwd ms':>9} "
          f"{'step ms':>9} {'splats/s':>10} {'vs A100':>8}")
    for r in rows:
        def col(k, fmt="9.3f"):
            v = r.get(k)
            return format(v, fmt) if v is not None else f"{'-':>9}"
        sps = r.get("splats_per_s")
        va = r.get("vs_a100")
        print(f"{r['config']:<14} {r['backend']:<7} {col('t_fwd_ms')} "
              f"{col('t_bwd_ms')} {col('t_grad_ms')} "
              f"{format(sps, '10.3e') if sps else '-':>10} "
              f"{format(va, '8.2f') if va else '-':>8}")


if __name__ == "__main__":
    main()
