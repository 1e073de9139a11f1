"""Smoke check: dprast's main path on an NVIDIA GPU, against the oracle.

    python3 chip_smoke.py           # one card: every phase below
    python3 chip_smoke.py --four    # raster_sharded on four cards only

Phases (one process; every failure is reported and makes the exit code
non-zero):

1. device   JAX's first device must be a GPU; prints the card's name and
            power limit as nvidia-smi reports them.
2. main     `dprast.raster`, `dprast.raster_pullback` (all six gradients)
            and a fused `jax.value_and_grad` step through the custom VJP,
            `backend="auto"`, at the reference's sizes, against the
            independent float64 numpy oracle (`dprast.utils.testing`).
3. backends explicit `matmul` (≤1e-5) and `matmul_bf16` (≤2e-2, its
            documented envelope) at 128² x 64 poses x 1e5 points.
4. coords   the compensated float32 coordinate pipeline at n=1024
            against float64: same reference voxels, error within dl's
            float32 rounding.
5. fits     a few steps of `examples/tomography.py` and
            `examples/fit_langevin.py`; the loss must fall.
6. memory   `memory_analysis()` of the compiled flagship step and the
            device's peak bytes in use.

Every error is scale-normalised: max|got - want| / max(max|want|, 1).
The device computes in float32 (contractions at Precision.HIGHEST, so no
TF32); the oracle in float64.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``, printed only
when every phase passed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
import traceback

import numpy as np

TOL = 1e-5        # float32 device result vs float64 oracle
BF16_TOL = 2e-2   # the documented matmul_bf16 error envelope
GRAD_NAMES = ("points", "rotation", "translation", "background",
              "out_weight", "point_weight")
EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples")


class PhaseFailed(Exception):
    pass


def log(msg):
    print(msg, flush=True)


def check(label, errs, tol):
    """Print one line per error; raise PhaseFailed if any exceeds tol."""
    bad = []
    for name, err in errs.items():
        ok = err <= tol
        log(f"  {'PASS' if ok else 'FAIL'} {label} {name}: "
            f"err {err:.3e} (tol {tol:g})")
        if not ok:
            bad.append(name)
    if bad:
        raise PhaseFailed(f"{label}: {', '.join(bad)} above {tol:g}")


class Case:
    """One configuration's float32 inputs, a cotangent, and the float64
    oracle's forward (on the first `fwd_poses` poses) and pullback."""

    def __init__(self, grid, n_points, batch, fwd_poses=None, seed=0):
        import jax.numpy as jnp

        from dprast.utils.testing import (fixtures, raster_numpy,
                                          raster_pullback_numpy)

        self.grid = tuple(grid)
        self.batch = batch
        self.fwd_poses = batch if fwd_poses is None else fwd_poses
        fx = fixtures(seed=seed, n_points=n_points, batch_size=batch,
                      n_in=3, n_out=len(grid))
        self.args = tuple(np.asarray(v, np.float32) for v in fx.values())
        self.jargs = tuple(jnp.asarray(a) for a in self.args)
        rng = np.random.default_rng(seed + 1)
        self.g = rng.standard_normal((batch,) + self.grid, np.float32)
        self.jg = jnp.asarray(self.g)
        a64 = [a.astype(np.float64) for a in self.args]
        t0 = time.perf_counter()
        k = self.fwd_poses
        self.ref_out = raster_numpy(self.grid, a64[0], a64[1][:k],
                                    a64[2][:k], a64[3][:k], a64[4][:k],
                                    a64[5])
        self.ref_pb = raster_pullback_numpy(self.grid, *a64, self.g)
        self.oracle_s = time.perf_counter() - t0
        # raster is affine in background and linear in out_weight, so
        # sum(raster * g) = sum_b bg_b d_bg_b + ow_b d_ow_b exactly
        terms = a64[3] * self.ref_pb["background"] \
            + a64[4] * self.ref_pb["out_weight"]
        self.ref_loss = float(np.sum(terms))
        self.loss_scale = max(float(np.sum(np.abs(terms))), 1.0)

    def name(self):
        return (f"{'x'.join(map(str, self.grid))} x{self.batch} poses "
                f"x{self.args[0].shape[0]} points")


def forward_errs(case, backend):
    import jax

    import dprast
    from dprast.utils.testing import scaled_err

    fwd = jax.jit(lambda *a: dprast.raster(case.grid, *a, backend=backend))
    out = np.asarray(fwd(*case.jargs)[:case.fwd_poses])
    return {f"forward ({case.fwd_poses}/{case.batch} poses)":
            scaled_err(out, case.ref_out)}


def pullback_errs(case, backend):
    import jax

    import dprast
    from dprast.utils.testing import scaled_err

    pb = jax.jit(lambda g, *a: dprast.raster_pullback(g, *a,
                                                      backend=backend))
    res = pb(case.jg, *case.jargs)
    return {f"pullback d_{n}": scaled_err(getattr(res, n), case.ref_pb[n])
            for n in GRAD_NAMES}


def fused_step(case, backend="auto"):
    """The jitted training step: loss = sum(raster * g) and its gradient
    for all six inputs through the custom VJP."""
    import jax
    import jax.numpy as jnp

    import dprast

    def loss(g, *a):
        return jnp.sum(dprast.raster(case.grid, *a, backend=backend) * g)

    return jax.jit(jax.value_and_grad(loss, argnums=tuple(range(1, 7))))


def fused_errs(case, backend="auto"):
    from dprast.utils.testing import scaled_err

    val, grads = fused_step(case, backend)(case.jg, *case.jargs)
    errs = {"step loss": abs(float(val) - case.ref_loss) / case.loss_scale}
    for n, gr in zip(GRAD_NAMES, grads):
        errs[f"step d_{n}"] = scaled_err(gr, case.ref_pb[n])
    return errs


def phase_main(cases):
    for case in cases:
        log(f"main path, backend=auto, {case.name()} "
            f"(oracle {case.oracle_s:.1f} s on the host)")
        errs = forward_errs(case, "auto")
        errs.update(pullback_errs(case, "auto"))
        errs.update(fused_errs(case, "auto"))
        check(case.name(), errs, TOL)


def phase_backends(case):
    for backend, tol in (("matmul", TOL), ("matmul_bf16", BF16_TOL)):
        log(f"backend={backend}, {case.name()}")
        errs = forward_errs(case, backend)
        errs.update(pullback_errs(case, backend))
        check(f"{backend} {case.name()}", errs, tol)


def phase_coords(n=1024, n_points=100_000, batch=64):
    """The compensated float32 coordinate pipeline against a float64
    transform: float64's reference voxel everywhere off a boundary, and
    no error beyond dl's own float32 rounding (2^-25)."""
    from dprast.utils.testing import compensated_coords_errors

    rng = np.random.default_rng(0)
    err, wrong, in_range = compensated_coords_errors(
        rng.standard_normal((n_points, 3)) * 0.5,
        rng.standard_normal((batch, 2, 3)),
        rng.standard_normal((batch, 2)) * 0.1, (n, n))
    log(f"compensated coordinates, n={n}, {batch} poses x {n_points} points")
    check(f"coords n={n}", {"max |u - u64|": err}, 3e-8)
    check(f"coords n={n}", {"voxels unlike float64's": wrong}, 0)
    if not in_range:
        raise PhaseFailed("coords: dl left (0, 1]")


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_fits(tomo_steps=30, langevin_steps=40):
    import jax

    tomo = _load_example("tomography")
    _, hist = tomo.fit(steps=tomo_steps, log_every=10)
    log(f"tomography: loss {hist[0][1]:.4e} -> {hist[-1][1]:.4e}")
    if not hist[-1][1] < hist[0][1]:
        raise PhaseFailed("tomography loss did not decrease")
    lang = _load_example("fit_langevin")
    target = lang.make_target(jax.random.PRNGKey(42))
    *_, hist = lang.langevin_fit(target, steps=langevin_steps, log_every=10)
    log(f"langevin: loss {hist[0][1]:.4e} -> {hist[-1][1]:.4e}")
    if not hist[-1][1] < hist[0][1]:
        raise PhaseFailed("langevin loss did not decrease")


def phase_memory(case):
    import jax

    compiled = fused_step(case).lower(case.jg, *case.jargs).compile()
    log(f"memory of the fused step, {case.name()}:")
    log(f"  compiled.memory_analysis(): {compiled.memory_analysis()}")
    jax.block_until_ready(compiled(case.jg, *case.jargs))
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    log(f"  peak_bytes_in_use: "
        f"{peak if peak is not None else 'not reported by this device'}")


def phase_four(n_points=200_000, batch=128, grid=(128, 128)):
    """The flagship row weak-scaled to a 2x2 ("poses", "points") mesh:
    forward and value_and_grad w.r.t. points and translation through
    `raster_sharded`, against single-device `dprast.raster` on the same
    data.  Sums run in another order (per-shard partials, psum, atomics),
    so agreement is to float32 rounding: ≤1e-5 scale-normalised."""
    import jax
    import jax.numpy as jnp

    import dprast
    from dprast.parallel import make_mesh, raster_sharded
    from dprast.utils.testing import fixtures, scaled_err

    devs = jax.devices()
    if len(devs) < 4:
        raise PhaseFailed(f"--four needs 4 devices, found {len(devs)}")
    mesh = make_mesh(2, 2, devices=devs[:4])
    fx = fixtures(seed=3, n_points=n_points, batch_size=batch, n_in=3,
                  n_out=len(grid))
    args = [np.asarray(v, np.float32) for v in fx.values()]
    g = np.random.default_rng(4).standard_normal((batch,) + tuple(grid),
                                                 np.float32)
    log(f"raster_sharded on a 2x2 mesh of {devs[0].device_kind}, "
        f"{'x'.join(map(str, grid))} x{batch} poses x{n_points} points")

    def loss_sh(pts, tr, *rest):
        rot, bg, ow, pw, gg = rest
        out = raster_sharded(grid, pts, rot, tr, bg, ow, pw, mesh=mesh)
        return jnp.sum(out * gg)

    def loss_1(pts, tr, *rest):
        rot, bg, ow, pw, gg = rest
        return jnp.sum(dprast.raster(grid, pts, rot, tr, bg, ow, pw) * gg)

    out_sh = raster_sharded(grid, *args, mesh=mesh)
    vg_sh = jax.jit(jax.value_and_grad(loss_sh, argnums=(0, 1)))
    val_sh, (gp_sh, gt_sh) = vg_sh(args[0], args[2], args[1], *args[3:], g)

    one = [jax.device_put(a, devs[0]) for a in args + [g]]
    out_1 = jax.jit(lambda *a: dprast.raster(grid, *a))(*one[:6])
    vg_1 = jax.jit(jax.value_and_grad(loss_1, argnums=(0, 1)))
    val_1, (gp_1, gt_1) = vg_1(one[0], one[2], one[1], *one[3:])
    errs = {"forward": scaled_err(out_sh, out_1),
            "loss": abs(float(val_sh) - float(val_1))
            / max(abs(float(val_1)), 1.0),
            "d_points": scaled_err(gp_sh, gp_1),
            "d_translation": scaled_err(gt_sh, gt_1)}
    check("sharded vs single device", errs, TOL)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only raster_sharded on four cards")
    opts = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's first device is "
              f"{devs[0].platform}", file=sys.stderr)
        return 2

    from dprast.utils import compile_cache, profiling

    log(f"compile cache: {compile_cache.enable()}")
    log(f"card: {profiling.card_line()}")
    log(f"jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}")

    if opts.four:
        phases = [("four", phase_four)]
    else:
        flagship = Case((128, 128), 100_000, 64, seed=0)
        phases = [
            ("main", lambda: phase_main([
                flagship,
                Case((1024, 1024), 100_000, 64, fwd_poses=16, seed=1),
                Case((128, 128, 128), 1_000_000, 1, seed=2)])),
            ("backends", lambda: phase_backends(flagship)),
            ("coords", phase_coords),
            ("fits", phase_fits),
            ("memory", lambda: phase_memory(flagship)),
        ]
    failed = []
    for name, run in phases:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        try:
            run()
        except Exception as e:  # report every phase, then fail the run
            failed.append(name)
            log(f"FAILED phase {name}: {type(e).__name__}: {e}")
            traceback.print_exc()
        log(f"== phase {name}: {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
