"""Profiling / tracing hooks (SURVEY §5: the reference has none; this is
the promised small harness around `jax.profiler`) and the one timing
harness the benchmarks share.

Usage:

    from dprast.utils import profiling

    with profiling.trace("trace-dir"):               # open in XProf/TensorBoard
        out = dprast.raster(grid, pts, rot, tr)

    with profiling.annotate("fit-step"):            # named trace region
        loss, grads = step(...)

    stats = profiling.time_fn(jax.jit(step), *args)  # median / min / max ms
"""

from __future__ import annotations

import contextlib
import os
import statistics
import subprocess
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace viewable in XProf / TensorBoard."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region that shows up on the trace timeline."""
    return jax.profiler.TraceAnnotation(name)


def time_fn(fn, *args, iters: int = 10, warmup: int = 2) -> dict:
    """Wall time of ``fn(*args)`` on a host clock around
    `jax.block_until_ready`, after `warmup` untimed calls (the first one
    compiles).  Pass a jitted `fn` that returns every result the
    measurement must include, so XLA cannot drop work.

    Returns ``{"median_ms", "min_ms", "max_ms", "n"}`` over `iters` calls.
    """
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": statistics.median(samples),
            "min_ms": min(samples), "max_ms": max(samples), "n": iters}


def card_line() -> str:
    """The GPU's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (a child process; JAX is not involved)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def device_record() -> dict:
    """What every timing must be reported with: JAX's platform, device
    kind and count, the card's name and power limit, and the XLA flags."""
    devs = jax.devices()
    return {"platform": devs[0].platform,
            "device_kind": devs[0].device_kind,
            "device_count": len(devs),
            "card": card_line() if devs[0].platform == "gpu" else None,
            "xla_flags": os.environ.get("XLA_FLAGS", "")}
