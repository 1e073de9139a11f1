"""REAL multi-process process-group test (the distributed-communication
layer, SURVEY §5): two OS processes form a `jax.distributed` group over the
CPU transport, build the pod mesh (poses axis across processes, points axis
within), run `raster_sharded` forward + `jax.grad`, and must agree with a
single-process reference to fp tolerance.

This validates the actual cross-process path — coordinator handshake,
global device enumeration, cross-process `device_put`, compiled collectives
— not just the single-process virtual mesh of `tests/test_sharding.py`.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # multi-minute: real process groups

_WORKER = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax

coord, pid = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, sys.argv[3])
from dprast.parallel import multihost, raster_sharded

multihost.initialize(coordinator_address=coord, num_processes=2,
                     process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 8, jax.device_count()
mesh = multihost.pod_mesh(points_axis_per_host=True)
assert mesh.shape == {"poses": 2, "points": 4}, mesh.shape

import jax.numpy as jnp
import numpy as np
rng = np.random.default_rng(0)           # same data on every process
pts = jnp.asarray(rng.standard_normal((37, 3)) * 0.4, jnp.float32)
rot = jnp.asarray(np.stack([np.eye(3)[:2]] * 6), jnp.float32)
tr = jnp.asarray(rng.standard_normal((6, 2)) * 0.1, jnp.float32)

def loss(p):
    out = raster_sharded((16, 16), p, rot, tr, mesh=mesh)
    return jnp.sum(out ** 2)

val = float(loss(pts))                      # eager cross-process path
grad = jax.jit(jax.grad(loss))(pts)         # traced path (jit required
                                            # for multi-process grads)
gsum = float(jnp.vdot(grad, pts))
print(json.dumps({"pid": pid, "val": val, "gsum": gsum}), flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_group_matches_single():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    coord = f"localhost:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, coord, str(i), repo],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process worker timed out")
        assert p.returncode == 0, f"worker failed:\n{err[-2000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))

    # both processes computed the same replicated results
    assert outs[0]["val"] == pytest.approx(outs[1]["val"], rel=1e-6)
    assert outs[0]["gsum"] == pytest.approx(outs[1]["gsum"], rel=1e-6)

    # single-process reference (this process: plain raster, no mesh)
    import jax
    import jax.numpy as jnp

    import dprast
    rng = np.random.default_rng(0)
    pts = jnp.asarray(rng.standard_normal((37, 3)) * 0.4, jnp.float32)
    rot = jnp.asarray(np.stack([np.eye(3)[:2]] * 6), jnp.float32)
    tr = jnp.asarray(rng.standard_normal((6, 2)) * 0.1, jnp.float32)

    def loss(p):
        return jnp.sum(dprast.raster((16, 16), p, rot, tr) ** 2)

    assert outs[0]["val"] == pytest.approx(float(loss(pts)), rel=1e-5)
    assert outs[0]["gsum"] == pytest.approx(
        float(jnp.vdot(jax.grad(loss)(pts), pts)), rel=1e-5)
