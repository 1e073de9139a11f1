"""`chip_smoke.py` on the CPU: every phase runs at a tiny size, and the
script itself refuses to report a result without a GPU."""

import importlib.util
import os

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_exits_nonzero_without_gpu(smoke, capsys, argv):
    assert smoke.main(argv) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_check_fails_above_tolerance(smoke):
    smoke.check("t", {"a": 1e-6}, 1e-5)
    with pytest.raises(smoke.PhaseFailed, match="b above"):
        smoke.check("t", {"a": 1e-6, "b": 2e-5}, 1e-5)


def test_phase_main_tiny(smoke):
    smoke.phase_main([
        smoke.Case((16, 16), 300, 4, seed=0),
        smoke.Case((32, 32), 200, 6, fwd_poses=2, seed=1),
        smoke.Case((12, 12, 12), 500, 1, seed=2)])


def test_phase_backends_tiny(smoke):
    smoke.phase_backends(smoke.Case((16, 16), 300, 4, seed=0))


def test_phase_coords_tiny(smoke):
    smoke.phase_coords(n=1024, n_points=500, batch=4)


def test_phase_fits_tiny(smoke):
    smoke.phase_fits(tomo_steps=3, langevin_steps=3)


def test_phase_memory_tiny(smoke):
    smoke.phase_memory(smoke.Case((16, 16), 300, 4, seed=0))


def test_phase_four_on_virtual_devices(smoke):
    """The --four path on four of the suite's virtual CPU devices."""
    smoke.phase_four(n_points=101, batch=6, grid=(16, 16))
