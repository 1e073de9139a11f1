"""On-card test environment.

Unlike `tests/` (which forces the CPU and x64 so everything runs anywhere),
this suite runs on the GPU in float32.  Every test carries the `gpu`
marker; the fixture below skips it, with the reason, wherever JAX's
default backend is not a GPU.  Run on the card with:

    python -m pytest tests_gpu -q
"""

import pytest

from dprast.ops import dispatch


@pytest.fixture(autouse=True)
def _require_gpu(request):
    if request.node.get_closest_marker("gpu") and not dispatch.on_gpu():
        pytest.skip("needs a GPU: JAX's default backend is not 'gpu'")
