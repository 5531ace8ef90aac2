"""On-card tests, marked ``chip``: run them with

    python -m pytest tests_chip -m chip -q

on a machine with an NVIDIA GPU (``chip_smoke.py`` runs them inside its own
process, which already holds the card).  The default suite (``tests/``)
forces a virtual CPU mesh; these cover what it cannot: XLA's GPU lowering of
the sketch, the tables and the pipeline.  Whether there is a GPU is decided
by the fixture below when a test runs, never at import or collection, so
every pytest worker collects the same tests.
"""

import hash10x_jax  # noqa: F401  (enables 64-bit types before any jnp use)
import jax
import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _needs_gpu(request):
    if request.node.get_closest_marker("chip") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; JAX found "
                    f"{jax.devices()[0].platform!r}")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
