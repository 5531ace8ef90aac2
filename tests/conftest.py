"""Test harness: force JAX onto CPU with 8 virtual devices BEFORE jax imports.

SURVEY.md §5 item 4: distributed paths are tested without a cluster via
``xla_force_host_platform_device_count``; sharded output must equal single-device
output exactly.  Set env here (conftest imports before any test module).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_codes(rng, n, p_bad=0.0):
    """Random base codes, optionally salted with invalid (4) codes."""
    c = rng.integers(0, 4, size=n).astype(np.uint8)
    if p_bad > 0:
        c = np.where(rng.random(n) < p_bad, np.uint8(4), c)
    return c
