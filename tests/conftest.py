"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests must see the real
single CPU device; only launch/dryrun.py forces 512 placeholder devices."""
import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
