"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests see 1 device;
distributed tests spawn subprocesses with their own device-count flags."""
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skipped where there is none)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _validate_graphs():
    """Run every test with graph validation ON (DESIGN.md §Robustness):
    ``graph_from_arrays`` / ``from_numpy_edges`` structurally check their
    output unless a call site opts out with ``validate=False``.  Production
    default stays off — the flag only flips here, so the suite doubles as
    a continuous audit of every fixture and every builder path."""
    from repro.graph import builders

    prev = builders.DEFAULT_VALIDATE
    builders.DEFAULT_VALIDATE = True
    try:
        yield
    finally:
        builders.DEFAULT_VALIDATE = prev


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    """No test may leak armed fault-injection points into the next."""
    from repro.utils import faultinject

    yield
    faultinject.disarm()
