import os

import jax
import pytest

# NOTE: no XLA_FLAGS / device-count override here — smoke tests and benches
# must see the 1 real CPU device (the 512-device mesh lives ONLY in
# repro.launch.dryrun, which sets the flag before importing jax).

try:
    from hypothesis import settings

    # CI boxes jit-compile inside property bodies, so wall-clock per example
    # is noisy — pin deadline=None there (flaky DeadlineExceeded otherwise);
    # dev keeps the library defaults so genuinely slow examples still
    # surface locally.
    settings.register_profile("ci", deadline=None)
    settings.register_profile("dev")
    settings.load_profile("ci" if os.environ.get("CI") else "dev")
except ImportError:                       # hypothesis-free environments
    pass


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the PyTorch port's hand-written kernels); "
        "the test skips itself without one",
    )
