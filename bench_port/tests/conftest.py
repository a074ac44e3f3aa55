"""The benchmark's own tests.  ``card`` marks a test that needs a CUDA
device; it skips on the CPU (decided inside the test, never at import)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")
