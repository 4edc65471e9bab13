"""Registers the ``cuda`` marker: tests that need a CUDA card (the port's
kernels have no CPU mode) carry it and skip where there is none."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped where there is none")
