"""Pytest settings of the benchmark's own tests."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (the port's CUDA kernels have no CPU "
        "mode); skipped elsewhere")
