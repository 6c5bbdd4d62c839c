"""Pytest settings shared by the test suite."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc (a hand-written CUDA kernel "
        "has no CPU interpret mode); skipped elsewhere")
