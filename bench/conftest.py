"""The marker of the tests that need a card, as the repository's tests
register it."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels have no "
        "CPU mode); skips without one")
