import os

# Tests must see the real single CPU device (the 512-device override is
# exclusively for launch/dryrun.py).
os.environ.pop("XLA_FLAGS", None)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips, with its reason, elsewhere)")
