import os
import sys

# tests must see ONE device (the dry-run alone uses 512 placeholders)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# the whole suite runs with the lock-order detector armed: any lock-order
# inversion anywhere fails fast with the cycle instead of a hang
os.environ.setdefault("REPRO_LOCK_CHECK", "1")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    # tests of the port's CUDA kernels: they skip without a card
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (CUDA kernels have no CPU "
        "mode); skips without one")
