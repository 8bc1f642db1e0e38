"""Test configuration of the benchmark's own tests (benchmark/tests):
the checkout's root on the path, one torch thread a worker, and the
`cuda` marker of the tests that need the card."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def pytest_configure(config):
    import torch

    torch.set_num_threads(1)
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
