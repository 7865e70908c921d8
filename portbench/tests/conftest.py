"""The marker of the benchmark's tests that need the card, and few threads
a test process, so that several workers do not oversubscribe the host."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped without one")
    import torch

    torch.set_num_threads(2)
