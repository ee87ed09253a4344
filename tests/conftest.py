"""Registers the ``cuda`` marker: tests that need an NVIDIA card (the
hand-written kernels of ``repro_torch`` against their plain versions).
They skip, from a fixture, where ``torch.cuda.is_available()`` is False."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped where there is none")
