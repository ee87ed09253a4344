"""Registers the ``cuda`` marker: tests that need an NVIDIA card (the
hand-written kernels of ``repro_torch`` against their plain versions).
They skip, from a fixture, where ``torch.cuda.is_available()`` is False.

Caps torch's CPU threads in each test process at its share of the
machine's CPUs: under pytest-xdist (``PYTEST_XDIST_WORKER_COUNT`` workers)
each worker would otherwise start a thread per CPU, and six workers'
threads oversubscribed an 8-CPU machine so far that one training test ran
110 times slower than alone."""
import os


def _cpus() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def _cap_torch_threads() -> None:
    try:
        import torch
    except ImportError:
        return
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, _cpus() // workers))


_cap_torch_threads()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped where there is none")
