"""Test-session set-up.

Under pytest-xdist every worker gets an equal share of the machine's CPUs
for its intra-op threads: torch's, and through ``OMP_NUM_THREADS`` and
``MKL_NUM_THREADS`` those of the processes the tests start.  Left at their
defaults, each worker's pools size themselves to the whole machine, and the
workers' threads spend the run contending for the cores.  A run without
xdist keeps the defaults."""
import os


def _thread_share():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    if workers <= 0:
        return None
    cpus = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
            else os.cpu_count() or 1)
    return max(1, cpus // workers)


_SHARE = _thread_share()
if _SHARE is not None:
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = str(_SHARE)
    import torch
    torch.set_num_threads(_SHARE)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips on a host without one)")
