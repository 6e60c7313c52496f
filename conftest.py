"""Threads and time limits for the test suite under tests/.

pytest loads this file before tests/conftest.py, which picks the platform.

Thread budget: the xdist workers of one run share the cores this process may
run on (`os.sched_getaffinity`, so a `taskset` counts), and each worker gets
`THREAD_BUDGET` = cores // workers threads (every core outside xdist): the
OpenMP, MKL and OpenBLAS variables of `os.environ`, which every subprocess a
test starts inherits, and torch's intra- and inter-op pools. Without it six
workers of eight torch threads each oversubscribe eight cores, and a test's
time depends on what the other workers run at that moment. XLA keeps its own
threading: `--xla_cpu_multi_thread_eigen=false` would run the JAX package's
ops on other kernels, whose sums round differently, and the tests hold the
port to those sums within a few ulps.

Each test's call has `TEST_LIMIT_S`: past it the test fails, and every
thread's stack is printed to the run's stderr first.
"""

import faulthandler
import os
import signal

import pytest

TEST_LIMIT_S = 600
THREAD_BUDGET = max(1, len(os.sched_getaffinity(0))
                    // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
_STDERR_FD = pytest.StashKey[int]()  # the run's own stderr, outside pytest's capture

# Before any test imports torch; subprocesses inherit them.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(THREAD_BUDGET)


def pytest_configure(config):
    import torch

    torch.set_num_threads(THREAD_BUDGET)
    torch.set_num_interop_threads(THREAD_BUDGET)

    capman = config.pluginmanager.getplugin("capturemanager")
    if capman is not None:
        capman.suspend_global_capture()
    config.stash[_STDERR_FD] = os.dup(2)
    if capman is not None:
        capman.resume_global_capture()


def _over_limit(signum, frame):
    pytest.fail(f"ran past its {TEST_LIMIT_S} s limit; every thread's stack "
                "is in the run's stderr")


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    """Fail a test whose call runs past TEST_LIMIT_S. faulthandler dumps the
    stacks from the same SIGALRM, so a test stuck in C code still shows where."""
    previous = signal.signal(signal.SIGALRM, _over_limit)
    faulthandler.register(signal.SIGALRM, file=item.config.stash[_STDERR_FD], chain=True)
    signal.alarm(TEST_LIMIT_S)
    try:
        return (yield)
    finally:
        signal.alarm(0)
        faulthandler.unregister(signal.SIGALRM)
        signal.signal(signal.SIGALRM, previous)
