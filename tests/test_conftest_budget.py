"""The thread budget of the repository's root conftest.py: each xdist worker,
and each subprocess started with `cpu_subprocess_env`, runs on
cores // workers threads (every core outside xdist), and XLA keeps its own
threading, so the JAX package's sums round as they do outside the suite."""

import os
import subprocess
import sys

import pytest
import torch

from conftest import cpu_subprocess_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["worker", "subprocess"])
def test_thread_budget(where):
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    budget = max(1, len(os.sched_getaffinity(0)) // workers)
    if where == "worker":
        assert torch.get_num_threads() == budget
        return
    env = cpu_subprocess_env(8)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        assert env[var] == str(budget), var
    assert env["XLA_FLAGS"].split() == ["--xla_force_host_platform_device_count=8"]
    proc = subprocess.run([sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
                          env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.split()[-1]) == budget
