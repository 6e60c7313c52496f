"""A run that has not printed its result by its cell's deadline prints a
failed last line and exits non-zero."""

import json
import os
import subprocess
import sys
import time

from .conftest import REPO, edit


def test_a_sleeping_run_is_ended(tiny_root):
    pb = tiny_root / "portbench"
    (pb / "entries" / "sleepy.py").write_text(
        "import time\n\n\nclass System:\n    def __init__(self, *args, **kwargs):\n"
        "        time.sleep(120)\n")
    mix = json.loads((pb / "traffic" / "classify-227.json").read_text())
    mix["entry"] = "sleepy"
    (pb / "traffic" / "sleepy.json").write_text(json.dumps(mix))
    (pb / "workloads" / "sleepy-cell.json").write_text(json.dumps(
        {"deadline_s": 12, "limits": {"top1_gap": 0.8}}))
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "sleepy-cell", "config": "caffenet", "traffic": "sleepy",
                           "chips": 1, "why": "sleeps past its deadline"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(b))
    code = ("import sys\nfrom portbench.harness import main\n"
            "sys.exit(main(['--workload', 'sleepy-cell', '--seed', '1', '--seconds', '1', "
            "'--trace', '0'], device='cpu'))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tiny_root), str(REPO)]))
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], cwd=tiny_root, env=env,
                          capture_output=True, text=True, timeout=90)
    took = time.monotonic() - t0
    assert proc.returncode == 3, proc.stderr[-2000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["correct"] is False and list(last)[-1] == "check"
    assert "watchdog" in proc.stderr and took < 60
