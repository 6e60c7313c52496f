"""One run of one benchmark cell of deepcut_tpu_torch:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (see README.md); the numbers compared for `correct` come last on
standard error and last in the result line.
"""

import os
import sys

from portbench.harness import main

if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # the interpreter's teardown is skipped: once in some tens of runs it
    # aborted there ("terminate called without an active exception") after
    # the result was printed, and there is nothing left to release
    os._exit(rc)
