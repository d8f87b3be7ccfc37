"""The control: one run of a cell through the harness's own path, with the
plain reference in the program's place one step below the precision the
configuration states (the driver's ``run.control``; for ``node-probe-loop``
the read sweep and the block sums in bfloat16, the GEMM chain in float8). Its
numbers are held to the cell's own limits by the harness's ``report``, and
its result must say ``"correct": false``. The benchmark's own runs never run
it.

``python3 -m portbench.control --workload <cell> --seed <n> --seconds <s> --trace 0``
"""

import time

START = time.monotonic()

import sys  # noqa: E402

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], START, control=True))
