"""``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``:
one run of one cell of ``BENCHMARK.json`` (see ``portbench/harness.py``)."""

import time

START = time.monotonic()  # set-up is counted from here

import sys  # noqa: E402

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], START))
