"""Which host CPUs the program under test and the traffic process run on.

The traffic process (the apiserver stub, the sink) gets the logical CPUs of
one physical core; the program gets every other CPU this process may use. The
two then never meet on one core. With fewer than four CPUs nothing is
pinned.
"""

from __future__ import annotations

import os

SIBLINGS = "/sys/devices/system/cpu/cpu{}/topology/thread_siblings_list"


def _siblings(cpu: int) -> set:
    try:
        with open(SIBLINGS.format(cpu)) as fh:
            text = fh.read().strip()
    except OSError:
        return {cpu}
    out = set()
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.update(range(int(lo), int(hi or lo) + 1))
    return out


def split() -> tuple:
    """``(program CPUs, traffic CPUs)``, or ``(None, None)`` when there are
    too few to split."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) < 4:
        return None, None
    traffic = _siblings(cpus[-1]) & set(cpus)
    program = set(cpus) - traffic
    return sorted(program), sorted(traffic)
