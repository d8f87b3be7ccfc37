"""Run one probe cycle on this node and print the report.

Usage: ``python -m k8s_watcher_tpu_torch.probe_agent [environment] --once [--cpu]``

Reads the environment's ``tpu.probe`` settings from ``config/`` (relative to
the working directory), runs one cycle on this rank's GPU (``--cpu``: on the
CPU, with the kernels' plain versions, held to the ``cpu`` platform), prints the payload as JSON and exits
1 when the report is unhealthy. Under ``torchrun`` every rank runs the cycle.
Loop mode needs the notifier, the status server and remediation, which are
not ported yet: without ``--once`` the command exits 2, as it does when the
config enables a sub-probe that is not ported yet (the link walk, enabled in
``production``; the multislice probe).
"""

from __future__ import annotations

import json
import logging
import sys
from typing import List, Optional

import torch.distributed as dist

from k8s_watcher_tpu_torch.config import load_config, resolve_environment
from k8s_watcher_tpu_torch.probe.agent import ProbeAgent


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    flags = {a for a in argv if a.startswith("--")}
    unknown = flags - {"--once", "--cpu"}
    if unknown:
        print(f"unknown option(s): {' '.join(sorted(unknown))}", file=sys.stderr)
        return 2
    if "--once" not in flags:
        print(
            "loop mode is not ported yet (it needs the notifier, the status server and "
            "remediation); run with --once",
            file=sys.stderr,
        )
        return 2
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    environment = resolve_environment(args[:1])
    config = load_config(environment)
    on_cpu = "--cpu" in flags
    try:
        agent = ProbeAgent(
            config,
            environment=environment,
            sink=lambda notification: None,
            device="cpu" if on_cpu else None,
            # an explicit --cpu run is held to the CPU; by default the contract is CUDA
            expected_platform="cpu" if on_cpu else "auto",
        )
    except NotImplementedError as exc:
        print(f"not ported yet: {exc}", file=sys.stderr)
        return 2
    try:
        report = agent.run_once()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps(report.to_payload(), indent=2, default=str))
    return 0 if report.healthy else 1


if __name__ == "__main__":
    sys.exit(main())
