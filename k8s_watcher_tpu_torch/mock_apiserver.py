"""Run the port's mock Kubernetes API server standalone (the JAX package's
``scripts/run_mock_server.py``).

It serves the target of the bundled kubeconfig (``assets/config``,
localhost:9988) with two TPU nodes and a four-worker slice, so a watcher
pointed at it (``kubernetes.use_mock: false`` +
``kubernetes.config_file: ./assets/config``) sees realistic events. With
``--churn`` one worker changes phase every 5 s and a node's Ready condition
flips every 30 s. SIGINT stops it with exit code 0.

Usage: ``python -m k8s_watcher_tpu_torch.mock_apiserver [port] [--churn]``
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

from k8s_watcher_tpu_torch.k8s.mock_server import MockApiServer, MockCluster
from k8s_watcher_tpu_torch.watch.fake import build_node, build_pod

PHASE_CYCLE = ("Running", "Failed", "Pending", "Running")
CHURN_PERIOD_S = 5.0


def seed_slice(cluster: MockCluster, name: str = "train", workers: int = 4) -> None:
    for w in range(workers):
        cluster.add_pod(
            build_pod(
                f"{name}-{w}",
                "default",
                phase="Pending",
                node_name=f"tpu-node-{w % 2}",
                tpu_chips=4,
                tpu_topology=f"2x2x{workers}",
                tpu_accelerator="tpu-v5p-slice",
                gke_slice_fields={
                    "jobset.sigs.k8s.io/jobset-name": name,
                    "batch.kubernetes.io/job-completion-index": w,
                },
            )
        )


def seed_nodes(cluster: MockCluster, count: int = 2) -> None:
    for n in range(count):
        cluster.add_node(build_node(f"tpu-node-{n}", tpu_topology="2x2x4"))


def churn_step(cluster: MockCluster, i: int) -> List[str]:
    """The ``i``-th churn tick: one worker's phase, and every sixth tick
    (~30 s) a node's Ready condition; what changed, as log lines."""
    worker = i % 4
    phase = PHASE_CYCLE[(i // 4) % len(PHASE_CYCLE)]
    cluster.set_phase("default", f"train-{worker}", phase)
    lines = [f"churn: train-{worker} -> {phase}"]
    if i % 6 == 5:
        node = f"tpu-node-{(i // 6) % 2}"
        ready = (i // 12) % 2 == 1
        cluster.set_node_ready(node, ready)
        lines.append(f"churn: {node} Ready -> {ready}")
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    port = int(argv[0]) if argv and argv[0].isdigit() else 9988
    churn = "--churn" in argv
    cluster = MockCluster()
    seed_nodes(cluster)
    seed_slice(cluster)
    server = MockApiServer(cluster, port=port).start()
    print(f"mock k8s API server listening on {server.url} (Ctrl-C to stop)", flush=True)
    try:
        i = 0
        while True:
            time.sleep(CHURN_PERIOD_S)
            if churn:
                for line in churn_step(cluster, i):
                    print(line, flush=True)
                i += 1
    except KeyboardInterrupt:
        print("stopping", flush=True)
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
