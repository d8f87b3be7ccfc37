"""Deterministic fault/churn generators (the JAX package's
``faults/injection.py``: the same seed gives the same events in the same
order, and the same failures).

These helpers produce churn and notifier faults deterministically (seeded
PRNG, no wall-clock randomness) so a churn test is reproducible:

- ``ChurnGenerator``: a scripted fleet of slice pods cycling through
  create/ready/preempt/fail/delete transitions.
- ``FaultyNotifier``: wraps a send callable, failing a configurable fraction
  of calls (and optionally delaying) to exercise retry + backpressure.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Dict, Iterator, Optional

from k8s_watcher_tpu_torch.watch.fake import build_pod
from k8s_watcher_tpu_torch.watch.source import EventType, WatchEvent


class ChurnGenerator:
    """Generate a deterministic stream of slice-pod churn events."""

    def __init__(
        self,
        *,
        n_slices: int = 4,
        workers_per_slice: int = 4,
        chips_per_worker: int = 4,
        namespace: str = "default",
        seed: int = 0,
        preempt_prob: float = 0.05,
        fail_prob: float = 0.02,
        node_namer: Optional[Callable[[int, int], str]] = None,
    ):
        self.n_slices = n_slices
        self.workers_per_slice = workers_per_slice
        self.chips_per_worker = chips_per_worker
        self.namespace = namespace
        self.rng = random.Random(seed)
        self.preempt_prob = preempt_prob
        self.fail_prob = fail_prob
        # (slice_idx, worker_idx) -> spec.nodeName: gives churned pods a
        # stable host identity so node-attributed consumers (the health
        # plane's phase-latency scoring, slice node-down folding) see
        # realistic placement. None keeps pods unscheduled.
        self.node_namer = node_namer
        self._rv = 0
        # worker state: (slice_idx, worker_idx) -> phase or None (deleted)
        self._phase: Dict[tuple, Optional[str]] = {}

    def _pod(self, s: int, w: int, phase: str, *, preempted: bool = False) -> Dict[str, Any]:
        self._rv += 1
        topology_chips = self.workers_per_slice * self.chips_per_worker
        conditions = None
        if preempted:
            # what a real spot/preemptible TPU worker carries on its way
            # out: the scheduler's status.reason plus the k8s >=1.26
            # DisruptionTarget condition — downstream payloads classify
            # this into the `disruption` block (pipeline/extract.py)
            conditions = [{
                "type": "DisruptionTarget",
                "status": "True",
                "reason": "PreemptionByScheduler",
                "message": "preempted by higher-priority workload",
            }]
        return build_pod(
            f"slice{s}-worker-{w}",
            self.namespace,
            uid=f"uid-s{s}-w{w}",
            node_name=self.node_namer(s, w) if self.node_namer is not None else None,
            phase=phase,
            tpu_chips=self.chips_per_worker,
            tpu_topology=f"1x1x{topology_chips}",
            tpu_accelerator="tpu-v5p-slice",
            gke_slice_fields={
                "jobset.sigs.k8s.io/jobset-name": f"train-{s}",
                "batch.kubernetes.io/job-name": f"train-{s}-job",
                "batch.kubernetes.io/job-completion-index": w,
            },
            container_statuses=[{"name": "main", "ready": phase == "Running", "restartCount": 0}],
            resource_version=str(self._rv),
            status_reason="Preempted" if preempted else None,
            conditions=conditions,
        )

    def events(self, n_events: int) -> Iterator[WatchEvent]:
        """Yield exactly ``n_events`` churn events."""
        emitted = 0
        while emitted < n_events:
            s = self.rng.randrange(self.n_slices)
            w = self.rng.randrange(self.workers_per_slice)
            key = (s, w)
            phase = self._phase.get(key)
            roll = self.rng.random()

            preempted = False
            if phase is None:  # (re)create
                new_phase, etype = "Pending", EventType.ADDED
            elif phase == "Pending":
                new_phase, etype = "Running", EventType.MODIFIED
            elif phase == "Running":
                if roll < self.fail_prob:
                    new_phase, etype = "Failed", EventType.MODIFIED
                elif roll < self.fail_prob + self.preempt_prob:
                    new_phase, etype = None, EventType.DELETED  # preemption
                    preempted = True
                else:
                    new_phase, etype = "Running", EventType.MODIFIED  # status noise
            else:  # Failed -> controller deletes, then recreated later
                new_phase, etype = None, EventType.DELETED

            pod_phase = new_phase if new_phase is not None else (phase or "Running")
            event = WatchEvent(
                type=etype,
                pod=self._pod(s, w, pod_phase, preempted=preempted),
                resource_version=str(self._rv),
            )
            self._phase[key] = new_phase
            emitted += 1
            yield event


class FaultyNotifier:
    """Wrap a ``send(payload) -> bool`` with seeded failures/latency."""

    def __init__(
        self,
        send: Callable[[Dict[str, Any]], bool],
        *,
        fail_prob: float = 0.0,
        delay_seconds: float = 0.0,
        seed: int = 0,
    ):
        self._send = send
        self.fail_prob = fail_prob
        self.delay_seconds = delay_seconds
        self.rng = random.Random(seed)
        self.calls = 0
        self.injected_failures = 0

    def __call__(self, payload: Dict[str, Any]) -> bool:
        self.calls += 1
        if self.delay_seconds:
            time.sleep(self.delay_seconds)
        if self.fail_prob and self.rng.random() < self.fail_prob:
            self.injected_failures += 1
            return False
        return self._send(payload)
