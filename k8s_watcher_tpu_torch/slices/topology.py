"""Slice-identity inference from GKE TPU pod metadata.

A multi-host TPU slice on GKE is an indexed Job (usually wrapped in a
JobSet): each worker pod carries the job name, a completion index, and
node-selector labels describing the requested accelerator and its physical
topology. The fields consumed here:

- ``jobset.sigs.k8s.io/jobset-name`` +
  ``jobset.sigs.k8s.io/replicatedjob-name`` (labels) — JobSet membership
- ``job-name`` / ``batch.kubernetes.io/job-name`` (labels) — the indexed Job
- ``batch.kubernetes.io/job-completion-index`` (label or annotation) /
  ``apps.kubernetes.io/pod-index`` — the worker index within the slice
- nodeSelector ``cloud.google.com/gke-tpu-topology`` — e.g. ``2x2x4``
- nodeSelector ``cloud.google.com/gke-tpu-accelerator`` — e.g.
  ``tpu-v5p-slice``
- container resource requests for ``google.com/tpu`` — chips per worker

Expected worker count = chips(topology) / chips-per-worker, so a slice knows
how many member pods it is waiting for before ever seeing them all.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

from k8s_watcher_tpu_torch.pipeline.filters import pod_accelerator_chips

JOBSET_NAME_LABEL = "jobset.sigs.k8s.io/jobset-name"
REPLICATED_JOB_LABEL = "jobset.sigs.k8s.io/replicatedjob-name"
JOB_NAME_LABELS = ("batch.kubernetes.io/job-name", "job-name")
COMPLETION_INDEX_KEYS = ("batch.kubernetes.io/job-completion-index", "apps.kubernetes.io/pod-index")


@dataclasses.dataclass(frozen=True)
class SliceIdentity:
    namespace: str
    name: str  # jobset/replicated-job (or bare job) identity
    worker_index: Optional[int]
    topology: Optional[str]  # e.g. "2x2x4"
    accelerator: Optional[str]  # e.g. "tpu-v5p-slice"
    chips_per_worker: int
    expected_workers: Optional[int]  # None = unknown

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    @property
    def total_chips(self) -> Optional[int]:
        if self.topology:
            return chips_in_topology(self.topology)
        if self.expected_workers and self.chips_per_worker:
            return self.expected_workers * self.chips_per_worker
        return None


@functools.lru_cache(maxsize=256)
def chips_in_topology(topology: str) -> Optional[int]:
    """``"2x2x4"`` -> 16; None for unparsable strings. Cached: a cluster
    uses a handful of distinct topology strings, but this parse runs on
    every event's identity inference (hot path at 10k+ events/s)."""
    try:
        dims = [int(d) for d in topology.lower().split("x")]
    except ValueError:
        return None
    if not dims or any(d <= 0 for d in dims):
        return None
    total = 1
    for d in dims:
        total *= d
    return total


def infer_slice_identity(
    pod: Dict[str, Any],
    *,
    resource_key: str = "google.com/tpu",
    topology_label: str = "cloud.google.com/gke-tpu-topology",
    accelerator_label: str = "cloud.google.com/gke-tpu-accelerator",
    chips: Optional[int] = None,
) -> Optional[SliceIdentity]:
    """Slice identity for a pod, or None for non-slice (or non-TPU) pods.

    ``chips`` accepts a precomputed ``pod_accelerator_chips`` result so
    the per-event hot path walks the container resources once, not once
    per stage."""
    metadata = pod.get("metadata") or {}
    labels = metadata.get("labels") or {}
    annotations = metadata.get("annotations") or {}
    node_selector = (pod.get("spec") or {}).get("nodeSelector") or {}

    jobset = labels.get(JOBSET_NAME_LABEL)
    replicated = labels.get(REPLICATED_JOB_LABEL)
    job = next((labels[k] for k in JOB_NAME_LABELS if k in labels), None)

    if jobset:
        name = f"{jobset}/{replicated}" if replicated else jobset
    elif job:
        name = job
    else:
        return None  # standalone pod: not slice-shaped

    if chips is None:
        chips = pod_accelerator_chips(pod, resource_key)
    if chips <= 0:
        return None

    index: Optional[int] = None
    for key in COMPLETION_INDEX_KEYS:
        raw = labels.get(key, annotations.get(key))
        if raw is not None:
            try:
                index = int(str(raw))
            except ValueError:
                pass
            break

    topology = node_selector.get(topology_label) or labels.get(topology_label)
    accelerator = node_selector.get(accelerator_label) or labels.get(accelerator_label)

    expected: Optional[int] = None
    total = chips_in_topology(topology) if topology else None
    if total and chips:
        expected = max(1, total // chips)

    return SliceIdentity(
        namespace=metadata.get("namespace", "default"),
        name=name,
        worker_index=index,
        topology=topology,
        accelerator=accelerator,
        chips_per_worker=chips,
        expected_workers=expected,
    )
