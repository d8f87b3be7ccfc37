"""Fleet analytics and what-if engine (the JAX package's ``analytics/``, with a
torch backend): the FleetView as dense integer columns, kernels on the
rank's GPU, and batched placement what-ifs behind ``/serve/analytics``, and the same
what-ifs over a replayed history WAL."""

from k8s_watcher_tpu_torch.analytics.backend import BACKENDS, ArrayBackend, resolve_backend
from k8s_watcher_tpu_torch.analytics.encode import (
    LOCAL_CLUSTER,
    POD_PHASES,
    SLICE_PHASES,
    FleetColumns,
    FleetEncoder,
    Interner,
    tables_from_objects,
)
from k8s_watcher_tpu_torch.analytics.kernels import FleetKernels, SliceRollup, WhatIfResult, crosscheck
from k8s_watcher_tpu_torch.analytics.plane import AnalyticsPlane
from k8s_watcher_tpu_torch.analytics.replay import (
    batched_replay_verdicts,
    comparable,
    sequential_replay_verdicts,
    verdicts_from_objects,
)
from k8s_watcher_tpu_torch.analytics.whatif import (
    SCENARIO_KINDS,
    Scenario,
    ScenarioError,
    build_masks,
    evaluate_scenarios,
    parse_scenarios,
    python_reference_verdicts,
)

__all__ = [
    "BACKENDS",
    "LOCAL_CLUSTER",
    "POD_PHASES",
    "SCENARIO_KINDS",
    "SLICE_PHASES",
    "AnalyticsPlane",
    "ArrayBackend",
    "FleetColumns",
    "FleetEncoder",
    "FleetKernels",
    "Interner",
    "Scenario",
    "ScenarioError",
    "SliceRollup",
    "WhatIfResult",
    "batched_replay_verdicts",
    "build_masks",
    "comparable",
    "crosscheck",
    "evaluate_scenarios",
    "parse_scenarios",
    "python_reference_verdicts",
    "resolve_backend",
    "sequential_replay_verdicts",
    "tables_from_objects",
    "verdicts_from_objects",
]
