"""The federation plane (the JAX package's ``federate/``): a consumer of
the serve wire protocol (``client``), the merged global fleet view
(``merge``), the in-process fan-in of N upstream subscriptions republished
through the local serving plane (``plane``), and its sharded form over
supervised merge-worker processes (``fanin``). Host code: nothing here
imports torch, so a spawned merge worker never initialises CUDA."""

from k8s_watcher_tpu_torch.federate.client import (
    AuthRejected,
    Batch,
    FleetClient,
    FleetSubscriber,
    ResumeLoop,
    ResyncRequired,
    SequenceChecker,
    ServeProtocolError,
    Snapshot,
    TokenStore,
    apply_wire_delta,
    apply_wire_deltas,
    model_from_objects,
)
from k8s_watcher_tpu_torch.federate.merge import (
    GlobalMerge,
    global_key,
    merged_equals_union,
    split_global_key,
)
from k8s_watcher_tpu_torch.federate.fanin import FaninPlan, ShardedFanin, fanin_plans
from k8s_watcher_tpu_torch.federate.plane import FederationPlane

__all__ = [
    "AuthRejected",
    "Batch",
    "FaninPlan",
    "FederationPlane",
    "ShardedFanin",
    "fanin_plans",
    "FleetClient",
    "FleetSubscriber",
    "GlobalMerge",
    "ResumeLoop",
    "ResyncRequired",
    "SequenceChecker",
    "ServeProtocolError",
    "Snapshot",
    "TokenStore",
    "apply_wire_delta",
    "apply_wire_deltas",
    "global_key",
    "merged_equals_union",
    "model_from_objects",
    "split_global_key",
]
