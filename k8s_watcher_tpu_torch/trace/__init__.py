"""The tracing plane (the JAX package's ``trace/``): per-process journeys in
``trace/trace.py``, the federator's cross-cluster joining and diagnosis in
``trace/federation.py``. Every name the single-module form exported is
re-exported here, so ``from k8s_watcher_tpu_torch.trace import ...`` reads
as it always did."""

from k8s_watcher_tpu_torch.trace.federation import FleetTraceCollector
from k8s_watcher_tpu_torch.trace.trace import (
    ALL_STAGES,
    ANOMALY_OUTCOMES,
    FEDERATE_MERGE_STAGE,
    FEDERATION_STAGES,
    GLOBAL_SERVE_STAGE,
    SERVE_STAGE,
    SERVE_WIRE_STAGE,
    STAGES,
    WAL_STAGE,
    Trace,
    TraceRing,
    TraceSampler,
    Tracer,
    clear_current_traces,
    current_traces,
    export_trace,
    logger,
    new_trace_id,
    note_send_attempt,
    observe_conn_borrow,
    send_attempts,
    set_current_traces,
    trace_from_wire,
    wire_trace,
)

__all__ = [
    "ALL_STAGES",
    "ANOMALY_OUTCOMES",
    "FEDERATE_MERGE_STAGE",
    "FEDERATION_STAGES",
    "FleetTraceCollector",
    "GLOBAL_SERVE_STAGE",
    "SERVE_STAGE",
    "SERVE_WIRE_STAGE",
    "STAGES",
    "WAL_STAGE",
    "Trace",
    "TraceRing",
    "TraceSampler",
    "Tracer",
    "clear_current_traces",
    "current_traces",
    "export_trace",
    "new_trace_id",
    "note_send_attempt",
    "observe_conn_borrow",
    "send_attempts",
    "set_current_traces",
    "trace_from_wire",
    "wire_trace",
]
