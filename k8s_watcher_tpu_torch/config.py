"""Typed configuration, loaded from the repo's ``config/*.yaml``.

The JAX package's ``config/schema.py`` and ``config/loader.py`` in one
module: the same sixteen top-level sections, field names, defaults and
validation messages, and the same loading — ``config/base.yaml``, then
``config/<environment>.yaml`` merged over it (the overlay wins), then
whole-string ``${VAR}`` / ``${VAR:-default}`` tokens replaced from the
environment. Unknown keys are rejected.

- :func:`load_app_config` gives the whole ``AppConfig`` (the watcher's);
- :func:`load_config` gives the ``tpu`` section alone (``TpuConfig``);
- :func:`load_agent_config` gives what the probe agent's loop reads:
  ``tpu``, ``clusterapi`` (the notifier), ``kubernetes`` (remediation's
  apiserver connection) and ``watcher.log_level``.

Some sections configure planes the port does not carry yet; they load and
validate here, and the port's ``WatcherApp`` refuses to start with one of
them enabled.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Sequence

import yaml

logger = logging.getLogger(__name__)

SUPPORTED_ENVIRONMENTS = ("development", "staging", "production")
DEFAULT_ENVIRONMENT = "development"


class ConfigError(ValueError):
    """An unreadable or malformed config file, or a value that fails validation."""


# The single home of the accepted taint effects — the schema validates
# config against it and remediate.NodeActuator validates its argument
# against it (schema is the dependency-light layer, so it lives here).
VALID_TAINT_EFFECTS = ("NoSchedule", "PreferNoSchedule", "NoExecute")
# ingest.prefilter (native/scanner.py make_scanner) vocabulary
VALID_PREFILTER_MODES = ("auto", "native", "python", "off")


def _type_name(value: Any) -> str:
    return type(value).__name__


def _expect(value: Any, types: tuple, path: str) -> Any:
    if not isinstance(value, types):
        wanted = "/".join(t.__name__ for t in types)
        raise ConfigError(f"config key '{path}': expected {wanted}, got {_type_name(value)} ({value!r})")
    # bool is a subclass of int — reject bools where ints are wanted.
    if bool not in types and isinstance(value, bool) and int in types:
        raise ConfigError(f"config key '{path}': expected int, got bool")
    return value


def _opt_str(raw: Mapping[str, Any], key: str, path: str, default: Optional[str] = None) -> Optional[str]:
    if key not in raw or raw[key] is None:
        return default
    v = _expect(raw[key], (str,), f"{path}.{key}")
    return v if v != "" else default


def _opt_num(raw: Mapping[str, Any], key: str, path: str, default: float) -> float:
    if key not in raw or raw[key] is None:
        return default
    v = raw[key]
    if isinstance(v, str):  # env-substituted values arrive as strings
        if v.strip() == "":
            return default
        try:
            return float(v)
        except ValueError:
            raise ConfigError(f"config key '{path}.{key}': not a number: {v!r}")
    return float(_expect(v, (int, float), f"{path}.{key}"))


def _opt_int(raw: Mapping[str, Any], key: str, path: str, default: int) -> int:
    if key not in raw or raw[key] is None:
        return default
    v = raw[key]
    if isinstance(v, str):  # env-substituted values arrive as strings
        if v.strip() == "":
            return default
        try:
            return int(v)
        except ValueError:
            raise ConfigError(f"config key '{path}.{key}': not an integer: {v!r}")
    return _expect(v, (int,), f"{path}.{key}")


def _opt_bool(raw: Mapping[str, Any], key: str, path: str, default: bool) -> bool:
    if key not in raw or raw[key] is None:
        return default
    v = raw[key]
    # env-substituted values arrive as strings ("true"/"false")
    if isinstance(v, str):
        low = v.strip().lower()
        if low in ("true", "1", "yes", "on"):
            return True
        if low in ("false", "0", "no", "off", ""):
            return False
        raise ConfigError(f"config key '{path}.{key}': not a boolean: {v!r}")
    return _expect(v, (bool,), f"{path}.{key}")


def _check_known(raw: Mapping[str, Any], known: Sequence[str], path: str) -> None:
    unknown = sorted(set(raw) - set(known))
    if unknown:
        raise ConfigError(f"unknown config key(s) under '{path}': {', '.join(unknown)} (known: {', '.join(sorted(known))})")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry/backoff policy (reference base.yaml:10-12,24-26 — dead there, wired here)."""

    max_attempts: int = 3
    delay_seconds: float = 5.0
    # net-new: exponential backoff knobs for the resilient watch loop
    max_delay_seconds: float = 60.0
    backoff_multiplier: float = 2.0

    @classmethod
    def from_raw(cls, raw: Mapping[str, Any], path: str, *, delay_default: float = 5.0) -> "RetryPolicy":
        _check_known(raw, ("max_attempts", "delay_seconds", "max_delay_seconds", "backoff_multiplier"), path)
        return cls(
            max_attempts=_opt_int(raw, "max_attempts", path, 3),
            delay_seconds=_opt_num(raw, "delay_seconds", path, delay_default),
            max_delay_seconds=_opt_num(raw, "max_delay_seconds", path, 60.0),
            backoff_multiplier=_opt_num(raw, "backoff_multiplier", path, 2.0),
        )


def leader_timing_error(lease_duration: float, renew_deadline: float, retry_period: float) -> Optional[str]:
    """The one place the leader-election timing invariants live (used by both
    the config schema and ``LeaderElector.__init__``). Returns an error
    message, or None if the timings are safe.

    Compares against ``int(lease_duration)`` because ``leaseDurationSeconds``
    is an integer on the wire — a fractional duration would otherwise let
    ``renew_deadline`` exceed what observers actually enforce, and a leader
    could believe it still leads after a standby has legally stolen the lease.
    """
    if lease_duration < 1.0:
        return "lease_duration_seconds must be >= 1 (integer on the wire)"
    if retry_period <= 0 or renew_deadline <= 0:
        return "retry_period_seconds and renew_deadline_seconds must be > 0"
    if renew_deadline >= float(int(lease_duration)):
        return "renew_deadline_seconds must be < int(lease_duration_seconds) (the wire value is a truncated integer)"
    if retry_period >= renew_deadline:
        return "retry_period_seconds must be < renew_deadline_seconds (need >1 renew attempt per deadline)"
    return None


@dataclasses.dataclass(frozen=True)
class LeaderElectionConfig:
    """The ``watcher.leader_election:`` section — net-new HA (SURVEY.md §5
    failure detection: the reference was a singleton with no failover).

    N watcher replicas campaign for a coordination.k8s.io/v1 Lease; exactly
    one watches + notifies, the rest stand by hot and take over within
    ``lease_duration_seconds`` of a leader crash (immediately on clean exit).
    """

    enabled: bool = False
    lease_name: str = "k8s-watcher-tpu"
    lease_namespace: str = "default"
    lease_duration_seconds: float = 15.0
    renew_deadline_seconds: float = 10.0
    retry_period_seconds: float = 2.0
    identity: Optional[str] = None  # default: <hostname>-<pid>

    @classmethod
    def from_raw(cls, raw: Mapping[str, Any]) -> "LeaderElectionConfig":
        path = "watcher.leader_election"
        _check_known(
            raw,
            ("enabled", "lease_name", "lease_namespace", "lease_duration_seconds",
             "renew_deadline_seconds", "retry_period_seconds", "identity"),
            path,
        )
        cfg = cls(
            enabled=_opt_bool(raw, "enabled", path, False),
            lease_name=_opt_str(raw, "lease_name", path, cls.lease_name),
            lease_namespace=_opt_str(raw, "lease_namespace", path, cls.lease_namespace),
            lease_duration_seconds=_opt_num(raw, "lease_duration_seconds", path, 15.0),
            renew_deadline_seconds=_opt_num(raw, "renew_deadline_seconds", path, 10.0),
            retry_period_seconds=_opt_num(raw, "retry_period_seconds", path, 2.0),
            identity=_opt_str(raw, "identity", path, None),
        )
        if cfg.enabled:
            error = leader_timing_error(
                cfg.lease_duration_seconds, cfg.renew_deadline_seconds, cfg.retry_period_seconds
            )
            if error:
                raise ConfigError(f"config key '{path}': {error}")
        return cfg


@dataclasses.dataclass(frozen=True)
class WatcherConfig:
    """The ``watcher:`` section (reference base.yaml:1-12, production.yaml:16-25)."""

    watch_interval: float = 1.0
    log_level: str = "INFO"
    namespaces: tuple = ()
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    critical_events_only: bool = False
    # net-new observability + server-side filtering
    status_port: int = 0  # 0 = no /metrics//healthz endpoint
    # Bearer token required on every status route except /healthz; None
    # leaves the plane open (in-cluster behind NetworkPolicy — RUNBOOK
    # "Status-server threat model"). Inject via ${WATCHER_STATUS_TOKEN}
    # interpolation rather than a literal in a committed file.
    status_auth_token: Optional[str] = None
    liveness_stale_seconds: float = 900.0
    label_selector: Optional[str] = None  # k8s labelSelector pushed to the API server
    leader_election: LeaderElectionConfig = dataclasses.field(default_factory=LeaderElectionConfig)
    # last-N pipeline decisions served at /debug/events (0 disables)
    audit_ring_size: int = 256
    # LIST pagination (limit+continue) page size for the initial list and
    # every relist — bounds apiserver response size and watcher peak memory
    # on large clusters (client-go's default is 500)
    list_page_size: int = 500

    @classmethod
    def from_raw(cls, raw: Mapping[str, Any]) -> "WatcherConfig":
        _check_known(
            raw,
            ("watch_interval", "log_level", "namespaces", "retry", "alerts",
             "status_port", "status_auth_token", "liveness_stale_seconds",
             "label_selector", "leader_election",
             "audit_ring_size", "list_page_size"),
            "watcher",
        )
        namespaces = raw.get("namespaces") or ()
        if namespaces:
            _expect(namespaces, (list, tuple), "watcher.namespaces")
            namespaces = tuple(_expect(ns, (str,), "watcher.namespaces[]") for ns in namespaces)
        alerts = raw.get("alerts") or {}
        _expect(alerts, (dict,), "watcher.alerts")
        _check_known(alerts, ("critical_events_only",), "watcher.alerts")
        _expect(raw.get("leader_election") or {}, (dict,), "watcher.leader_election")
        level = _expect(raw.get("log_level", "INFO"), (str,), "watcher.log_level").upper()
        if level not in ("DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"):
            raise ConfigError(f"config key 'watcher.log_level': invalid level {level!r}")
        page_size = _opt_int(raw, "list_page_size", "watcher", 500)
        if page_size < 1:
            raise ConfigError(
                f"config key 'watcher.list_page_size': must be >= 1, got {page_size}"
            )
        return cls(
            watch_interval=_opt_num(raw, "watch_interval", "watcher", 1.0),
            log_level=level,
            namespaces=namespaces,
            retry=RetryPolicy.from_raw(raw.get("retry") or {}, "watcher.retry", delay_default=5.0),
            critical_events_only=_opt_bool(alerts, "critical_events_only", "watcher.alerts", False),
            status_port=_opt_int(raw, "status_port", "watcher", 0),
            status_auth_token=_opt_str(raw, "status_auth_token", "watcher", None) or None,
            liveness_stale_seconds=_opt_num(raw, "liveness_stale_seconds", "watcher", 900.0),
            label_selector=_opt_str(raw, "label_selector", "watcher", None),
            leader_election=LeaderElectionConfig.from_raw(raw.get("leader_election") or {}),
            audit_ring_size=_opt_int(raw, "audit_ring_size", "watcher", 256),
            list_page_size=page_size,
        )


@dataclasses.dataclass(frozen=True)
class ClusterApiConfig:
    """The ``clusterapi:`` section (reference base.yaml:14-26, clusterapi_client.py).

    Unlike the reference, ``endpoints`` and ``timeout`` are actually consumed
    (reference hardcoded ``/api/pods/update`` at clusterapi_client.py:30 and
    never passed a timeout to requests.post at :36).
    """

    base_url: str = "http://localhost:3000"
    api_key: Optional[str] = None
    pod_update_endpoint: str = "/api/pods/update"
    pod_update_batch_endpoint: str = "/api/pods/update_batch"
    health_endpoint: str = "/health"
    timeout: float = 30.0
    retry: RetryPolicy = dataclasses.field(default_factory=lambda: RetryPolicy(delay_seconds=2.0))
    # net-new: async egress-plane knobs (keyed worker fan-out so one slow
    # POST can't stall the watch stream — prerequisite for the <1s p50
    # target — and distinct pods POST concurrently under churn)
    queue_capacity: int = 1024
    # egress worker count (= lane count: notifications hash by coalesce
    # key onto per-worker FIFO lanes). 0 = auto: scale with ingest.shards
    # (max(2, 2 x shards) — the fan-in side grows with the fan-out side)
    workers: int = 0
    # latest-wins per pod/slice while queued: update_pod_status is a state
    # update, so a newer payload supersedes an unsent older one for the same
    # object (bounds queue growth per object under churn)
    coalesce: bool = True
    # lane depth at which latest-wins collapse starts. Below it same-key
    # updates queue uncollapsed (the receiver sees every transition while
    # egress keeps up); 0 = collapse whenever a same-key payload is still
    # waiting
    coalesce_watermark: int = 0
    # pooled keep-alive connections to the notify target; 0 = match workers
    pool_size: int = 0
    # micro-batch size for the batched update_pod_statuses endpoint under
    # backlog; 0/1 = per-item sends only (a receiver without the batch
    # endpoint falls back automatically either way)
    batch_max: int = 0
    # /healthz turns 503 when a lane with backlog has made no progress for
    # this long (worker wedged inside a send against a hung target) or
    # every egress worker is dead — egress liveness, the counterpart of
    # watcher.liveness_stale_seconds for the notify side
    egress_stall_seconds: float = 120.0
    verify_tls: bool = True  # for https endpoints with self-signed certs

    @classmethod
    def from_raw(cls, raw: Mapping[str, Any]) -> "ClusterApiConfig":
        _check_known(
            raw,
            ("base_url", "auth", "endpoints", "timeout", "retry", "queue_capacity", "workers",
             "coalesce", "coalesce_watermark", "pool_size", "batch_max",
             "egress_stall_seconds", "verify_tls"),
            "clusterapi",
        )
        auth = raw.get("auth") or {}
        _expect(auth, (dict,), "clusterapi.auth")
        _check_known(auth, ("api_key",), "clusterapi.auth")
        endpoints = raw.get("endpoints") or {}
        _expect(endpoints, (dict,), "clusterapi.endpoints")
        _check_known(endpoints, ("pod_update", "pod_update_batch", "health"), "clusterapi.endpoints")
        for key, floor in (("workers", 0), ("coalesce_watermark", 0), ("pool_size", 0), ("batch_max", 0)):
            if _opt_int(raw, key, "clusterapi", 0) < floor:
                raise ConfigError(f"config key 'clusterapi.{key}': must be >= {floor}")
        stall = _opt_num(raw, "egress_stall_seconds", "clusterapi", 120.0)
        if stall <= 0:
            raise ConfigError(
                f"config key 'clusterapi.egress_stall_seconds': must be > 0, got {stall} "
                f"(a non-positive threshold would 503 on every queued send)"
            )
        return cls(
            base_url=_opt_str(raw, "base_url", "clusterapi", "http://localhost:3000").rstrip("/"),
            api_key=_opt_str(auth, "api_key", "clusterapi.auth", None),
            pod_update_endpoint=_opt_str(endpoints, "pod_update", "clusterapi.endpoints", "/api/pods/update"),
            pod_update_batch_endpoint=_opt_str(
                endpoints, "pod_update_batch", "clusterapi.endpoints", "/api/pods/update_batch"
            ),
            health_endpoint=_opt_str(endpoints, "health", "clusterapi.endpoints", "/health"),
            timeout=_opt_num(raw, "timeout", "clusterapi", 30.0),
            retry=RetryPolicy.from_raw(raw.get("retry") or {}, "clusterapi.retry", delay_default=2.0),
            queue_capacity=_opt_int(raw, "queue_capacity", "clusterapi", 1024),
            workers=_opt_int(raw, "workers", "clusterapi", 0),
            coalesce=_opt_bool(raw, "coalesce", "clusterapi", True),
            coalesce_watermark=_opt_int(raw, "coalesce_watermark", "clusterapi", 0),
            pool_size=_opt_int(raw, "pool_size", "clusterapi", 0),
            batch_max=_opt_int(raw, "batch_max", "clusterapi", 0),
            egress_stall_seconds=stall,
            verify_tls=_opt_bool(raw, "verify_tls", "clusterapi", True),
        )

    def resolved_workers(self, ingest_shards: int = 1) -> int:
        """The egress worker/lane count: explicit, or scaled with the
        ingest fan-out (max(2, 2 x shards)) when ``workers: 0``."""
        return self.workers or max(2, 2 * max(1, ingest_shards))

    def resolved_pool_size(self, ingest_shards: int = 1) -> int:
        """Connection-pool size: explicit, or one keep-alive connection
        per egress worker so workers never serialize on a socket."""
        return self.pool_size or self.resolved_workers(ingest_shards)


@dataclasses.dataclass(frozen=True)
class KubernetesConfig:
    """The ``kubernetes:`` section (reference development.yaml:4-7, production.yaml:4-8)."""

    use_incluster_config: bool = False
    config_file: Optional[str] = None
    use_mock: bool = False
    # net-new: resilient-watch knobs (reference had no reconnect at all —
    # SURVEY.md §2 defect #4)
    request_timeout: float = 30.0
    watch_timeout_seconds: int = 300
    verify_tls: bool = True

    @classmethod
    def from_raw(cls, raw: Mapping[str, Any]) -> "KubernetesConfig":
        _check_known(
            raw,
            ("use_incluster_config", "config_file", "use_mock", "request_timeout", "watch_timeout_seconds", "verify_tls"),
            "kubernetes",
        )
        return cls(
            use_incluster_config=_opt_bool(raw, "use_incluster_config", "kubernetes", False),
            config_file=_opt_str(raw, "config_file", "kubernetes", None),
            use_mock=_opt_bool(raw, "use_mock", "kubernetes", False),
            request_timeout=_opt_num(raw, "request_timeout", "kubernetes", 30.0),
            watch_timeout_seconds=_opt_int(raw, "watch_timeout_seconds", "kubernetes", 300),
            verify_tls=_opt_bool(raw, "verify_tls", "kubernetes", True),
        )


@dataclasses.dataclass(frozen=True)
class TpuConfig:
    """The ``tpu:`` section — net-new (north star: BASELINE.json).

    Selects the accelerator backend, the pod resource key used by the
    resource filter, slice-topology expectations, and in-slice probe
    cadence/thresholds.
    """

    backend: str = "tpu"  # "tpu" | "gpu" (gpu-compat mode filters nvidia.com/gpu)
    resource_key: str = "google.com/tpu"
    # native watch-frame prefilter (native/scanner.py): skip json.loads for
    # frames that cannot contain resource_key — pure speedup, no semantic
    # change (the pipeline's TpuResourceFilter would drop them anyway)
    prefilter: bool = True
    # GKE labels/annotations used for slice-topology inference
    topology_label: str = "cloud.google.com/gke-tpu-topology"
    accelerator_label: str = "cloud.google.com/gke-tpu-accelerator"
    # probe plane
    probe_enabled: bool = False
    probe_interval_seconds: float = 30.0
    # standalone probe agent's own scrape surface (scripts/probe_agent.py):
    # /metrics (gauges incl. per-cycle medians), /healthz (cycle liveness),
    # /debug/trend. 0 = off. The watcher's in-process agent shares the
    # watcher's watcher.status_port server instead.
    probe_status_port: int = 0
    # bearer token for the agent's status plane — same contract as
    # watcher.status_auth_token (RUNBOOK "Status-server threat model")
    probe_status_auth_token: Optional[str] = None
    probe_payload_bytes: int = 4 * 1024 * 1024
    probe_rtt_warn_ms: float = 50.0
    probe_matmul_size: int = 1024
    # dependent-matmul chain length per timed call: device time must dwarf
    # the host fence (2*size^3*inner FLOPs; over a dev tunnel the fence is
    # tens of ms, so soak/bench-grade fidelity wants size 4096 x inner 128)
    probe_matmul_inner_iters: int = 8
    probe_hbm_bytes: int = 256 * 1024 * 1024  # 0 disables the HBM sweep
    # write-bandwidth + pattern-integrity pass (block-indexed pattern write,
    # per-block checksum readback localizing bad HBM address ranges)
    probe_hbm_write_enabled: bool = True
    expected_chips_per_host: int = 0  # 0 = don't enforce
    # per-link localization probe (probe/links.py): O(links) small compiles,
    # so off by default; turn on to get which-chip/which-link diagnostics
    probe_links_enabled: bool = False
    probe_link_rtt_factor: float = 3.0
    # absolute outlier floor per hop — raise on fabrics whose healthy RTT
    # jitter exceeds the default (e.g. DCN-backed inter-host columns)
    probe_link_rtt_floor_ms: float = 0.05
    # cross-cycle drift detection (probe/trend.py): flags sustained decay
    # hiding inside the per-cycle noise band. Factors are deliberately far
    # outside the documented noise (ARCHITECTURE.md) to avoid false alerts
    # on tunneled dev links; tighten on local deployments.
    probe_trend_enabled: bool = True
    probe_trend_window: int = 16
    probe_trend_recent: int = 3
    probe_trend_drop_factor: float = 0.75
    probe_trend_rise_factor: float = 2.5
    probe_trend_min_history: int = 6
    # cross-slice DCN aggregation probe (probe/multislice.py)
    probe_multislice_enabled: bool = False
    probe_multislice_slices: int = 0  # 0 = infer from Device.slice_index
    # per-pair DCN walk: O(n_slices^2) small programs localizing WHICH
    # slice's DCN path is degraded (the slice-level analogue of the link
    # walk); cheap at realistic slice counts
    probe_multislice_pair_localization: bool = True
    # when set, each probe cycle is traced with torch.profiler into this
    # directory (a chrome trace per cycle)
    probe_profile_dir: Optional[str] = None
    # node-plane watching: Ready→NotReady on a TPU node degrades its slices
    # immediately (pod eviction lags the node drop by minutes)
    node_watch_enabled: bool = False
    node_watch_label_selector: Optional[str] = None
    # remediation plane (remediate/): quarantine (cordon + taint) nodes the
    # probe implicates across confirm_cycles consecutive cycles. dry_run
    # stays the default — flip it only after watching the dry-run decisions
    # in production for a while (RUNBOOK.md "Remediation").
    remediation_enabled: bool = False
    remediation_dry_run: bool = True
    remediation_cordon: bool = True
    remediation_taint_key: str = "k8s-watcher-tpu/ici-fault"
    remediation_taint_value: str = "suspect"
    remediation_taint_effect: str = "NoSchedule"
    remediation_confirm_cycles: int = 3
    remediation_cooldown_seconds: float = 3600.0
    remediation_max_actions_per_hour: int = 4
    remediation_max_quarantined_nodes: int = 2

    @classmethod
    def from_raw(cls, raw: Mapping[str, Any]) -> "TpuConfig":
        _check_known(
            raw,
            (
                "backend",
                "resource_key",
                "prefilter",
                "topology_label",
                "accelerator_label",
                "probe",
                "node_watch",
                "remediation",
            ),
            "tpu",
        )
        backend = _opt_str(raw, "backend", "tpu", "tpu")
        if backend not in ("tpu", "gpu"):
            raise ConfigError(f"config key 'tpu.backend': must be 'tpu' or 'gpu', got {backend!r}")
        default_key = "google.com/tpu" if backend == "tpu" else "nvidia.com/gpu"
        node_watch = raw.get("node_watch") or {}
        _expect(node_watch, (dict,), "tpu.node_watch")
        _check_known(node_watch, ("enabled", "label_selector"), "tpu.node_watch")
        remediation = raw.get("remediation") or {}
        _expect(remediation, (dict,), "tpu.remediation")
        _check_known(
            remediation,
            ("enabled", "dry_run", "cordon", "taint_key", "taint_value", "taint_effect",
             "confirm_cycles", "cooldown_seconds", "max_actions_per_hour",
             "max_quarantined_nodes"),
            "tpu.remediation",
        )
        taint_effect = _opt_str(remediation, "taint_effect", "tpu.remediation", "NoSchedule")
        if taint_effect not in VALID_TAINT_EFFECTS:
            raise ConfigError(
                f"config key 'tpu.remediation.taint_effect': must be one of "
                f"{', '.join(VALID_TAINT_EFFECTS)}, got {taint_effect!r}"
            )
        remediation_confirm = _opt_int(remediation, "confirm_cycles", "tpu.remediation", 3)
        if remediation_confirm < 1:
            raise ConfigError("config key 'tpu.remediation.confirm_cycles': must be >= 1")
        remediation_budget = _opt_int(remediation, "max_quarantined_nodes", "tpu.remediation", 2)
        if remediation_budget < 1:
            raise ConfigError("config key 'tpu.remediation.max_quarantined_nodes': must be >= 1")
        remediation_rate = _opt_int(remediation, "max_actions_per_hour", "tpu.remediation", 4)
        if remediation_rate < 1:
            raise ConfigError("config key 'tpu.remediation.max_actions_per_hour': must be >= 1")
        remediation_cooldown = _opt_num(remediation, "cooldown_seconds", "tpu.remediation", 3600.0)
        if remediation_cooldown < 0:
            raise ConfigError(
                "config key 'tpu.remediation.cooldown_seconds': must be >= 0 "
                "(a negative value would silently disable the cooldown fence)"
            )
        probe = raw.get("probe") or {}
        _expect(probe, (dict,), "tpu.probe")
        _check_known(
            probe,
            ("enabled", "interval_seconds", "status_port", "status_auth_token", "payload_bytes", "rtt_warn_ms", "matmul_size",
             "matmul_inner_iters",
             "hbm_bytes", "hbm_write_enabled", "expected_chips_per_host", "links_enabled",
             "link_rtt_factor", "link_rtt_floor_ms", "multislice_enabled",
             "multislice_slices", "multislice_pair_localization",
             "profile_dir", "trend_enabled", "trend_window",
             "trend_recent", "trend_drop_factor", "trend_rise_factor",
             "trend_min_history"),
            "tpu.probe",
        )
        # trend knobs have relational constraints; reject them HERE with the
        # key path (the repo's ConfigError convention) instead of letting
        # TrendTracker's bare ValueError crash the watcher at agent startup
        trend_window = _opt_int(probe, "trend_window", "tpu.probe", 16)
        trend_recent = _opt_int(probe, "trend_recent", "tpu.probe", 3)
        trend_min_history = _opt_int(probe, "trend_min_history", "tpu.probe", 6)
        trend_drop = _opt_num(probe, "trend_drop_factor", "tpu.probe", 0.75)
        trend_rise = _opt_num(probe, "trend_rise_factor", "tpu.probe", 2.5)
        if not 0.0 < trend_drop < 1.0:
            raise ConfigError(
                f"config key 'tpu.probe.trend_drop_factor': must be in (0, 1) — a "
                f"factor >= 1 alerts on every healthy cycle — got {trend_drop}"
            )
        if trend_rise <= 1.0:
            raise ConfigError(
                f"config key 'tpu.probe.trend_rise_factor': must be > 1 — a "
                f"factor <= 1 alerts on every healthy cycle — got {trend_rise}"
            )
        if not 1 <= trend_recent < trend_window:
            raise ConfigError(
                f"config key 'tpu.probe.trend_recent': need trend_window > "
                f"trend_recent >= 1, got recent={trend_recent} window={trend_window}"
            )
        if not trend_recent + 1 <= trend_min_history <= trend_window:
            raise ConfigError(
                f"config key 'tpu.probe.trend_min_history': need trend_recent+1 <= "
                f"trend_min_history <= trend_window (the anchor freezes at window "
                f"samples), got min_history={trend_min_history} recent={trend_recent} "
                f"window={trend_window}"
            )
        return cls(
            backend=backend,
            resource_key=_opt_str(raw, "resource_key", "tpu", default_key),
            prefilter=_opt_bool(raw, "prefilter", "tpu", True),
            topology_label=_opt_str(raw, "topology_label", "tpu", cls.topology_label),
            accelerator_label=_opt_str(raw, "accelerator_label", "tpu", cls.accelerator_label),
            probe_enabled=_opt_bool(probe, "enabled", "tpu.probe", False),
            probe_interval_seconds=_opt_num(probe, "interval_seconds", "tpu.probe", 30.0),
            probe_status_port=_opt_int(probe, "status_port", "tpu.probe", 0),
            probe_status_auth_token=_opt_str(probe, "status_auth_token", "tpu.probe", None) or None,
            probe_payload_bytes=_opt_int(probe, "payload_bytes", "tpu.probe", 4 * 1024 * 1024),
            probe_rtt_warn_ms=_opt_num(probe, "rtt_warn_ms", "tpu.probe", 50.0),
            probe_matmul_size=_opt_int(probe, "matmul_size", "tpu.probe", 1024),
            probe_matmul_inner_iters=_opt_int(probe, "matmul_inner_iters", "tpu.probe", 8),
            probe_hbm_bytes=_opt_int(probe, "hbm_bytes", "tpu.probe", 256 * 1024 * 1024),
            probe_hbm_write_enabled=_opt_bool(probe, "hbm_write_enabled", "tpu.probe", True),
            expected_chips_per_host=_opt_int(probe, "expected_chips_per_host", "tpu.probe", 0),
            probe_links_enabled=_opt_bool(probe, "links_enabled", "tpu.probe", False),
            probe_link_rtt_factor=_opt_num(probe, "link_rtt_factor", "tpu.probe", 3.0),
            probe_link_rtt_floor_ms=_opt_num(probe, "link_rtt_floor_ms", "tpu.probe", 0.05),
            probe_trend_enabled=_opt_bool(probe, "trend_enabled", "tpu.probe", True),
            probe_trend_window=trend_window,
            probe_trend_recent=trend_recent,
            probe_trend_drop_factor=trend_drop,
            probe_trend_rise_factor=trend_rise,
            probe_trend_min_history=trend_min_history,
            probe_multislice_enabled=_opt_bool(probe, "multislice_enabled", "tpu.probe", False),
            probe_multislice_slices=_opt_int(probe, "multislice_slices", "tpu.probe", 0),
            probe_multislice_pair_localization=_opt_bool(
                probe, "multislice_pair_localization", "tpu.probe", True
            ),
            probe_profile_dir=_opt_str(probe, "profile_dir", "tpu.probe", None),
            node_watch_enabled=_opt_bool(node_watch, "enabled", "tpu.node_watch", False),
            node_watch_label_selector=_opt_str(node_watch, "label_selector", "tpu.node_watch", None),
            remediation_enabled=_opt_bool(remediation, "enabled", "tpu.remediation", False),
            remediation_dry_run=_opt_bool(remediation, "dry_run", "tpu.remediation", True),
            remediation_cordon=_opt_bool(remediation, "cordon", "tpu.remediation", True),
            remediation_taint_key=_opt_str(remediation, "taint_key", "tpu.remediation", cls.remediation_taint_key),
            remediation_taint_value=_opt_str(remediation, "taint_value", "tpu.remediation", cls.remediation_taint_value),
            remediation_taint_effect=taint_effect,
            remediation_confirm_cycles=remediation_confirm,
            remediation_cooldown_seconds=remediation_cooldown,
            remediation_max_actions_per_hour=remediation_rate,
            remediation_max_quarantined_nodes=remediation_budget,
        )


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    """The ``ingest:`` section — net-new sharded watch ingest.

    ``shards`` watch streams (each its own connection + resume version,
    partitioned by a stable hash of the pod UID) feed one bounded MPSC
    queue drained in batches of up to ``batch_max`` events through
    ``EventPipeline.process_batch``. ``shards: 1`` runs the SAME queue +
    batch machinery over a single stream — there is no unsharded code
    path. Shard partition push-down rides a ``shard`` query param the
    in-repo mock apiserver (and a shard-aware proxy) honors; a stock
    apiserver ignores it and each stream drops non-owned events
    client-side, so shards > 1 against a stock apiserver multiplies
    watch-stream load by the shard count (see ARCHITECTURE.md "Sharded
    ingest").
    """

    shards: int = 1
    batch_max: int = 128
    queue_capacity: int = 8192
    # multi-process shard readers (watch/procpool.py): split the shard
    # streams across `processes` OS worker processes, each owning its
    # streams + prefilter + per-shard rv checkpoint, feeding the parent's
    # pipeline over a length-prefixed pipe wire. 0 = in-process (today's
    # behavior, the io_threads-0 legacy-reference pattern). Requires
    # checkpointing (state.checkpoint_path) — the crash-respawn resume
    # contract needs durable per-shard rv lines (AppConfig cross-check).
    processes: int = 0
    # watch-frame prefilter mode (native/scanner.py make_scanner):
    # auto (native when it builds, Python otherwise — one INFO on the
    # downgrade) | native (pinned: same fallback, WARNING) | python |
    # off (full json.loads on every frame — the reference behavior).
    # tpu.prefilter: false (legacy bool) forces off.
    prefilter: str = "auto"

    def resolved_prefilter(self, tpu_prefilter: bool = True) -> str:
        """Effective prefilter mode: the legacy ``tpu.prefilter: false``
        bool still forces ``off`` (one release of overlap)."""
        return "off" if not tpu_prefilter else self.prefilter

    @classmethod
    def from_raw(cls, raw: Mapping[str, Any]) -> "IngestConfig":
        _check_known(
            raw,
            ("shards", "batch_max", "queue_capacity", "processes", "prefilter"),
            "ingest",
        )
        shards = _opt_int(raw, "shards", "ingest", 1)
        if shards < 1:
            raise ConfigError(f"config key 'ingest.shards': must be >= 1, got {shards}")
        batch_max = _opt_int(raw, "batch_max", "ingest", 128)
        if batch_max < 1:
            raise ConfigError(f"config key 'ingest.batch_max': must be >= 1, got {batch_max}")
        queue_capacity = _opt_int(raw, "queue_capacity", "ingest", 8192)
        if queue_capacity < batch_max:
            raise ConfigError(
                f"config key 'ingest.queue_capacity': must be >= batch_max "
                f"({batch_max}), got {queue_capacity} (a queue smaller than one "
                f"batch can never fill a batch and would throttle the drain)"
            )
        processes = _opt_int(raw, "processes", "ingest", 0)
        if processes < 0:
            raise ConfigError(
                f"config key 'ingest.processes': must be >= 0 (0 = in-process), got {processes}"
            )
        if processes > shards:
            raise ConfigError(
                f"config key 'ingest.processes': must be <= ingest.shards "
                f"({shards}), got {processes} (a worker process owns >= 1 whole "
                f"shard stream; more processes than shards would idle)"
            )
        raw_prefilter = raw.get("prefilter")
        if isinstance(raw_prefilter, bool):
            # YAML 1.1 reads a bare `off`/`on` as a boolean — honor the
            # obvious intent (and the legacy tpu.prefilter bool semantics)
            # instead of rejecting the natural spelling
            prefilter = "auto" if raw_prefilter else "off"
        else:
            prefilter = _opt_str(raw, "prefilter", "ingest", "auto")
        if prefilter not in VALID_PREFILTER_MODES:
            raise ConfigError(
                f"config key 'ingest.prefilter': must be one of "
                f"{', '.join(VALID_PREFILTER_MODES)}, got {prefilter!r}"
            )
        return cls(
            shards=shards,
            batch_max=batch_max,
            queue_capacity=queue_capacity,
            processes=processes,
            prefilter=prefilter,
        )


@dataclasses.dataclass(frozen=True)
class TraceFederationConfig:
    """The ``trace.federation:`` sub-section — cross-cluster trace
    joining at a federator (trace/federation.py): upstream subscribers
    negotiate ``?trace=1`` so sampled deltas carry their journey's
    compact trace in-band; the federator joins them with the
    ``serve_wire``/``federate_merge``/``global_serve`` stages, serves the
    fleet-wide journey at ``/debug/trace?uid=`` and slowest-stage
    attribution at ``/debug/trace/diagnosis``, and emits the labeled
    ``trace_stage_seconds{stage=,upstream=}`` histograms the SLO and
    health planes consume. Requires ``trace.enabled`` AND
    ``federation.enabled`` (schema-enforced pairing).
    """

    enabled: bool = False
    # keep the upstream's forwarded local spans in the joined traces;
    # false bounds federator memory to the cross-cluster stages and the
    # stitched query fetches upstream spans lazily from the upstream's
    # serve-port /debug/trace (partial answer when it is unreachable)
    forward_spans: bool = True
    # joined journeys retained for stitched queries / diagnosis examples
    # (newest wins — the production memory bound)
    max_joined: int = 256

    @classmethod
    def from_raw(cls, raw: Mapping[str, Any]) -> "TraceFederationConfig":
        path = "trace.federation"
        _check_known(raw, ("enabled", "forward_spans", "max_joined"), path)
        max_joined = _opt_int(raw, "max_joined", path, 256)
        if max_joined < 1:
            raise ConfigError(
                f"config key '{path}.max_joined': must be >= 1 (use "
                f"{path}.enabled: false to turn trace joining off), got {max_joined}"
            )
        return cls(
            enabled=_opt_bool(raw, "enabled", path, False),
            forward_spans=_opt_bool(raw, "forward_spans", path, True),
            max_joined=max_joined,
        )


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """The ``trace:`` section — net-new end-to-end event tracing plane
    (trace/trace.py): head-sampled span trees across every hand-off an
    event crosses (shard stream -> queue -> pipeline -> lane -> connection
    borrow -> POST), with always-sample for anomalous terminals.

    ``sample_rate: N`` keeps every Nth pod event per shard stream
    (deterministic modular counter); ``0`` disables head sampling while
    anomaly capture keeps recording. Unsampled events pay only the
    sampling branch — no allocation, no lock (the <3% overhead budget the
    bench smoke gates).

    ``federation:`` extends sampled journeys across the serve/federation
    wire (see ``TraceFederationConfig``).
    """

    enabled: bool = True
    sample_rate: int = 256
    ring_size: int = 512
    federation: TraceFederationConfig = dataclasses.field(
        default_factory=TraceFederationConfig
    )

    @classmethod
    def from_raw(cls, raw: Mapping[str, Any]) -> "TraceConfig":
        _check_known(raw, ("enabled", "sample_rate", "ring_size", "federation"), "trace")
        sample_rate = _opt_int(raw, "sample_rate", "trace", 256)
        if sample_rate < 0:
            raise ConfigError(
                f"config key 'trace.sample_rate': must be >= 0 (0 = anomaly-only), got {sample_rate}"
            )
        ring_size = _opt_int(raw, "ring_size", "trace", 512)
        if ring_size < 1:
            raise ConfigError(
                f"config key 'trace.ring_size': must be >= 1 (use trace.enabled: false to turn tracing off), got {ring_size}"
            )
        federation = raw.get("federation") or {}
        _expect(federation, (dict,), "trace.federation")
        return cls(
            enabled=_opt_bool(raw, "enabled", "trace", True),
            sample_rate=sample_rate,
            ring_size=ring_size,
            federation=TraceFederationConfig.from_raw(federation),
        )


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The ``serve:`` section — net-new fleet-state serving plane
    (serve/): a kube-apiserver-style watch cache over the pipeline's
    output. ``GET /serve/fleet`` answers a ``{rv, objects}`` snapshot;
    ``?watch=1&rv=N`` streams resumable deltas from that rv, with
    latest-wins per-key compaction once a subscriber's backlog exceeds
    ``queue_depth`` and 410-Gone resync once its resume token falls
    behind ``compact_horizon`` journaled deltas. Streams ride the
    encode-once broadcast core: each delta's wire frame is serialized
    once at publish and ``io_threads`` epoll loops write the shared
    bytes to every subscriber, buffering slow clients up to
    ``sub_buffer_bytes`` before lag shedding (ARCHITECTURE.md
    "Serving plane").
    """

    enabled: bool = False
    port: int = 0  # 0 = bind an ephemeral port (tests/smoke); fixed in prod
    max_subscribers: int = 5000
    # per-subscriber backlog bound: pulls with more pending deltas than
    # this are compacted latest-wins per key before delivery
    queue_depth: int = 128
    # delta-journal length: resume tokens older than this many deltas get
    # 410 Gone and must re-snapshot (the serve-side etcd compaction)
    compact_horizon: int = 8192
    # broadcast event-loop pool size: ?watch=1 streams are handed off the
    # HTTP thread to selectors-based loops writing publish-time-encoded
    # frame bytes (one loop drives thousands of streams; more loops
    # spread send() syscall load). 0 = legacy thread-per-connection
    # streaming (one OS thread per stream — debugging/comparison only)
    io_threads: int = 1
    # per-subscriber outbound buffer budget (bytes): a slow client's
    # unsent frames queue up to this, then the loop stops pulling for it
    # and its lag resolves through read-time latest-wins compaction
    sub_buffer_bytes: int = 1 << 20
    # fleet-state core selector: "auto"/"on" = the columnar core
    # (serve/columns.py — parts + int columns, the million-object
    # representation), "off" = the legacy dict-of-dicts core (the A/B
    # reference; byte-identical wire either way)
    columnar: str = "auto"

    @classmethod
    def from_raw(cls, raw: Mapping[str, Any]) -> "ServeConfig":
        _check_known(
            raw,
            ("enabled", "port", "max_subscribers", "queue_depth", "compact_horizon",
             "io_threads", "sub_buffer_bytes", "columnar"),
            "serve",
        )
        port = _opt_int(raw, "port", "serve", 0)
        if port < 0 or port > 65535:
            raise ConfigError(f"config key 'serve.port': must be 0..65535, got {port}")
        max_subscribers = _opt_int(raw, "max_subscribers", "serve", 5000)
        if max_subscribers < 1:
            raise ConfigError(
                f"config key 'serve.max_subscribers': must be >= 1 (use serve.enabled: "
                f"false to turn the plane off), got {max_subscribers}"
            )
        queue_depth = _opt_int(raw, "queue_depth", "serve", 128)
        if queue_depth < 1:
            raise ConfigError(f"config key 'serve.queue_depth': must be >= 1, got {queue_depth}")
        compact_horizon = _opt_int(raw, "compact_horizon", "serve", 8192)
        if compact_horizon < queue_depth:
            raise ConfigError(
                f"config key 'serve.compact_horizon': must be >= queue_depth "
                f"({queue_depth}), got {compact_horizon} (a horizon shorter than one "
                f"subscriber queue would 410 subscribers before lag shedding could engage)"
            )
        io_threads = _opt_int(raw, "io_threads", "serve", 1)
        if io_threads < 0 or io_threads > 64:
            raise ConfigError(
                f"config key 'serve.io_threads': must be 0..64 (0 = legacy "
                f"thread-per-connection streaming), got {io_threads}"
            )
        sub_buffer_bytes = _opt_int(raw, "sub_buffer_bytes", "serve", 1 << 20)
        if sub_buffer_bytes < 4096:
            raise ConfigError(
                f"config key 'serve.sub_buffer_bytes': must be >= 4096 (one "
                f"outbound buffer must hold at least a frame), got {sub_buffer_bytes}"
            )
        columnar = raw.get("columnar", "auto")
        if columnar not in VALID_COLUMNAR_MODES:
            raise ConfigError(
                f"config key 'serve.columnar': must be one of "
                f"{'/'.join(VALID_COLUMNAR_MODES)} ('auto' = on; 'off' keeps the "
                f"legacy dict-of-dicts core), got {columnar!r}"
            )
        return cls(
            enabled=_opt_bool(raw, "enabled", "serve", False),
            port=port,
            max_subscribers=max_subscribers,
            queue_depth=queue_depth,
            compact_horizon=compact_horizon,
            io_threads=io_threads,
            sub_buffer_bytes=sub_buffer_bytes,
            columnar=columnar,
        )


#: accepted serve.columnar modes ("auto" resolves to the columnar core)
VALID_COLUMNAR_MODES = ("auto", "on", "off")


#: accepted history.fsync policies (mirrored by history/wal.py)
VALID_FSYNC_POLICIES = ("never", "interval", "always")


@dataclasses.dataclass(frozen=True)
class HistoryConfig:
    """The ``history:`` section — net-new durable fleet history plane
    (history/): a segmented, CRC-framed WAL under the serving plane's
    delta journal. Every FleetView delta persists; recovery rebuilds the
    view at boot (same instance id, same monotonic rv line) so resume
    tokens survive restarts; ``GET /serve/fleet?at=rv`` reconstructs
    historical snapshots; ``scripts/history_replay.py`` turns any
    capture into a deterministic regression fixture (ARCHITECTURE.md
    "History plane"). Requires ``serve.enabled`` (the WAL records the
    serving plane's deltas).
    """

    enabled: bool = False
    dir: Optional[str] = None  # required when enabled
    # durability knob: "never" (page cache only — a lost checkpoint costs
    # replayable history, not correctness), "interval" (default: one
    # fsync per fsync_interval_seconds), "always" (per write batch)
    fsync: str = "interval"
    fsync_interval_seconds: float = 1.0
    # rotation: the active segment seals once it outgrows either bound;
    # every new segment opens with a full snapshot record
    segment_max_bytes: int = 8 * 1024 * 1024
    segment_max_age_seconds: float = 3600.0
    # retention: newest N segments kept; the oldest retained segment's
    # opening snapshot is the durable horizon (410 past it)
    retain_segments: int = 8

    @classmethod
    def from_raw(cls, raw: Mapping[str, Any]) -> "HistoryConfig":
        _check_known(
            raw,
            ("enabled", "dir", "fsync", "fsync_interval_seconds",
             "segment_max_bytes", "segment_max_age_seconds", "retain_segments"),
            "history",
        )
        enabled = _opt_bool(raw, "enabled", "history", False)
        directory = _opt_str(raw, "dir", "history", None)
        if enabled and not directory:
            raise ConfigError(
                "config key 'history.dir': required when history.enabled (the WAL "
                "needs a directory to persist segments into)"
            )
        fsync = _opt_str(raw, "fsync", "history", "interval")
        if fsync not in VALID_FSYNC_POLICIES:
            raise ConfigError(
                f"config key 'history.fsync': must be one of "
                f"{', '.join(VALID_FSYNC_POLICIES)}, got {fsync!r}"
            )
        fsync_interval = _opt_num(raw, "fsync_interval_seconds", "history", 1.0)
        if fsync_interval <= 0:
            raise ConfigError(
                f"config key 'history.fsync_interval_seconds': must be > 0, got {fsync_interval}"
            )
        segment_max_bytes = _opt_int(raw, "segment_max_bytes", "history", 8 * 1024 * 1024)
        if segment_max_bytes < 4096:
            raise ConfigError(
                f"config key 'history.segment_max_bytes': must be >= 4096, got "
                f"{segment_max_bytes} (a segment smaller than its own opening "
                f"snapshot record rotates on every batch)"
            )
        segment_max_age = _opt_num(raw, "segment_max_age_seconds", "history", 3600.0)
        if segment_max_age <= 0:
            raise ConfigError(
                f"config key 'history.segment_max_age_seconds': must be > 0, got {segment_max_age}"
            )
        retain = _opt_int(raw, "retain_segments", "history", 8)
        if retain < 2:
            raise ConfigError(
                f"config key 'history.retain_segments': must be >= 2 (the active "
                f"segment plus at least one sealed anchor), got {retain}"
            )
        return cls(
            enabled=enabled,
            dir=directory,
            fsync=fsync,
            fsync_interval_seconds=fsync_interval,
            segment_max_bytes=segment_max_bytes,
            segment_max_age_seconds=segment_max_age,
            retain_segments=retain,
        )


@dataclasses.dataclass(frozen=True)
class MetricsConfig:
    """The ``metrics:`` section — observability-plane knobs.

    ``process_export``: with worker processes live (``ingest.processes``
    / ``federation.processes``), each worker ships its full registry
    sample (+ completed traces) on its periodic stats frame and the
    parent folds it under a ``process`` label — one scrape sees the
    whole fleet. Off = workers ship only the ad-hoc stats fields, for
    byte-budget-critical deploys.

    ``process_top_series``: how many hottest (by recent rate) process-
    labeled counter series ``/debug/processes`` reports per worker.
    """

    process_export: bool = True
    process_top_series: int = 5

    @classmethod
    def from_raw(cls, raw: Mapping[str, Any]) -> "MetricsConfig":
        if "legacy_suffix_names" in raw:
            raise ConfigError(
                "config key 'metrics.legacy_suffix_names': removed — the "
                "suffix-mangled series are gone; use the labeled forms "
                "(federation_upstream_lag_*{upstream=...}, "
                "serve_snapshot_cache_*{codec=...})"
            )
        _check_known(raw, ("process_export", "process_top_series"), "metrics")
        top = _opt_int(raw, "process_top_series", "metrics", 5)
        if top < 1:
            raise ConfigError(
                f"config key 'metrics.process_top_series': must be >= 1, got {top}"
            )
        return cls(
            process_export=_opt_bool(raw, "process_export", "metrics", True),
            process_top_series=top,
        )


#: accepted SLO objective kinds (slo/engine.py mirrors the semantics)
VALID_SLO_KINDS = ("quantile", "gauge", "ratio")

#: SLO objective names become Prometheus label values and /debug/slo keys
_SLO_NAME_RE = re.compile(r"^[a-zA-Z0-9_.\-]{1,64}$")


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """One declared service-level objective (``slo.objectives[]``).

    Three kinds, keyed by which spec field is present in the raw entry:

    - ``quantile`` (``histogram:`` + ``max_seconds:``): a request-based
      latency SLO — the error rate over a window is the fraction of
      observations ABOVE ``max_seconds`` (computed from cumulative
      bucket deltas, so it is exact at bucket resolution); ``quantile``
      only picks which windowed percentile /debug/slo reports.
    - ``gauge`` (``gauge:`` + ``max:``): a state SLO — the error rate is
      the fraction of ring ticks on which the gauge (max across its
      label children) exceeded ``max``.
    - ``ratio`` (``ratio_good:`` + ``ratio_total:`` + ``min_ratio:``):
      a success-ratio SLO over two counters — the error rate is
      ``1 - Δgood/Δtotal`` over the window.

    ``target`` is the compliance target; the error budget is
    ``1 - target`` and a burn rate of 1.0 means the budget is being
    spent exactly as fast as it accrues (ratio objectives budget off
    ``min_ratio`` directly).
    """

    name: str
    kind: str
    metric: str = ""  # histogram name (quantile) / gauge name (gauge)
    quantile: float = 0.99
    max_seconds: float = 0.0  # quantile threshold
    max_value: float = 0.0  # gauge threshold
    good: str = ""  # ratio numerator counter
    total: str = ""  # ratio denominator counter
    min_ratio: float = 0.999
    target: float = 0.99

    @classmethod
    def from_raw(cls, raw: Mapping[str, Any], path: str) -> "SloObjective":
        _check_known(
            raw,
            ("name", "histogram", "quantile", "max_seconds", "gauge", "max",
             "ratio_good", "ratio_total", "min_ratio", "target"),
            path,
        )
        name = _opt_str(raw, "name", path, None)
        if not name or not _SLO_NAME_RE.match(name):
            raise ConfigError(
                f"config key '{path}.name': required, 1-64 chars of [a-zA-Z0-9_.-] "
                f"(it becomes the slo_burn_rate{{objective=...}} label value), got {name!r}"
            )
        specs = [k for k in ("histogram", "gauge", "ratio_good") if raw.get(k)]
        if len(specs) != 1:
            raise ConfigError(
                f"config key '{path}': exactly one of histogram:/gauge:/ratio_good: "
                f"must be set (got {specs or 'none'})"
            )
        target = _opt_num(raw, "target", path, 0.99)
        if not 0.0 < target < 1.0:
            raise ConfigError(
                f"config key '{path}.target': must be in (0, 1) — the error budget "
                f"is 1 - target — got {target}"
            )
        if specs[0] == "histogram":
            quantile = _opt_num(raw, "quantile", path, 0.99)
            if not 0.0 < quantile <= 1.0:
                raise ConfigError(f"config key '{path}.quantile': must be in (0, 1], got {quantile}")
            max_seconds = _opt_num(raw, "max_seconds", path, 0.0)
            if max_seconds <= 0:
                raise ConfigError(
                    f"config key '{path}.max_seconds': required > 0 for a histogram objective"
                )
            return cls(name=name, kind="quantile", metric=_opt_str(raw, "histogram", path, ""),
                       quantile=quantile, max_seconds=max_seconds, target=target)
        if specs[0] == "gauge":
            if "max" not in raw or raw["max"] is None:
                raise ConfigError(f"config key '{path}.max': required for a gauge objective")
            return cls(name=name, kind="gauge", metric=_opt_str(raw, "gauge", path, ""),
                       max_value=_opt_num(raw, "max", path, 0.0), target=target)
        total = _opt_str(raw, "ratio_total", path, None)
        if not total:
            raise ConfigError(
                f"config key '{path}.ratio_total': required alongside ratio_good"
            )
        min_ratio = _opt_num(raw, "min_ratio", path, 0.999)
        if not 0.0 < min_ratio < 1.0:
            raise ConfigError(
                f"config key '{path}.min_ratio': must be in (0, 1), got {min_ratio}"
            )
        # the budget defaults to the ratio floor itself (budget =
        # 1 - min_ratio), but an EXPLICIT target: is honored — silently
        # overriding an accepted key would page at the wrong rate
        ratio_target = target if raw.get("target") is not None else min_ratio
        return cls(name=name, kind="ratio", good=_opt_str(raw, "ratio_good", path, ""),
                   total=total, min_ratio=min_ratio, target=ratio_target)


@dataclasses.dataclass(frozen=True)
class SloConfig:
    """The ``slo:`` section — net-new SLO/burn-rate engine (slo/): a
    bounded in-process timeseries ring samples every registered metric
    on a tick; config-declared objectives are evaluated with the
    standard two-window burn rate (fast + slow, both over the error
    budget ``1 - target``; breaching requires BOTH windows hot — the
    page-worthy "burning fast AND not a blip" rule). Results serve at
    ``/debug/slo``, export as ``slo_burn_rate{objective=,window=}`` /
    ``slo_breaching{objective=}``, and fold into the /healthz BODY
    (degraded, never the liveness verdict — restarting a watcher does
    not refund an error budget).
    """

    enabled: bool = False
    tick_seconds: float = 5.0
    # ring capacity in ticks; must cover the slow window
    ring_size: int = 1024
    fast_window_seconds: float = 300.0
    slow_window_seconds: float = 3600.0
    # both windows' burn rates must exceed this to breach (1.0 = budget
    # being spent exactly at the sustainable rate)
    burn_threshold: float = 1.0
    objectives: tuple = ()  # tuple[SloObjective, ...]

    @classmethod
    def from_raw(cls, raw: Mapping[str, Any]) -> "SloConfig":
        path = "slo"
        _check_known(
            raw,
            ("enabled", "tick_seconds", "ring_size", "fast_window_seconds",
             "slow_window_seconds", "burn_threshold", "objectives"),
            path,
        )
        enabled = _opt_bool(raw, "enabled", path, False)
        tick = _opt_num(raw, "tick_seconds", path, 5.0)
        if tick <= 0:
            raise ConfigError(f"config key '{path}.tick_seconds': must be > 0, got {tick}")
        fast = _opt_num(raw, "fast_window_seconds", path, 300.0)
        slow = _opt_num(raw, "slow_window_seconds", path, 3600.0)
        if not tick <= fast < slow:
            raise ConfigError(
                f"config key '{path}': need tick_seconds <= fast_window_seconds < "
                f"slow_window_seconds, got tick={tick} fast={fast} slow={slow}"
            )
        ring_size = _opt_int(raw, "ring_size", path, 1024)
        if ring_size < 2:
            raise ConfigError(f"config key '{path}.ring_size': must be >= 2, got {ring_size}")
        if ring_size * tick < slow:
            raise ConfigError(
                f"config key '{path}.ring_size': {ring_size} ticks x {tick}s does not "
                f"cover slow_window_seconds={slow} — the slow burn window would "
                f"silently evaluate over less history than it claims"
            )
        burn_threshold = _opt_num(raw, "burn_threshold", path, 1.0)
        if burn_threshold <= 0:
            raise ConfigError(
                f"config key '{path}.burn_threshold': must be > 0, got {burn_threshold}"
            )
        raw_objectives = raw.get("objectives") or ()
        _expect(raw_objectives, (list, tuple), f"{path}.objectives")
        objectives = []
        seen = set()
        for i, entry in enumerate(raw_objectives):
            entry_path = f"{path}.objectives[{i}]"
            _expect(entry, (dict,), entry_path)
            objective = SloObjective.from_raw(entry, entry_path)
            if objective.name in seen:
                raise ConfigError(
                    f"config key '{entry_path}.name': duplicate objective name "
                    f"{objective.name!r}"
                )
            seen.add(objective.name)
            objectives.append(objective)
        if enabled and not objectives:
            raise ConfigError(
                "config key 'slo.objectives': at least one objective is required "
                "when slo.enabled (an SLO engine with nothing to evaluate)"
            )
        return cls(
            enabled=enabled,
            tick_seconds=tick,
            ring_size=ring_size,
            fast_window_seconds=fast,
            slow_window_seconds=slow,
            burn_threshold=burn_threshold,
            objectives=tuple(objectives),
        )


#: signal sources the health detector may fuse (health.sources.*)
VALID_HEALTH_SOURCES = ("probe", "phase", "freshness", "trace")


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """The ``health:`` section — net-new straggler & node-health detection
    plane (health/): fuses signals the platform already produces — probe
    RTTs + suspect-link findings, per-upstream freshness watermarks, pod
    phase-transition latencies from the fleet view, trace stage outliers —
    into per-node / per-slice / per-upstream verdicts using PEER-RELATIVE
    outlier scoring (a node is a straggler relative to its slice peers,
    never against an absolute threshold). Verdicts walk a config-declared
    escalation state machine (healthy -> suspect -> confirmed ->
    remediating) with confirm-cycle hysteresis and clean-cycle decay;
    confirmed NODE verdicts feed the existing budgeted (dry-run by
    default) remediation actuator. Full detail at ``GET /debug/health``;
    ``node_health_score{node=}`` / ``health_state{node=,state=}`` labeled
    gauges; the verdict folds into the /healthz BODY (degraded, never
    liveness). See ARCHITECTURE.md "Health & remediation plane".
    """

    enabled: bool = False
    tick_seconds: float = 5.0
    # peer-relative robust z-score (deviation from the peer median in
    # MAD units) at which a subject turns suspicious
    suspect_z: float = 4.0
    # consecutive suspicious ticks before suspect escalates to confirmed
    # (one clean tick resets — mirrors remediate/policy.py)
    confirm_cycles: int = 3
    # consecutive CLEAN ticks before a confirmed/remediating subject
    # de-escalates back to healthy (absence of signal is NOT clean)
    decay_cycles: int = 2
    # which signal planes the detector reads (each requires its plane)
    source_probe: bool = True
    source_phase: bool = True
    source_freshness: bool = False
    source_trace: bool = True

    @classmethod
    def from_raw(cls, raw: Mapping[str, Any]) -> "HealthConfig":
        path = "health"
        _check_known(
            raw,
            ("enabled", "tick_seconds", "suspect_z", "confirm_cycles",
             "decay_cycles", "sources"),
            path,
        )
        enabled = _opt_bool(raw, "enabled", path, False)
        tick = _opt_num(raw, "tick_seconds", path, 5.0)
        if tick <= 0:
            raise ConfigError(f"config key '{path}.tick_seconds': must be > 0, got {tick}")
        suspect_z = _opt_num(raw, "suspect_z", path, 4.0)
        if suspect_z <= 0:
            raise ConfigError(
                f"config key '{path}.suspect_z': must be > 0, got {suspect_z} "
                f"(a non-positive threshold would call every subject a straggler)"
            )
        confirm = _opt_int(raw, "confirm_cycles", path, 3)
        if confirm < 1:
            raise ConfigError(f"config key '{path}.confirm_cycles': must be >= 1, got {confirm}")
        decay = _opt_int(raw, "decay_cycles", path, 2)
        if decay < 1:
            raise ConfigError(f"config key '{path}.decay_cycles': must be >= 1, got {decay}")
        sources = raw.get("sources") or {}
        _expect(sources, (dict,), f"{path}.sources")
        _check_known(sources, VALID_HEALTH_SOURCES, f"{path}.sources")
        cfg = cls(
            enabled=enabled,
            tick_seconds=tick,
            suspect_z=suspect_z,
            confirm_cycles=confirm,
            decay_cycles=decay,
            source_probe=_opt_bool(sources, "probe", f"{path}.sources", True),
            source_phase=_opt_bool(sources, "phase", f"{path}.sources", True),
            source_freshness=_opt_bool(sources, "freshness", f"{path}.sources", False),
            source_trace=_opt_bool(sources, "trace", f"{path}.sources", True),
        )
        if enabled and not (
            cfg.source_probe or cfg.source_phase or cfg.source_freshness or cfg.source_trace
        ):
            raise ConfigError(
                "config key 'health.sources': at least one source must be enabled "
                "when health.enabled (a detector with nothing to fuse)"
            )
        return cfg


#: accepted analytics.backend values: the JAX package's vocabulary, so both
#: packages load the same files (in the port ``auto`` and ``jax`` both mean
#: torch on the rank's device)
VALID_ANALYTICS_BACKENDS = ("auto", "jax", "numpy")


@dataclasses.dataclass(frozen=True)
class AnalyticsConfig:
    """The ``analytics:`` section — the fleet analytics and what-if engine
    (``analytics/``): the FleetView encoded into dense integer columns and
    batched placement what-ifs at ``GET /serve/analytics``. Requires
    ``serve.enabled`` (the columns are the serving plane's view).
    """

    enabled: bool = False
    # auto | jax: torch on the rank's device; numpy: the host
    backend: str = "auto"
    # per-request scenario cap for /serve/analytics?scenarios= (400 past
    # it) — one request's mask matrix is [scenarios x workers]
    max_scenarios: int = 16
    # run the vectorized-vs-incremental slice-aggregate cross-check on
    # every request (cheap: one extra segment-sum) and surface failures
    # via analytics_crosscheck_failures + the response body
    crosscheck: bool = True

    @classmethod
    def from_raw(cls, raw: Mapping[str, Any]) -> "AnalyticsConfig":
        path = "analytics"
        _check_known(raw, ("enabled", "backend", "max_scenarios", "crosscheck"), path)
        backend = _opt_str(raw, "backend", path, "auto")
        if backend not in VALID_ANALYTICS_BACKENDS:
            raise ConfigError(
                f"config key '{path}.backend': must be one of "
                f"{', '.join(VALID_ANALYTICS_BACKENDS)}, got {backend!r}"
            )
        max_scenarios = _opt_int(raw, "max_scenarios", path, 16)
        if max_scenarios < 1:
            raise ConfigError(
                f"config key '{path}.max_scenarios': must be >= 1, got {max_scenarios}"
            )
        return cls(
            enabled=_opt_bool(raw, "enabled", path, False),
            backend=backend,
            max_scenarios=max_scenarios,
            crosscheck=_opt_bool(raw, "crosscheck", path, True),
        )


def metric_safe_name(name: str) -> str:
    """Cluster/upstream name -> metric-name- and filename-safe form
    (Prometheus charset). The ONE sanitizer the federation plane uses for
    per-upstream gauge suffixes and resume-token filenames — the schema
    validates uniqueness against exactly this mapping, so two upstreams
    can never alias one gauge or one token file."""
    return re.sub(r"[^0-9a-zA-Z_]", "_", name)


#: serve wire codec preferences a federation subscriber may be pinned to
#: (mirrors federate/client.py: "auto" offers msgpack + JSON fallback)
VALID_SERVE_CODECS = ("auto", "json", "msgpack")


@dataclasses.dataclass(frozen=True)
class FederationUpstream:
    """One upstream serving plane the federation tier subscribes to."""

    url: str
    name: str
    token: Optional[str] = None  # upstream bearer (watcher.status_auth_token there)


@dataclasses.dataclass(frozen=True)
class FederationConfig:
    """The ``federation:`` section — net-new multi-cluster fan-in plane
    (federate/): one resume-protocol subscriber per upstream serving
    plane (e.g. the watchers of several GKE clusters / v5p pod-slices),
    merged into the LOCAL FleetView under ``(kind, "<cluster>/<key>")``
    keys so the existing serve/history planes republish the global fleet
    (encode-once fan-out, restart-surviving resume tokens, ?at= time
    travel — all on the merged view). Requires ``serve.enabled``.
    See ARCHITECTURE.md "Federation plane".
    """

    enabled: bool = False
    upstreams: tuple = ()  # tuple[FederationUpstream, ...]
    # an upstream with no frame (delta or SYNC heartbeat) for this long is
    # stale: /healthz degrades, and drop_stale decides its objects' fate
    stale_after_seconds: float = 10.0
    # reconnect/resync backoff base (jittered, exponential to ~30 s)
    resync_backoff_seconds: float = 1.0
    # True: a dark upstream's objects are DELETED from the global view
    # (consumers see only live state; recovery re-snapshots them back).
    # False (default): keep last-known state, surface staleness via
    # /healthz + federation_upstream_stale — zero rv churn on a blip.
    drop_stale: bool = False
    # serve wire codec preference for the upstream subscribers: "auto"
    # (default) offers msgpack and falls back transparently to JSON when
    # the peer or the local import lacks it (the downgrade is logged
    # once per upstream); "msgpack" is the same offer with a WARNING
    # posture; "json" never offers msgpack (debugging / byte-stable
    # wire captures). The codec changes wire bytes only — decoded
    # frames are identical.
    codec: str = "auto"
    # merge-worker OS processes for the fan-in (0 = today's in-process
    # path, byte for byte). > 0 shards upstreams across supervised
    # worker processes by hash(cluster): each worker consumes its
    # upstreams' frames and ships prepared view batches to the parent
    # sequencer over the length-prefixed msgpack pipe — the ingest
    # tier's processes knob, applied to the fan-in (ARCHITECTURE.md
    # "Sharded fan-in"). More processes than upstreams waste nothing
    # (surplus workers own zero clusters and exit idle-cheap).
    processes: int = 0

    @classmethod
    def from_raw(cls, raw: Mapping[str, Any]) -> "FederationConfig":
        path = "federation"
        _check_known(
            raw,
            ("enabled", "upstreams", "stale_after_seconds",
             "resync_backoff_seconds", "drop_stale", "codec", "processes"),
            path,
        )
        enabled = _opt_bool(raw, "enabled", path, False)
        raw_upstreams = raw.get("upstreams") or ()
        _expect(raw_upstreams, (list, tuple), f"{path}.upstreams")
        upstreams = []
        seen_names = set()
        for i, entry in enumerate(raw_upstreams):
            entry_path = f"{path}.upstreams[{i}]"
            _expect(entry, (dict,), entry_path)
            _check_known(entry, ("name", "url", "token"), entry_path)
            url = _opt_str(entry, "url", entry_path, None)
            if not url:
                raise ConfigError(f"config key '{entry_path}.url': required (the upstream serving plane's base URL)")
            name = _opt_str(entry, "name", entry_path, None)
            if not name:
                # stable default: the URL's host:port (metric/key-safe
                # sanitization happens at the metrics layer)
                from urllib.parse import urlsplit

                parts = urlsplit(url if "//" in url else f"http://{url}")
                name = parts.netloc or f"upstream{i}"
            if "/" in name:
                # "/" separates the cluster prefix in merged keys
                # ("<cluster>/<key>"): a name containing it would make
                # split_global_key misattribute the cluster, and two
                # names like "us" and "us/east" could mint the SAME
                # global key from different upstreams
                raise ConfigError(
                    f"config key '{entry_path}.name': {name!r} must not contain '/' "
                    f"(it is the cluster/key separator in merged global keys)"
                )
            if name in seen_names:
                raise ConfigError(
                    f"config key '{entry_path}.name': duplicate upstream name {name!r} "
                    f"(names key the merged view's cluster prefix — they must be unique)"
                )
            seen_names.add(name)
            # distinct raw names can still collapse to one sanitized form
            # ("us-east.1" and "us-east_1" -> "us_east_1"), which would
            # alias their lag/stale gauges AND their resume-token files
            # (each restart resuming with the OTHER cluster's token)
            sanitized = metric_safe_name(name)
            if sanitized in (metric_safe_name(n) for n in seen_names - {name}):
                raise ConfigError(
                    f"config key '{entry_path}.name': {name!r} collides with another "
                    f"upstream after metric/filename sanitization (both become "
                    f"{sanitized!r}); pick names that differ in [a-zA-Z0-9_]"
                )
            upstreams.append(FederationUpstream(
                url=url, name=name, token=_opt_str(entry, "token", entry_path, None) or None,
            ))
        if enabled and not upstreams:
            raise ConfigError(
                "config key 'federation.upstreams': at least one upstream is required "
                "when federation.enabled (a federator with nothing to federate)"
            )
        stale_after = _opt_num(raw, "stale_after_seconds", path, 10.0)
        if stale_after <= 0:
            raise ConfigError(
                f"config key '{path}.stale_after_seconds': must be > 0, got {stale_after}"
            )
        backoff = _opt_num(raw, "resync_backoff_seconds", path, 1.0)
        if backoff <= 0:
            raise ConfigError(
                f"config key '{path}.resync_backoff_seconds': must be > 0, got {backoff}"
            )
        codec = _opt_str(raw, "codec", path, "auto")
        if codec not in VALID_SERVE_CODECS:
            raise ConfigError(
                f"config key '{path}.codec': must be one of "
                f"{', '.join(VALID_SERVE_CODECS)}, got {codec!r}"
            )
        processes = _opt_int(raw, "processes", path, 0)
        if processes < 0 or processes > 64:
            raise ConfigError(
                f"config key '{path}.processes': must be in [0, 64], got {processes}"
            )
        return cls(
            enabled=enabled,
            upstreams=tuple(upstreams),
            stale_after_seconds=stale_after,
            resync_backoff_seconds=backoff,
            drop_stale=_opt_bool(raw, "drop_stale", path, False),
            codec=codec,
            processes=processes,
        )


@dataclasses.dataclass(frozen=True)
class RelayConfig:
    """The ``relay:`` section — net-new relay/edge fan-out tier
    (relay/): this serve node's FleetView mirrors ONE upstream serving
    plane over the raw-bytes passthrough (same view instance id, same
    rv line, the upstream's wire frames re-broadcast VERBATIM — zero
    re-encode), forming a depth-stamped fan-out tree that carries 100k+
    streaming subscribers off one publisher. Requires ``serve.enabled``;
    mutually exclusive with ``federation.enabled`` and
    ``history.enabled`` (both would mint/persist rvs against a foreign
    rv line). See ARCHITECTURE.md "Relay tier".
    """

    enabled: bool = False
    upstream: Optional[FederationUpstream] = None  # required when enabled
    # tree-depth bound, counted from the root (a root serve plane is
    # depth 0, its relays are depth 1, ...). The loop-breaker: a
    # mis-wired relay cycle re-discovers a growing depth every reconnect
    # and self-quarantines at the limit instead of circulating frames.
    depth_limit: int = 2
    # upstream wire codec preference (mirrors federation.codec): the
    # passthrough stores whatever shape actually rides the wire; local
    # subscribers on other shapes pay the usual lazy once-per-delta fill
    codec: str = "auto"
    # negotiate ?fresh=1 upstream (default on: depth-stamped per-hop
    # freshness reads the ts field, and stamped frames pass through to
    # leaves so tier-N consumers measure true end-to-end age)
    fresh: bool = True
    # negotiate ?trace=1 upstream (trace implies fresh on the wire):
    # sampled journeys' in-band trace dicts pass through verbatim
    trace: bool = False
    # journal warm-up on (re)connect: subscribe this many rvs BELOW the
    # snapshot (floored by the upstream's retention) so resume tokens
    # minted before a relay restart keep resuming gapless against the
    # new process. 0 disables (tokens older than the restart re-snapshot)
    backfill: int = 4096
    # an upstream with no frame (delta or SYNC) for this long is stale:
    # the relay reconnects and its health body degrades
    stale_after_seconds: float = 10.0
    # reconnect/resync backoff base (jittered, exponential)
    resync_backoff_seconds: float = 1.0
    # how long app startup waits for the first upstream adopt before
    # serving anyway (degraded): bounded availability-over-strictness
    sync_timeout_seconds: float = 15.0

    @classmethod
    def from_raw(cls, raw: Mapping[str, Any]) -> "RelayConfig":
        path = "relay"
        _check_known(
            raw,
            ("enabled", "upstream", "depth_limit", "codec", "fresh", "trace",
             "backfill", "stale_after_seconds", "resync_backoff_seconds",
             "sync_timeout_seconds"),
            path,
        )
        enabled = _opt_bool(raw, "enabled", path, False)
        upstream = None
        raw_upstream = raw.get("upstream")
        if raw_upstream is not None:
            entry_path = f"{path}.upstream"
            _expect(raw_upstream, (dict,), entry_path)
            _check_known(raw_upstream, ("name", "url", "token"), entry_path)
            url = _opt_str(raw_upstream, "url", entry_path, None)
            if not url:
                raise ConfigError(
                    f"config key '{entry_path}.url': required (the upstream "
                    f"serving plane this relay mirrors)"
                )
            name = _opt_str(raw_upstream, "name", entry_path, None)
            if not name:
                from urllib.parse import urlsplit

                parts = urlsplit(url if "//" in url else f"http://{url}")
                name = parts.netloc or "upstream"
            upstream = FederationUpstream(
                url=url, name=name,
                token=_opt_str(raw_upstream, "token", entry_path, None) or None,
            )
        if enabled and upstream is None:
            raise ConfigError(
                "config key 'relay.upstream': required when relay.enabled "
                "(a relay with nothing to relay)"
            )
        depth_limit = _opt_int(raw, "depth_limit", path, 2)
        if depth_limit < 1:
            raise ConfigError(
                f"config key '{path}.depth_limit': must be >= 1 (a relay is "
                f"at least depth 1), got {depth_limit}"
            )
        codec = _opt_str(raw, "codec", path, "auto")
        if codec not in VALID_SERVE_CODECS:
            raise ConfigError(
                f"config key '{path}.codec': must be one of "
                f"{', '.join(VALID_SERVE_CODECS)}, got {codec!r}"
            )
        backfill = _opt_int(raw, "backfill", path, 4096)
        if backfill < 0:
            raise ConfigError(
                f"config key '{path}.backfill': must be >= 0 (0 disables the "
                f"journal warm-up), got {backfill}"
            )
        stale_after = _opt_num(raw, "stale_after_seconds", path, 10.0)
        if stale_after <= 0:
            raise ConfigError(
                f"config key '{path}.stale_after_seconds': must be > 0, got {stale_after}"
            )
        backoff = _opt_num(raw, "resync_backoff_seconds", path, 1.0)
        if backoff <= 0:
            raise ConfigError(
                f"config key '{path}.resync_backoff_seconds': must be > 0, got {backoff}"
            )
        sync_timeout = _opt_num(raw, "sync_timeout_seconds", path, 15.0)
        if sync_timeout < 0:
            raise ConfigError(
                f"config key '{path}.sync_timeout_seconds': must be >= 0, got {sync_timeout}"
            )
        return cls(
            enabled=enabled,
            upstream=upstream,
            depth_limit=depth_limit,
            codec=codec,
            fresh=_opt_bool(raw, "fresh", path, True),
            trace=_opt_bool(raw, "trace", path, False),
            backfill=backfill,
            stale_after_seconds=stale_after,
            resync_backoff_seconds=backoff,
            sync_timeout_seconds=sync_timeout,
        )


@dataclasses.dataclass(frozen=True)
class StateConfig:
    """The ``state:`` section — net-new checkpoint/resume (SURVEY.md §5).

    The reference lost all state on restart (no resourceVersion passed at
    pod_watcher.py:264); we persist the last-seen resourceVersion and the
    slice-state cache so a restart neither drops nor duplicates notifications.
    """

    checkpoint_path: Optional[str] = None
    checkpoint_interval_seconds: float = 5.0

    @classmethod
    def from_raw(cls, raw: Mapping[str, Any]) -> "StateConfig":
        _check_known(raw, ("checkpoint_path", "checkpoint_interval_seconds"), "state")
        return cls(
            checkpoint_path=_opt_str(raw, "checkpoint_path", "state", None),
            checkpoint_interval_seconds=_opt_num(raw, "checkpoint_interval_seconds", "state", 5.0),
        )


@dataclasses.dataclass(frozen=True)
class AppConfig:
    """Fully-validated application config (one per process)."""

    environment: str
    watcher: WatcherConfig
    clusterapi: ClusterApiConfig
    kubernetes: KubernetesConfig
    tpu: TpuConfig
    state: StateConfig
    ingest: IngestConfig = dataclasses.field(default_factory=IngestConfig)
    trace: TraceConfig = dataclasses.field(default_factory=TraceConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    history: HistoryConfig = dataclasses.field(default_factory=HistoryConfig)
    federation: FederationConfig = dataclasses.field(default_factory=FederationConfig)
    relay: RelayConfig = dataclasses.field(default_factory=RelayConfig)
    metrics: MetricsConfig = dataclasses.field(default_factory=MetricsConfig)
    slo: SloConfig = dataclasses.field(default_factory=SloConfig)
    health: HealthConfig = dataclasses.field(default_factory=HealthConfig)
    analytics: AnalyticsConfig = dataclasses.field(default_factory=AnalyticsConfig)

    TOP_LEVEL_KEYS = ("environment", "watcher", "clusterapi", "kubernetes", "tpu", "state", "ingest", "trace", "serve", "history", "federation", "relay", "metrics", "slo", "health", "analytics")

    @classmethod
    def from_raw(cls, raw: Mapping[str, Any], environment: str) -> "AppConfig":
        _check_known(raw, cls.TOP_LEVEL_KEYS, "<root>")
        for section in ("watcher", "clusterapi", "kubernetes", "tpu", "state", "ingest", "trace", "serve", "history", "federation", "relay", "metrics", "slo", "health", "analytics"):
            _expect(raw.get(section) or {}, (dict,), section)
        # The reference's development.yaml declared `environment: local` while
        # the CLI only accepted development|staging|production, leaving the
        # "local" branch unreachable (SURVEY.md §2 defect #5). Here the
        # declared name is advisory only; the CLI name wins and both are kept.
        declared = raw.get("environment")
        if declared is not None:
            _expect(declared, (str,), "environment")
        serve = ServeConfig.from_raw(raw.get("serve") or {})
        history = HistoryConfig.from_raw(raw.get("history") or {})
        if history.enabled and not serve.enabled:
            raise ConfigError(
                "config key 'history.enabled': requires serve.enabled (the WAL "
                "persists the serving plane's FleetView deltas; without the "
                "serving plane there is nothing to record)"
            )
        federation = FederationConfig.from_raw(raw.get("federation") or {})
        if federation.enabled and not serve.enabled:
            raise ConfigError(
                "config key 'federation.enabled': requires serve.enabled (the "
                "merged global view republishes through the serving plane's "
                "FleetView; without it the fan-in has nowhere to land)"
            )
        relay = RelayConfig.from_raw(raw.get("relay") or {})
        if relay.enabled:
            if not serve.enabled:
                raise ConfigError(
                    "config key 'relay.enabled': requires serve.enabled (a relay "
                    "IS a serve node — the mirrored view re-broadcasts through "
                    "the serving plane's fan-out core)"
                )
            if federation.enabled:
                raise ConfigError(
                    "config key 'relay.enabled': conflicts with "
                    "federation.enabled — federation MINTS local rvs into the "
                    "view while a relay MIRRORS its upstream's rv line verbatim; "
                    "one view cannot serve both rv spaces. Run them as separate "
                    "processes (relay in front of a federator works fine)."
                )
            if history.enabled:
                raise ConfigError(
                    "config key 'relay.enabled': conflicts with history.enabled "
                    "— a relay is a stateless edge on its UPSTREAM's rv line; "
                    "durability (and the restart-surviving token story) belongs "
                    "to the root that owns the line. Relay restarts re-warm "
                    "their journal via relay.backfill instead."
                )
        trace = TraceConfig.from_raw(raw.get("trace") or {})
        if trace.federation.enabled:
            # schema-enforced pairing (same posture as health.sources.*):
            # a silently plane-less joined-trace config would look like
            # "no cross-cluster traces" instead of a wiring mistake
            if not trace.enabled:
                raise ConfigError(
                    "config key 'trace.federation.enabled': requires trace.enabled "
                    "(joined journeys land in the tracing plane's ring and ride "
                    "its sampled deltas)"
                )
            if not federation.enabled:
                raise ConfigError(
                    "config key 'trace.federation.enabled': requires "
                    "federation.enabled (trace joining happens on the federation "
                    "fan-in path; without upstreams there is nothing to join)"
                )
            if federation.processes > 0:
                raise ConfigError(
                    "config key 'trace.federation.enabled': requires "
                    "federation.processes: 0 (the joined-trace collector rides "
                    "the in-process fan-in thread; sharded merge workers "
                    "negotiate trace off and would silently join nothing)"
                )
        analytics = AnalyticsConfig.from_raw(raw.get("analytics") or {})
        if analytics.enabled and not serve.enabled:
            raise ConfigError(
                "config key 'analytics.enabled': requires serve.enabled (the "
                "columnar encoder's source of truth is the serving plane's "
                "FleetView, and /serve/analytics rides its HTTP surface)"
            )
        ingest = IngestConfig.from_raw(raw.get("ingest") or {})
        state = StateConfig.from_raw(raw.get("state") or {})
        kubernetes = KubernetesConfig.from_raw(raw.get("kubernetes") or {})
        if ingest.processes > 0:
            if not state.checkpoint_path:
                raise ConfigError(
                    "config key 'ingest.processes': requires checkpointing "
                    "(state.checkpoint_path) — each shard-reader process resumes "
                    "its watch from a durable per-shard resourceVersion after a "
                    "crash/respawn; without it every worker death replays or "
                    "relists the whole shard"
                )
            if kubernetes.use_mock:
                raise ConfigError(
                    "config key 'ingest.processes': conflicts with "
                    "kubernetes.use_mock — the in-process fake pod lifecycle "
                    "cannot cross process boundaries; point the workers at a "
                    "real (or mock-apiserver) URL instead"
                )
        health = HealthConfig.from_raw(raw.get("health") or {})
        if health.enabled:
            # each enabled source must have the plane it reads — a silently
            # signal-less source would look like "everything healthy"
            if health.source_phase and not serve.enabled:
                raise ConfigError(
                    "config key 'health.sources.phase': requires serve.enabled "
                    "(phase-transition latencies are read from the FleetView)"
                )
            if health.source_freshness and not federation.enabled:
                raise ConfigError(
                    "config key 'health.sources.freshness': requires "
                    "federation.enabled (per-upstream watermarks are the "
                    "federation plane's telemetry)"
                )
            if health.source_trace and not trace.enabled:
                raise ConfigError(
                    "config key 'health.sources.trace': requires trace.enabled "
                    "(stage outliers are read from the tracing plane's histograms)"
                )
        return cls(
            environment=environment,
            watcher=WatcherConfig.from_raw(raw.get("watcher") or {}),
            clusterapi=ClusterApiConfig.from_raw(raw.get("clusterapi") or {}),
            kubernetes=kubernetes,
            tpu=TpuConfig.from_raw(raw.get("tpu") or {}),
            state=state,
            ingest=ingest,
            trace=trace,
            serve=serve,
            history=history,
            federation=federation,
            relay=relay,
            metrics=MetricsConfig.from_raw(raw.get("metrics") or {}),
            slo=SloConfig.from_raw(raw.get("slo") or {}),
            health=health,
            analytics=analytics,
        )


@dataclasses.dataclass(frozen=True)
class AgentConfig:
    """What the agent's loop reads: the ``tpu`` settings, the notifier's
    ``clusterapi``, remediation's ``kubernetes`` and ``watcher.log_level``."""

    tpu: TpuConfig = dataclasses.field(default_factory=TpuConfig)
    clusterapi: ClusterApiConfig = dataclasses.field(default_factory=ClusterApiConfig)
    kubernetes: KubernetesConfig = dataclasses.field(default_factory=KubernetesConfig)
    log_level: str = "INFO"


def resolve_environment(argv: Optional[Sequence[str]] = None, env: Optional[Mapping[str, str]] = None) -> str:
    """CLI argument, else ``ENVIRONMENT``, else ``development``; validated."""
    env = os.environ if env is None else env
    name = env.get("ENVIRONMENT", DEFAULT_ENVIRONMENT)
    if argv:
        name = argv[0]
    if name not in SUPPORTED_ENVIRONMENTS:
        raise ConfigError(
            f"Unsupported environment '{name}'. Supported environments: {list(SUPPORTED_ENVIRONMENTS)}"
        )
    return name


def load_yaml_file(path: os.PathLike | str) -> Dict[str, Any]:
    """One YAML file; missing -> {} with a warning; malformed -> ConfigError."""
    path = Path(path)
    try:
        with open(path, "r") as fh:
            data = yaml.safe_load(fh)
    except FileNotFoundError:
        logger.warning("Config file %s not found", path)
        return {}
    except yaml.YAMLError as exc:
        raise ConfigError(f"Error loading config {path}: {exc}") from exc
    if data is None:
        return {}
    if not isinstance(data, dict):
        raise ConfigError(f"Config {path} must be a mapping, got {type(data).__name__}")
    return data


def deep_merge(base: Mapping[str, Any], override: Mapping[str, Any]) -> Dict[str, Any]:
    """Recursive merge; override wins."""
    result: Dict[str, Any] = dict(base)
    for key, value in override.items():
        if key in result and isinstance(result[key], Mapping) and isinstance(value, Mapping):
            result[key] = deep_merge(result[key], value)
        else:
            result[key] = value
    return result


def substitute_env_vars(obj: Any, env: Optional[Mapping[str, str]] = None) -> Any:
    """Replace whole-string ``${VAR}`` / ``${VAR:-default}`` tokens (unset, no default -> "")."""
    env = os.environ if env is None else env
    if isinstance(obj, Mapping):
        return {k: substitute_env_vars(v, env) for k, v in obj.items()}
    if isinstance(obj, list):
        return [substitute_env_vars(v, env) for v in obj]
    if isinstance(obj, str) and obj.startswith("${") and obj.endswith("}"):
        token = obj[2:-1]
        default = ""
        if ":-" in token:
            token, default = token.split(":-", 1)
        return env.get(token, default)
    return obj


def load_raw_config(
    environment: str, config_dir: os.PathLike | str = "config", env: Optional[Mapping[str, str]] = None
) -> Dict[str, Any]:
    """base.yaml + <environment>.yaml merge + env substitution, unvalidated."""
    config_dir = Path(config_dir)
    merged = deep_merge(
        load_yaml_file(config_dir / "base.yaml"), load_yaml_file(config_dir / f"{environment}.yaml")
    )
    return substitute_env_vars(merged, env)


def load_app_config(
    environment: str, config_dir: os.PathLike | str = "config", env: Optional[Mapping[str, str]] = None
) -> AppConfig:
    """Load, merge, substitute and validate the whole config for ``environment``."""
    return AppConfig.from_raw(load_raw_config(environment, config_dir, env), environment)


def load_config(
    environment: str, config_dir: os.PathLike | str = "config", env: Optional[Mapping[str, str]] = None
) -> TpuConfig:
    """The validated ``tpu`` section of ``environment``."""
    return TpuConfig.from_raw(_section(load_raw_config(environment, config_dir, env), "tpu"))


def _section(raw: Mapping[str, Any], key: str) -> Dict[str, Any]:
    return _expect(raw.get(key) or {}, (dict,), key)


def load_agent_config(
    environment: str, config_dir: os.PathLike | str = "config", env: Optional[Mapping[str, str]] = None
) -> AgentConfig:
    """The validated settings the agent's loop reads for ``environment``."""
    raw = load_raw_config(environment, config_dir, env)
    return AgentConfig(
        tpu=TpuConfig.from_raw(_section(raw, "tpu")),
        clusterapi=ClusterApiConfig.from_raw(_section(raw, "clusterapi")),
        kubernetes=KubernetesConfig.from_raw(_section(raw, "kubernetes")),
        log_level=WatcherConfig.from_raw(_section(raw, "watcher")).log_level,
    )
