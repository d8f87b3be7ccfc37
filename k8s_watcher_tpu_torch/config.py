"""The probe agent's settings, loaded from the repo's ``config/*.yaml``.

Same field names, defaults and validation as the JAX package's schema for
the keys read here, and the same loading: ``config/base.yaml``, then
``config/<environment>.yaml`` merged over it (the overlay wins), then
whole-string ``${VAR}`` / ``${VAR:-default}`` tokens replaced from the
environment.

- :func:`load_config` gives the ``tpu`` section (``TpuConfig``: the
  ``tpu.probe`` and ``tpu.remediation`` keys);
- :func:`load_agent_config` gives what the agent's loop reads besides:
  ``clusterapi`` (the notifier), ``kubernetes`` (remediation's apiserver
  connection) and ``watcher.log_level``.

Unknown keys under the sections read are rejected. The rest of the file
belongs to planes the port does not carry yet.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Sequence

import yaml

logger = logging.getLogger(__name__)

SUPPORTED_ENVIRONMENTS = ("development", "staging", "production")
DEFAULT_ENVIRONMENT = "development"

PROBE_KEYS = (
    "enabled", "interval_seconds", "status_port", "status_auth_token", "payload_bytes",
    "rtt_warn_ms", "matmul_size", "matmul_inner_iters", "hbm_bytes", "hbm_write_enabled",
    "expected_chips_per_host", "links_enabled", "link_rtt_factor", "link_rtt_floor_ms",
    "multislice_enabled", "multislice_slices", "multislice_pair_localization",
    "profile_dir", "trend_enabled", "trend_window", "trend_recent", "trend_drop_factor",
    "trend_rise_factor", "trend_min_history",
)


REMEDIATION_KEYS = (
    "enabled", "dry_run", "cordon", "taint_key", "taint_value", "taint_effect",
    "confirm_cycles", "cooldown_seconds", "max_actions_per_hour", "max_quarantined_nodes",
)

# the accepted taint effects: the config is validated against them, and so is
# remediate.NodeActuator's argument
VALID_TAINT_EFFECTS = ("NoSchedule", "PreferNoSchedule", "NoExecute")
LOG_LEVELS = ("DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL")


class ConfigError(ValueError):
    """An unreadable or malformed config file, or a value that fails validation."""


def _check_known(raw: Mapping[str, Any], known: Sequence[str], path: str) -> None:
    unknown = sorted(set(raw) - set(known))
    if unknown:
        raise ConfigError(
            f"unknown config key(s) under '{path}': {', '.join(unknown)} (known: {', '.join(sorted(known))})"
        )


def _expect(value: Any, types: tuple, path: str) -> Any:
    if not isinstance(value, types):
        wanted = "/".join(t.__name__ for t in types)
        raise ConfigError(f"config key '{path}': expected {wanted}, got {type(value).__name__} ({value!r})")
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
    if isinstance(v, str):
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
    if isinstance(v, str):
        low = v.strip().lower()
        if low in ("true", "1", "yes", "on"):
            return True
        if low in ("false", "0", "no", "off", ""):
            return False
        raise ConfigError(f"config key '{path}.{key}': not a boolean: {v!r}")
    return _expect(v, (bool,), f"{path}.{key}")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry with exponential backoff (the JAX package's ``RetryPolicy``)."""

    max_attempts: int = 3
    delay_seconds: float = 5.0
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


@dataclasses.dataclass(frozen=True)
class TpuConfig:
    """The probe and remediation fields of the JAX package's ``TpuConfig``,
    same names and defaults."""

    probe_enabled: bool = False
    probe_interval_seconds: float = 30.0
    probe_status_port: int = 0
    probe_status_auth_token: Optional[str] = None
    probe_payload_bytes: int = 4 * 1024 * 1024
    probe_rtt_warn_ms: float = 50.0
    probe_matmul_size: int = 1024
    probe_matmul_inner_iters: int = 8
    probe_hbm_bytes: int = 256 * 1024 * 1024  # 0 disables the HBM sweeps
    probe_hbm_write_enabled: bool = True
    expected_chips_per_host: int = 0  # 0 = don't enforce
    probe_links_enabled: bool = False
    probe_link_rtt_factor: float = 3.0
    probe_link_rtt_floor_ms: float = 0.05
    probe_trend_enabled: bool = True
    probe_trend_window: int = 16
    probe_trend_recent: int = 3
    probe_trend_drop_factor: float = 0.75
    probe_trend_rise_factor: float = 2.5
    probe_trend_min_history: int = 6
    probe_multislice_enabled: bool = False
    probe_multislice_slices: int = 0
    probe_multislice_pair_localization: bool = True
    probe_profile_dir: Optional[str] = None
    # quarantine (cordon + taint) the nodes a probe implicates across
    # confirm_cycles consecutive cycles; dry_run stays the default
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
        """Build from the ``tpu:`` mapping; its ``probe`` and ``remediation``
        sections are read."""
        remediation = raw.get("remediation") or {}
        _expect(remediation, (dict,), "tpu.remediation")
        _check_known(remediation, REMEDIATION_KEYS, "tpu.remediation")
        r = "tpu.remediation"
        taint_effect = _opt_str(remediation, "taint_effect", r, "NoSchedule")
        if taint_effect not in VALID_TAINT_EFFECTS:
            raise ConfigError(
                f"config key 'tpu.remediation.taint_effect': must be one of "
                f"{', '.join(VALID_TAINT_EFFECTS)}, got {taint_effect!r}"
            )
        remediation_confirm = _opt_int(remediation, "confirm_cycles", r, 3)
        if remediation_confirm < 1:
            raise ConfigError("config key 'tpu.remediation.confirm_cycles': must be >= 1")
        remediation_budget = _opt_int(remediation, "max_quarantined_nodes", r, 2)
        if remediation_budget < 1:
            raise ConfigError("config key 'tpu.remediation.max_quarantined_nodes': must be >= 1")
        remediation_rate = _opt_int(remediation, "max_actions_per_hour", r, 4)
        if remediation_rate < 1:
            raise ConfigError("config key 'tpu.remediation.max_actions_per_hour': must be >= 1")
        remediation_cooldown = _opt_num(remediation, "cooldown_seconds", r, 3600.0)
        if remediation_cooldown < 0:
            raise ConfigError(
                "config key 'tpu.remediation.cooldown_seconds': must be >= 0 "
                "(a negative value would silently disable the cooldown fence)"
            )
        probe = raw.get("probe") or {}
        _expect(probe, (dict,), "tpu.probe")
        _check_known(probe, PROBE_KEYS, "tpu.probe")
        p = "tpu.probe"
        trend_window = _opt_int(probe, "trend_window", p, 16)
        trend_recent = _opt_int(probe, "trend_recent", p, 3)
        trend_min_history = _opt_int(probe, "trend_min_history", p, 6)
        trend_drop = _opt_num(probe, "trend_drop_factor", p, 0.75)
        trend_rise = _opt_num(probe, "trend_rise_factor", p, 2.5)
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
            probe_enabled=_opt_bool(probe, "enabled", p, False),
            probe_interval_seconds=_opt_num(probe, "interval_seconds", p, 30.0),
            probe_status_port=_opt_int(probe, "status_port", p, 0),
            probe_status_auth_token=_opt_str(probe, "status_auth_token", p, None) or None,
            probe_payload_bytes=_opt_int(probe, "payload_bytes", p, 4 * 1024 * 1024),
            probe_rtt_warn_ms=_opt_num(probe, "rtt_warn_ms", p, 50.0),
            probe_matmul_size=_opt_int(probe, "matmul_size", p, 1024),
            probe_matmul_inner_iters=_opt_int(probe, "matmul_inner_iters", p, 8),
            probe_hbm_bytes=_opt_int(probe, "hbm_bytes", p, 256 * 1024 * 1024),
            probe_hbm_write_enabled=_opt_bool(probe, "hbm_write_enabled", p, True),
            expected_chips_per_host=_opt_int(probe, "expected_chips_per_host", p, 0),
            probe_links_enabled=_opt_bool(probe, "links_enabled", p, False),
            probe_link_rtt_factor=_opt_num(probe, "link_rtt_factor", p, 3.0),
            probe_link_rtt_floor_ms=_opt_num(probe, "link_rtt_floor_ms", p, 0.05),
            probe_trend_enabled=_opt_bool(probe, "trend_enabled", p, True),
            probe_trend_window=trend_window,
            probe_trend_recent=trend_recent,
            probe_trend_drop_factor=trend_drop,
            probe_trend_rise_factor=trend_rise,
            probe_trend_min_history=trend_min_history,
            probe_multislice_enabled=_opt_bool(probe, "multislice_enabled", p, False),
            probe_multislice_slices=_opt_int(probe, "multislice_slices", p, 0),
            probe_multislice_pair_localization=_opt_bool(probe, "multislice_pair_localization", p, True),
            probe_profile_dir=_opt_str(probe, "profile_dir", p, None),
            remediation_enabled=_opt_bool(remediation, "enabled", r, False),
            remediation_dry_run=_opt_bool(remediation, "dry_run", r, True),
            remediation_cordon=_opt_bool(remediation, "cordon", r, True),
            remediation_taint_key=_opt_str(remediation, "taint_key", r, cls.remediation_taint_key),
            remediation_taint_value=_opt_str(remediation, "taint_value", r, cls.remediation_taint_value),
            remediation_taint_effect=taint_effect,
            remediation_confirm_cycles=remediation_confirm,
            remediation_cooldown_seconds=remediation_cooldown,
            remediation_max_actions_per_hour=remediation_rate,
            remediation_max_quarantined_nodes=remediation_budget,
        )


@dataclasses.dataclass(frozen=True)
class ClusterApiConfig:
    """The ``clusterapi:`` section: where the notifier POSTs, and its egress
    knobs (the JAX package's ``ClusterApiConfig``)."""

    base_url: str = "http://localhost:3000"
    api_key: Optional[str] = None
    pod_update_endpoint: str = "/api/pods/update"
    pod_update_batch_endpoint: str = "/api/pods/update_batch"
    health_endpoint: str = "/health"
    timeout: float = 30.0
    retry: RetryPolicy = dataclasses.field(default_factory=lambda: RetryPolicy(delay_seconds=2.0))
    queue_capacity: int = 1024
    # egress worker (= lane) count; 0 = auto, max(2, 2 x ingest shards)
    workers: int = 0
    # latest-wins per object while queued, from a lane depth of coalesce_watermark
    coalesce: bool = True
    coalesce_watermark: int = 0
    # pooled keep-alive connections to the notify target; 0 = match workers
    pool_size: int = 0
    batch_max: int = 0
    egress_stall_seconds: float = 120.0
    verify_tls: bool = True

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
        for key in ("workers", "coalesce_watermark", "pool_size", "batch_max"):
            if _opt_int(raw, key, "clusterapi", 0) < 0:
                raise ConfigError(f"config key 'clusterapi.{key}': must be >= 0")
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
        """The egress worker/lane count: explicit, or max(2, 2 x shards)."""
        return self.workers or max(2, 2 * max(1, ingest_shards))

    def resolved_pool_size(self, ingest_shards: int = 1) -> int:
        """Connection-pool size: explicit, or one connection per egress worker."""
        return self.pool_size or self.resolved_workers(ingest_shards)


@dataclasses.dataclass(frozen=True)
class KubernetesConfig:
    """The ``kubernetes:`` section: how to reach the apiserver."""

    use_incluster_config: bool = False
    config_file: Optional[str] = None
    use_mock: bool = False
    request_timeout: float = 30.0
    watch_timeout_seconds: int = 300
    verify_tls: bool = True

    @classmethod
    def from_raw(cls, raw: Mapping[str, Any]) -> "KubernetesConfig":
        _check_known(
            raw,
            ("use_incluster_config", "config_file", "use_mock", "request_timeout", "watch_timeout_seconds",
             "verify_tls"),
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


def load_config(
    environment: str, config_dir: os.PathLike | str = "config", env: Optional[Mapping[str, str]] = None
) -> TpuConfig:
    """The validated ``tpu.probe`` settings of ``environment``."""
    raw = load_raw_config(environment, config_dir, env)
    return _tpu_config(raw)


def _section(raw: Mapping[str, Any], key: str) -> Dict[str, Any]:
    section = raw.get(key) or {}
    return _expect(section, (dict,), key)


def _tpu_config(raw: Mapping[str, Any]) -> TpuConfig:
    return TpuConfig.from_raw(_section(raw, "tpu"))


def load_agent_config(
    environment: str, config_dir: os.PathLike | str = "config", env: Optional[Mapping[str, str]] = None
) -> AgentConfig:
    """The validated settings the agent's loop reads for ``environment``."""
    raw = load_raw_config(environment, config_dir, env)
    level = _expect(_section(raw, "watcher").get("log_level", "INFO"), (str,), "watcher.log_level").upper()
    if level not in LOG_LEVELS:
        raise ConfigError(f"config key 'watcher.log_level': invalid level {level!r}")
    return AgentConfig(
        tpu=_tpu_config(raw),
        clusterapi=ClusterApiConfig.from_raw(_section(raw, "clusterapi")),
        kubernetes=KubernetesConfig.from_raw(_section(raw, "kubernetes")),
        log_level=level,
    )
