"""The ``tpu.probe`` settings, loaded from the repo's ``config/*.yaml``.

Same field names, defaults and validation as the JAX package's ``TpuConfig``
for the probe keys, and the same loading: ``config/base.yaml``, then
``config/<environment>.yaml`` merged over it (the overlay wins), then
whole-string ``${VAR}`` / ``${VAR:-default}`` tokens replaced from the
environment. Only ``tpu.probe`` is read here; its unknown keys are rejected.
The rest of the file belongs to planes the port does not carry yet.
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


class ConfigError(ValueError):
    """An unreadable or malformed config file, or a value that fails validation."""


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
class TpuConfig:
    """The probe fields of the JAX package's ``TpuConfig``, same names and defaults."""

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

    @classmethod
    def from_raw(cls, raw: Mapping[str, Any]) -> "TpuConfig":
        """Build from the ``tpu:`` mapping; only its ``probe`` section is read."""
        probe = raw.get("probe") or {}
        _expect(probe, (dict,), "tpu.probe")
        unknown = sorted(set(probe) - set(PROBE_KEYS))
        if unknown:
            raise ConfigError(
                f"unknown config key(s) under 'tpu.probe': {', '.join(unknown)} "
                f"(known: {', '.join(sorted(PROBE_KEYS))})"
            )
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
        )


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
    tpu = raw.get("tpu") or {}
    _expect(tpu, (dict,), "tpu")
    return TpuConfig.from_raw(tpu)
