"""The port's configuration held against the JAX package's.

Every ``config/*.yaml`` environment, with and without environment
substitution, must load to the same ``dataclasses.asdict`` through both
loaders, and each malformed config must fail in both with the same message.
``tests/test_config.py`` is replayed with the port's loader in place of the
reference's (``load_app_config`` is the port's ``load_config``).
"""

import dataclasses

import numpy as np
import pytest

from conftest import CONFIG_DIR
from k8s_watcher_tpu.config.loader import ConfigError as RefConfigError
from k8s_watcher_tpu.config.loader import load_config as ref_load_config
from k8s_watcher_tpu_torch.config import ConfigError, load_agent_config, load_app_config
from test_torch_replay import replay, replayed_tests

ENVIRONMENTS = ("development", "staging", "production")


def _env_values(seed):
    """Values for every variable the shipped configs substitute."""
    rng = np.random.default_rng(seed)
    token = "".join(rng.choice(list("abcdefXYZ0123456789"), size=12))
    return {
        "CLUSTERAPI_API_KEY": f"dev-{token}",
        "PROD_CLUSTERAPI_API_KEY": f"prod-{token}",
        "STAGING_CLUSTERAPI_API_KEY": f"stg-{token}",
        "CLUSTERAPI_BASE_URL": f"https://clusterapi-{int(rng.integers(1000))}.example.com/base",
        "WATCHER_STATUS_TOKEN": token,
        "WATCHER_LOG_LEVEL": str(rng.choice(["DEBUG", "INFO", "WARNING"])),
    }


@pytest.mark.parametrize("environment", ENVIRONMENTS)
@pytest.mark.parametrize("env", [None, "empty", 0, 1])
def test_every_environment_loads_alike(environment, env, monkeypatch):
    if env is None:
        values = None  # the process environment
        for k, v in _env_values(7).items():
            monkeypatch.setenv(k, v)
    else:
        values = {} if env == "empty" else _env_values(env)
    want = ref_load_config(environment, CONFIG_DIR, env=values)
    got = load_app_config(environment, CONFIG_DIR, env=values)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    agent = load_agent_config(environment, CONFIG_DIR, env=values)
    assert (agent.tpu, agent.clusterapi, agent.kubernetes, agent.log_level) == (
        got.tpu, got.clusterapi, got.kubernetes, got.watcher.log_level)


BAD_CONFIGS = [
    "watcherr:\n  log_level: INFO\n",
    "watcher:\n  watch_intervall: 2\n",
    "watcher:\n  log_level: CHATTY\n",
    "watcher:\n  namespaces: default\n",
    "watcher:\n  list_page_size: 0\n",
    "watcher:\n  leader_election:\n    enabled: true\n    lease_duration_seconds: 5\n    renew_deadline_seconds: 6\n",
    "clusterapi:\n  timeout: fast\n",
    "clusterapi:\n  workers: -1\n",
    "clusterapi:\n  egress_stall_seconds: 0\n",
    "clusterapi:\n  endpoints:\n    pod_updates: /x\n",
    "kubernetes:\n  use_mock: maybe\n",
    "tpu:\n  backend: fpga\n",
    "tpu:\n  probe:\n    trend_drop_factor: 1.5\n",
    "tpu:\n  remediation:\n    taint_effect: EvictEverything\n",
    "tpu:\n  remediation:\n    cooldown_seconds: -10\n",
    "ingest:\n  shards: 0\n",
    "ingest:\n  batch_max: 256\n  queue_capacity: 128\n",
    "ingest:\n  shards: 2\n  processes: 2\n",
    "ingest:\n  shards: 2\n  processes: 3\n",
    "ingest:\n  prefilter: turbo\n",
    "history:\n  enabled: true\n",
    "federation:\n  enabled: true\n",
    "serve:\n  enabled: true\nrelay:\n  enabled: true\n  upstream: http://up:1\nfederation:\n  enabled: true\n"
    "  upstreams:\n    - url: http://a:1\n",
    "trace:\n  federation:\n    enabled: true\n",
    "trace:\n  sample_rate: -1\n",
    "analytics:\n  enabled: true\n",
    "analytics:\n  backend: torch\n",
    "health:\n  enabled: true\n  sources:\n    phase: true\n",
    "slo:\n  enabled: true\n  objectives:\n    - name: a\n      quantile: 0.99\n",
    "state:\n  checkpoint_interval_seconds: soon\n",
    "[1, 2]\n",
    "watcher: {\n",
]


@pytest.mark.parametrize("base", BAD_CONFIGS)
def test_bad_configs_fail_alike(tmp_path, base):
    (tmp_path / "base.yaml").write_text(base)
    with pytest.raises(RefConfigError) as want:
        ref_load_config("development", tmp_path, env={})
    with pytest.raises(ConfigError) as got:
        load_app_config("development", tmp_path, env={})
    assert str(got.value) == str(want.value)


_replayed = replay(
    "test_config.py",
    rewrites=[
        ("from k8s_watcher_tpu.config.loader import (", "from k8s_watcher_tpu_torch.config import ("),
        ("    load_config,\n", "    load_app_config as load_config,\n"),
    ],
)
globals().update(replayed_tests(_replayed))
