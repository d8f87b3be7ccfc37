"""A configuration file's deployment, as the port loads it.

``configs/<config>.json`` names the shipped environment (``config/<env>.yaml``
over ``config/base.yaml``, loaded by the port's ``load_raw_config``), the
environment variables it is loaded with, and the overrides merged over it: the
settings a deployment sets (apiserver and sink URLs, ports) and those listed
in ``reduced``. In both, a value ``$free_port`` is a free local port, and
``$kubeconfig``, ``$sink_url`` and ``$status_token`` are the run's own. The
merged settings are written to the run's directory and loaded from there by
the port's own ``load_agent_config``.
"""

from __future__ import annotations

import json
import os
import socket

from portbench.harness import ROOT

STATUS_TOKEN = "portbench-status-token"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fill(obj, values: dict):
    if isinstance(obj, dict):
        return {k: _fill(v, values) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_fill(v, values) for v in obj]
    if obj == "$free_port":
        return free_port()
    if isinstance(obj, str) and obj.startswith("$"):
        head, _, tail = obj[1:].partition("/")
        if head in values:
            return str(values[head]) + (f"/{tail}" if tail else "")
    return obj


def agent_config(config: dict, workdir: str, api_port: int, sink_port: int, overlay: dict = None):
    """The agent's settings: the shipped files with the deployment's
    environment and overrides (and ``overlay``, a run's own) merged over
    them, as ``load_agent_config`` validates them."""
    from k8s_watcher_tpu_torch.config import deep_merge, load_agent_config, load_raw_config

    kubeconfig = os.path.join(workdir, "kubeconfig")
    with open(kubeconfig, "w") as fh:
        json.dump({
            "apiVersion": "v1", "kind": "Config", "current-context": "stub",
            "clusters": [{"name": "stub", "cluster": {"server": f"http://127.0.0.1:{api_port}"}}],
            "contexts": [{"name": "stub", "context": {"cluster": "stub", "user": "stub"}}],
            "users": [{"name": "stub", "user": {"token": "stub-token"}}],
        }, fh)
    values = {"kubeconfig": kubeconfig, "sink_url": f"http://127.0.0.1:{sink_port}", "status_token": STATUS_TOKEN}
    env = _fill(config["env"], values)
    raw = load_raw_config(config["environment"], os.path.join(ROOT, "config"), env=env)
    raw = deep_merge(raw, _fill(config["overrides"], values))
    if overlay:
        raw = deep_merge(raw, overlay)
    merged = os.path.join(workdir, "config")
    os.makedirs(merged, exist_ok=True)
    for name, body in (("base.yaml", {}), (f"{config['environment']}.yaml", raw)):
        with open(os.path.join(merged, name), "w") as fh:
            json.dump(body, fh)  # JSON is YAML
    return load_agent_config(config["environment"], merged, env=env)
