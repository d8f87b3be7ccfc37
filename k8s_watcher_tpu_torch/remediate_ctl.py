"""Operator CLI for the remediation plane (the JAX package's
``scripts/remediate_ctl.py``; the jax-free release path of a node that the
port quarantined).

Usage:
    python -m k8s_watcher_tpu_torch.remediate_ctl [environment] status
    python -m k8s_watcher_tpu_torch.remediate_ctl [environment] quarantine NODE [--reason=TEXT] [--no-dry-run]
    python -m k8s_watcher_tpu_torch.remediate_ctl [environment] release NODE [--no-dry-run]
    python -m k8s_watcher_tpu_torch.remediate_ctl [environment] health [--url=http://host:port] [--token=TOKEN]
    python -m k8s_watcher_tpu_torch.remediate_ctl [environment] health release NODE [--no-dry-run]

``status`` lists nodes carrying the configured remediation taint and/or a
cordon. ``quarantine``/``release`` drive the same NodeActuator the watcher
and the probe agent use, with the same config-derived taint — dry-run
unless ``--no-dry-run`` is given explicitly (CLI actions are subject to the
same review discipline as automated ones). Manual actions bypass
confirm_cycles by design: the operator IS the confirmation.

``health`` reads the detection plane's live scores/states from the
watcher's ``GET /debug/health`` (the status port from config, or
``--url``). ``health release NODE`` is the operator path out of a
health-plane quarantine: it drives the SAME actuator release
(uncordon + remove our taint) — dry-run unless ``--no-dry-run`` — after
which the detector's clean-cycle decay returns the node to ``healthy`` on
its own once signals look normal.

The settings come from ``config/`` relative to the working directory. Exit
codes: 0 done, 1 a failed action or an unreachable watcher (an apiserver
error propagates, which also exits 1), 2 a usage error.
"""

from __future__ import annotations

import json
import sys
from typing import Optional, Sequence

from k8s_watcher_tpu_torch.config import load_app_config, resolve_environment
from k8s_watcher_tpu_torch.k8s.client import K8sClient
from k8s_watcher_tpu_torch.k8s.kubeconfig import load_connection
from k8s_watcher_tpu_torch.logging_setup import setup_logging
from k8s_watcher_tpu_torch.remediate import build_actuator


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = [a for a in argv if a.startswith("--")]
    args = [a for a in argv if not a.startswith("--")]
    known_envs = ("development", "staging", "production")
    env_args = args[:1] if args and args[0] in known_envs else []
    rest = args[len(env_args):]
    if not rest or rest[0] not in ("status", "quarantine", "release", "health"):
        print(__doc__)
        return 2
    command, *rest = rest

    environment = resolve_environment(env_args)
    config = load_app_config(environment)
    setup_logging(environment, config.watcher.log_level)

    if command == "health" and (not rest or rest[0] != "release"):
        # read-only: scores/states over HTTP from the running watcher
        import urllib.request

        url = None
        token = config.watcher.status_auth_token
        for flag in flags:
            if flag.startswith("--url="):
                url = flag[len("--url="):].rstrip("/")
            elif flag.startswith("--token="):
                token = flag[len("--token="):]
        if url is None:
            if not config.watcher.status_port:
                print(
                    "health: no watcher.status_port in this environment's config; "
                    "pass --url=http://host:port", file=sys.stderr,
                )
                return 2
            url = f"http://127.0.0.1:{config.watcher.status_port}"
        request = urllib.request.Request(f"{url}/debug/health")
        if token:
            request.add_header("Authorization", f"Bearer {token}")
        try:
            with urllib.request.urlopen(request, timeout=10) as resp:
                body = json.loads(resp.read())
        except Exception as exc:  # noqa: BLE001 — operator CLI: report, don't trace
            print(f"health: GET {url}/debug/health failed: {exc}", file=sys.stderr)
            return 1
        print(json.dumps(body, indent=2))
        return 0

    if command == "health":  # health release NODE -> the actuator path
        command, rest = "release", rest[1:]
        if not rest:
            print("health release: NODE argument required", file=sys.stderr)
            return 2

    connection = load_connection(
        use_incluster=config.kubernetes.use_incluster_config,
        config_file=config.kubernetes.config_file,
        verify_tls=config.kubernetes.verify_tls,
    )
    client = K8sClient(connection, request_timeout=config.kubernetes.request_timeout)
    t = config.tpu

    if command == "status":
        nodes = client.list_nodes().get("items", [])
        out = []
        for node in nodes:
            name = (node.get("metadata") or {}).get("name", "")
            spec = node.get("spec") or {}
            taints = [x for x in spec.get("taints") or [] if x.get("key") == t.remediation_taint_key]
            if taints or spec.get("unschedulable"):
                out.append({
                    "node": name,
                    "unschedulable": bool(spec.get("unschedulable")),
                    "remediation_taints": taints,
                })
        print(json.dumps({"taint_key": t.remediation_taint_key, "quarantined": out}, indent=2))
        return 0

    if not rest:
        print(f"{command}: NODE argument required", file=sys.stderr)
        return 2
    node = rest[0]
    reason = "manual CLI action"
    for flag in flags:
        if flag.startswith("--reason="):
            reason = flag[len("--reason="):]
    actuator = build_actuator(
        client,
        t,
        dry_run="--no-dry-run" not in flags,
        # one-shot invocation: no budget to seed, skip the node LIST
        adopt=False,
        # the operator is the rate limiter for manual actions
        cooldown_seconds=0.0,
        max_actions_per_hour=1000,
        max_quarantined_nodes=10_000,
    )
    record = actuator.quarantine(node, reason) if command == "quarantine" else actuator.release(node, reason)
    print(json.dumps(record.to_dict(), indent=2))
    return 0 if record.ok else 1


if __name__ == "__main__":
    sys.exit(main())
