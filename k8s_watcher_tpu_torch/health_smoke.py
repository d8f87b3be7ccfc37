"""Health-plane chaos drill: the three ROADMAP straggler scenarios end to
end over real processes-shaped apps (the port's twin of ``make health-smoke``).

Boots THREE mock-backed upstream ``WatcherApp``s (clusters a/b/c, each
its own mock apiserver + serve plane) and ONE federator ``WatcherApp``
(federation over all three, ``health.enabled`` on a fast tick, and the
dry-run remediation actuator armed against the federator's own mock
apiserver). Cluster a carries a 4-worker TPU slice with per-node
placement; cluster b churns a scripted fleet through
``faults.injection.ChurnGenerator``; cluster c is a small steady churner.
Then the drill injects exactly one fault per scenario and gates that
EXACTLY the guilty subject escalates to ``confirmed``:

1. **degraded ICI link** — synthetic probe reports (the shape
   ``remediate/policy.py`` parses) put two measured-suspect links on one
   node's device; after ``confirm_cycles`` reports the node is
   confirmed, the DRY-RUN actuator logs the quarantine intent, its slice
   peers stay healthy, and clean reports decay the verdict;
2. **slow-but-alive host** — one node's pods take seconds to leave
   Pending while its three slice peers start fast; the federator's
   phase-latency scan confirms exactly that node (second dry-run
   quarantine intent); removing the delay de-escalates it;
3. **lagging apiserver** — cluster c's mock apiserver keeps mutating
   state but its WATCH delivery is held (``MockCluster.hold_watch``):
   the upstream stays connected and heartbeating (never "stale" — the
   slow-but-not-dead case staleness detection cannot see) while its
   freshness watermark ages against its churning peers; the UPSTREAM is
   confirmed, no node is implicated, /healthz stays 200 with the body's
   ``health.healthy`` false; releasing the hold recovers it.

Throughout, every poll asserts no innocent subject is ever CONFIRMED
(zero collateral verdicts).

The port's twin of the JAX package's ``scripts/health_smoke.py``, with the
same stages and named checks; every app's analytics run on ``--device``
(default ``cuda:0``, raising without CUDA; ``cpu`` for tests):

    python -m k8s_watcher_tpu_torch.health_smoke [--device cpu] [--out F]

Artifact: ``artifacts/health_smoke_gpu.json`` (``--out``).
Exit 0 on PASS. The detector's tick-cost budget is bench-smoke's
``bench_health``; this script gates the verdicts over real wire, real
apps, real fault injection.
"""

from __future__ import annotations

import dataclasses
import datetime
import sys
import threading
import time
from pathlib import Path
from typing import List, Optional

from k8s_watcher_tpu_torch.app import WatcherApp
from k8s_watcher_tpu_torch.config import (
    FederationUpstream,
    HealthConfig,
    SloConfig,
    load_app_config,
)
from k8s_watcher_tpu_torch.faults.injection import ChurnGenerator
from k8s_watcher_tpu_torch.health.synthetic import synthetic_link_report
from k8s_watcher_tpu_torch.k8s.mock_server import MockApiServer
from k8s_watcher_tpu_torch.smoke_common import (
    REPO,
    checks_line,
    free_port,
    http_get,
    smoke_args,
    write_artifact,
    write_kubeconfig,
)
from k8s_watcher_tpu_torch.watch.fake import build_node, build_pod
from k8s_watcher_tpu_torch.watch.source import EventType

TOKEN = "health-smoke-token"
AUTH = {"Authorization": f"Bearer {TOKEN}"}
DEADLINE_S = 90.0
TICK_S = 0.5
CONFIRM_CYCLES = 3
DECAY_CYCLES = 3

SLICE_NODES = [f"node-a{i}" for i in range(4)]
SLOW_NODE = "node-a2"
ICI_NODE = "node-a1"
LAG_UPSTREAM = "cluster-c"

#: the named checks the artifact carries (the JAX package's drill's own)
CHECKS = (
    "federation_connected",
    "baseline_subjects_observed",
    "baseline_all_healthy",
    "ici_guilty_confirmed",
    "ici_peers_stay_healthy",
    "ici_reason_names_link_probe",
    "ici_dry_run_quarantine_logged",
    "ici_decays_on_clean_reports",
    "slow_host_confirmed",
    "slow_host_peers_stay_healthy",
    "slow_host_dry_run_quarantine_logged",
    "slow_host_signal_is_phase_latency",
    "healthz_degraded_body_never_liveness",
    "labeled_health_metrics_render",
    "slow_host_deescalates",
    "lagging_upstream_confirmed",
    "lagging_upstream_peers_stay_healthy",
    "lagging_upstream_no_node_implicated",
    "lagging_upstream_never_stale",
    "lagging_upstream_recovers",
    "final_all_healthy",
    "zero_collateral_verdicts",
)


def _kubeconfig(tmp: Path, name: str, server_url: str) -> str:
    return write_kubeconfig(tmp / f"kubeconfig-{name}.json", server_url)


def _upstream_config(tmp: Path, name: str, server_url: str, serve_port: int):
    config = load_app_config("development", str(REPO / "config"), env={})
    return dataclasses.replace(
        config,
        kubernetes=dataclasses.replace(
            config.kubernetes, use_mock=False,
            config_file=_kubeconfig(tmp, name, server_url),
            watch_timeout_seconds=5,
        ),
        clusterapi=dataclasses.replace(config.clusterapi, base_url=server_url),
        watcher=dataclasses.replace(config.watcher, status_auth_token=TOKEN),
        serve=dataclasses.replace(config.serve, enabled=True, port=serve_port),
        health=HealthConfig(),  # the federator owns the detection leg
        slo=SloConfig(),
    )


def _federator_config(tmp: Path, upstreams, own_server_url: str, status_port: int):
    """The fleet brain: federates all three clusters, health plane on a
    fast tick, dry-run actuator against its own mock apiserver (which
    holds the fleet's node objects)."""
    config = load_app_config("development", str(REPO / "config"), env={})
    return dataclasses.replace(
        config,
        kubernetes=dataclasses.replace(
            config.kubernetes, use_mock=False,
            config_file=_kubeconfig(tmp, "federator", own_server_url),
            watch_timeout_seconds=5,
        ),
        clusterapi=dataclasses.replace(config.clusterapi, base_url=own_server_url),
        watcher=dataclasses.replace(
            config.watcher, status_port=status_port, status_auth_token=TOKEN,
        ),
        serve=dataclasses.replace(config.serve, enabled=True, port=0),
        federation=dataclasses.replace(
            config.federation,
            enabled=True,
            upstreams=tuple(upstreams),
            # generous: the held upstream keeps heartbeating (connected,
            # never "stale") — scenario 3 is exactly the case the
            # staleness machinery cannot see
            stale_after_seconds=30.0,
            resync_backoff_seconds=0.2,
        ),
        health=HealthConfig(
            enabled=True,
            tick_seconds=TICK_S,
            suspect_z=4.0,
            confirm_cycles=CONFIRM_CYCLES,
            decay_cycles=DECAY_CYCLES,
            source_probe=True,
            source_phase=True,
            source_freshness=True,
            source_trace=False,  # unit-tested; fewer moving parts here
        ),
        tpu=dataclasses.replace(
            config.tpu,
            remediation_enabled=True,
            remediation_dry_run=True,
            remediation_max_quarantined_nodes=4,
            remediation_max_actions_per_hour=16,
        ),
        slo=SloConfig(),
    )


def _start_app(device, config):
    app = WatcherApp(config, device=device)
    thread = threading.Thread(target=app.run, daemon=True)
    thread.start()
    return app, thread


# -- churn drivers ---------------------------------------------------------


def _slice_a_churn(cluster, stop: threading.Event, slow: dict) -> None:
    """Cluster a's slice churn: each worker runs its OWN Pending->Running
    cycle (Pending ~0.3 s, Running dwell 1.2 s — longer than the health
    tick, so the detector's view scan reliably sees the Running state
    between spells and per-spell ages never merge). While ``slow["node"]``
    is set, that node's worker stays Pending ``slow["delay"]`` seconds per
    cycle — the slow-but-alive host — and the OTHER workers keep churning
    throughout (a paused cluster would age its own freshness watermark,
    which is scenario 3's signal, not this one's)."""
    now = time.monotonic()
    states = {i: ["Running", now] for i in range(4)}
    while not stop.is_set():
        now = time.monotonic()
        slow_node = slow.get("node")
        slow_index = SLICE_NODES.index(slow_node) if slow_node else None
        for i in range(4):
            phase, since = states[i]
            pending_hold = slow.get("delay", 6.0) if i == slow_index else 0.3
            if phase == "Running" and now - since >= 1.2:
                cluster.set_phase("default", f"slice0-worker-{i}", "Pending")
                states[i] = ["Pending", now]
            elif phase == "Pending" and now - since >= pending_hold:
                cluster.set_phase("default", f"slice0-worker-{i}", "Running")
                states[i] = ["Running", now]
        if stop.wait(0.1):
            return


def _cluster_b_churn(cluster, stop: threading.Event) -> None:
    """Cluster b: a scripted fleet through faults.injection.ChurnGenerator
    (create/ready/preempt/fail/delete), node-stamped placement, with the
    drill acting as a prompt scheduler (Pending bounded ~0.3 s) and a
    gentle event rate so no b node ever looks Pending-stuck (the guilty
    subjects are scripted elsewhere — b exists to prove the detector
    keeps quiet under realistic background churn)."""
    gen = ChurnGenerator(
        n_slices=2, workers_per_slice=4, seed=3,
        preempt_prob=0.03, fail_prob=0.01,
        node_namer=lambda s, w: f"node-b{s}-{w}",
    )
    pending_since: dict = {}
    while not stop.is_set():
        for event in gen.events(2):
            meta = (event.pod or {}).get("metadata") or {}
            key = (meta.get("namespace", "default"), meta.get("name", ""))
            if event.type == EventType.DELETED:
                cluster.delete_pod(*key)
                pending_since.pop(key, None)
            else:
                if event.type == EventType.ADDED:
                    cluster.add_pod(event.pod)
                else:
                    cluster.modify_pod(event.pod)
                phase = ((event.pod or {}).get("status") or {}).get("phase")
                if phase == "Pending":
                    pending_since.setdefault(key, time.monotonic())
                else:
                    pending_since.pop(key, None)
        now = time.monotonic()
        for key, since in list(pending_since.items()):
            if now - since > 0.3:
                cluster.set_phase(key[0], key[1], "Running")
                del pending_since[key]
        if stop.wait(0.3):
            return


def _cluster_c_churn(cluster, stop: threading.Event) -> None:
    phases = ("Running", "Pending")
    r = 0
    while not stop.is_set():
        for i in range(3):
            cluster.set_phase("default", f"c-pod-{i}", phases[r % 2])
        r += 1
        if stop.wait(0.15):
            return


def run_smoke(device) -> dict:  # noqa: PLR0915 — a drill is a script
    import tempfile

    result: dict = {
        "timestamp_utc": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "checks": {},
    }
    checks = result["checks"]
    collateral: list = []

    with tempfile.TemporaryDirectory(prefix="health-smoke-") as tmp_str, \
            MockApiServer() as server_a, MockApiServer() as server_b, \
            MockApiServer() as server_c, MockApiServer() as server_f:
        tmp = Path(tmp_str)

        # cluster a: one 4-worker TPU slice with per-node placement
        for i, node in enumerate(SLICE_NODES):
            server_a.cluster.add_pod(build_pod(
                f"slice0-worker-{i}", "default", uid=f"a-uid-{i}",
                phase="Pending", node_name=node,
                tpu_chips=4, tpu_topology="1x1x16",
                tpu_accelerator="tpu-v5p-slice",
                gke_slice_fields={
                    "jobset.sigs.k8s.io/jobset-name": "train-0",
                    "batch.kubernetes.io/job-name": "train-0-job",
                    "batch.kubernetes.io/job-completion-index": i,
                },
                container_statuses=[{"name": "main", "ready": False, "restartCount": 0}],
            ))
        # cluster c: small steady churn fleet
        for i in range(3):
            server_c.cluster.add_pod(build_pod(
                f"c-pod-{i}", "default", uid=f"c-uid-{i}", phase="Pending",
                tpu_chips=4,
            ))
        # the federator's own apiserver holds the fleet's NODE objects —
        # the dry-run actuator GETs them before logging its intent
        for node in SLICE_NODES + [f"node-b{s}-{w}" for s in range(2) for w in range(4)]:
            server_f.cluster.add_node(build_node(node))

        ports = {name: free_port() for name in ("a", "b", "c")}
        status_port = free_port()
        apps = []
        stop_churn = threading.Event()
        slow: dict = {}
        threads = []
        try:
            for name, server in (("a", server_a), ("b", server_b), ("c", server_c)):
                app, thread = _start_app(device, 
                    _upstream_config(tmp, name, server.url, ports[name])
                )
                apps.append((app, thread))
            federator, fed_thread = _start_app(device, _federator_config(
                tmp,
                [FederationUpstream(
                    url=f"http://127.0.0.1:{ports[n]}",
                    name=f"cluster-{n}", token=TOKEN,
                ) for n in ("a", "b", "c")],
                server_f.url,
                status_port,
            ))
            apps.append((federator, fed_thread))

            def get(path, **kw):
                return http_get(
                    f"http://127.0.0.1:{status_port}{path}",
                    headers=AUTH, timeout=5, **kw,
                )

            def health_body():
                return get("/debug/health").json()["health"]

            def subjects():
                return health_body()["subjects"]

            def confirmed_set(body=None):
                body = body or health_body()
                return {
                    key for key, s in body["subjects"].items()
                    if s["state"] in ("confirmed", "remediating")
                }

            def wait_for(predicate, *, guilty=frozenset(), timeout=DEADLINE_S, poll=0.3):
                """Poll until ``predicate(health_body)``; every poll also
                records any CONFIRMED subject outside ``guilty`` as a
                collateral verdict (the thing this drill exists to rule
                out)."""
                deadline = time.monotonic() + timeout
                while time.monotonic() < deadline:
                    try:
                        body = health_body()
                    except Exception:
                        time.sleep(poll)
                        continue
                    stray = confirmed_set(body) - set(guilty)
                    if stray:
                        collateral.append(sorted(stray))
                    if predicate(body):
                        return body
                    time.sleep(poll)
                return None

            # -- boot: all upstreams connected, churn running ------------
            def all_connected(_body=None):
                try:
                    health = get("/healthz").json()
                except Exception:
                    return False
                ups = health.get("federation", {}).get("upstreams", {})
                return all(
                    ups.get(f"cluster-{n}", {}).get("connected") for n in ("a", "b", "c")
                )

            deadline = time.monotonic() + DEADLINE_S
            while time.monotonic() < deadline and not all_connected():
                time.sleep(0.3)
            checks["federation_connected"] = all_connected()

            threads = [
                threading.Thread(
                    target=_slice_a_churn, args=(server_a.cluster, stop_churn, slow),
                    daemon=True,
                ),
                threading.Thread(
                    target=_cluster_b_churn, args=(server_b.cluster, stop_churn),
                    daemon=True,
                ),
                threading.Thread(
                    target=_cluster_c_churn, args=(server_c.cluster, stop_churn),
                    daemon=True,
                ),
            ]
            for thread in threads:
                thread.start()

            # baseline: slice-a nodes observed, everything healthy
            baseline = wait_for(
                lambda b: all(
                    f"node/{n}" in b["subjects"] for n in SLICE_NODES
                ) and all(
                    f"upstream/cluster-{n}" in b["subjects"] for n in ("a", "b", "c")
                ) and b["ticks"] > 12,
            )
            checks["baseline_subjects_observed"] = baseline is not None
            checks["baseline_all_healthy"] = baseline is not None and not confirmed_set(baseline)

            # -- scenario 1: degraded ICI link -> node-a1 ----------------
            for _ in range(CONFIRM_CYCLES + 1):
                tick_before = health_body()["ticks"]
                federator.health.observe_report(synthetic_link_report(
                    SLICE_NODES, degraded_node=ICI_NODE,
                ))
                wait_for(lambda b, t=tick_before: b["ticks"] > t,
                         guilty={f"node/{ICI_NODE}"}, timeout=10.0, poll=0.1)
            body = wait_for(
                lambda b: b["subjects"].get(f"node/{ICI_NODE}", {}).get("state")
                in ("confirmed", "remediating"),
                guilty={f"node/{ICI_NODE}"}, timeout=20.0,
            )
            checks["ici_guilty_confirmed"] = body is not None
            if body is not None:
                peers_healthy = all(
                    body["subjects"][f"node/{n}"]["state"] == "healthy"
                    for n in SLICE_NODES if n != ICI_NODE
                )
                checks["ici_peers_stay_healthy"] = peers_healthy
                reasons = body["subjects"][f"node/{ICI_NODE}"]["reasons"]
                checks["ici_reason_names_link_probe"] = any(
                    "link probe" in r for r in reasons
                )
                actions = [a for a in body["actions"] if a["node"] == ICI_NODE]
                checks["ici_dry_run_quarantine_logged"] = any(
                    a["action"] == "quarantine" and a["ok"] and a["dry_run"]
                    for a in actions
                )
            result["ici_detail"] = (body or {}).get("subjects", {}).get(f"node/{ICI_NODE}")
            # recovery: clean reports (same fabric, no suspects) decay it
            for _ in range(DECAY_CYCLES + 2):
                tick_before = health_body()["ticks"]
                federator.health.observe_report(synthetic_link_report(SLICE_NODES))
                wait_for(lambda b, t=tick_before: b["ticks"] > t,
                         guilty={f"node/{ICI_NODE}"}, timeout=10.0, poll=0.1)
            body = wait_for(
                lambda b: b["subjects"].get(f"node/{ICI_NODE}", {}).get("state") == "healthy",
                guilty={f"node/{ICI_NODE}"}, timeout=20.0,
            )
            checks["ici_decays_on_clean_reports"] = body is not None

            # -- scenario 2: slow-but-alive host -> node-a2 --------------
            slow["delay"] = 6.0
            slow["node"] = SLOW_NODE
            body = wait_for(
                lambda b: b["subjects"].get(f"node/{SLOW_NODE}", {}).get("state")
                in ("confirmed", "remediating"),
                guilty={f"node/{SLOW_NODE}"},
            )
            checks["slow_host_confirmed"] = body is not None
            if body is not None:
                checks["slow_host_peers_stay_healthy"] = all(
                    body["subjects"][f"node/{n}"]["state"] == "healthy"
                    for n in SLICE_NODES if n != SLOW_NODE
                )
                checks["slow_host_dry_run_quarantine_logged"] = any(
                    a["node"] == SLOW_NODE and a["action"] == "quarantine"
                    and a["ok"] and a["dry_run"]
                    for a in body["actions"]
                )
                signals = body["subjects"][f"node/{SLOW_NODE}"]["signals"]
                checks["slow_host_signal_is_phase_latency"] = (
                    "phase_latency_seconds" in signals
                )
            result["slow_host_detail"] = (body or {}).get("subjects", {}).get(
                f"node/{SLOW_NODE}"
            )
            # the /healthz BODY degrades while liveness stays 200
            health = get("/healthz")
            checks["healthz_degraded_body_never_liveness"] = (
                health.status_code == 200
                and health.json().get("alive") is True
                and health.json().get("health", {}).get("healthy") is False
            )
            # labeled gauges render for the straggler
            prom = get("/metrics", params={"format": "prometheus"}).text
            checks["labeled_health_metrics_render"] = (
                f'node_health_score{{node="{SLOW_NODE}"}}' in prom
                and f'health_state{{node="{SLOW_NODE}",state=' in prom
            )
            # recovery: remove the delay; the straggler de-escalates
            slow.pop("node", None)
            body = wait_for(
                lambda b: b["subjects"].get(f"node/{SLOW_NODE}", {}).get("state")
                == "healthy",
                guilty={f"node/{SLOW_NODE}"},
            )
            checks["slow_host_deescalates"] = body is not None

            # -- scenario 3: lagging apiserver -> cluster-c --------------
            server_c.cluster.hold_watch(True)
            body = wait_for(
                lambda b: b["subjects"].get(f"upstream/{LAG_UPSTREAM}", {}).get("state")
                in ("confirmed", "remediating"),
                guilty={f"upstream/{LAG_UPSTREAM}"},
            )
            checks["lagging_upstream_confirmed"] = body is not None
            if body is not None:
                checks["lagging_upstream_peers_stay_healthy"] = all(
                    body["subjects"][f"upstream/cluster-{n}"]["state"] == "healthy"
                    for n in ("a", "b")
                )
                checks["lagging_upstream_no_node_implicated"] = not any(
                    key.startswith("node/") and s["state"] != "healthy"
                    for key, s in body["subjects"].items()
                )
            result["lag_detail"] = (body or {}).get("subjects", {}).get(
                f"upstream/{LAG_UPSTREAM}"
            )
            # the upstream subscriber never went "stale" — connected and
            # heartbeating the whole time (slow-but-not-dead, the gap
            # staleness detection cannot see)
            fed = get("/healthz").json().get("federation", {})
            checks["lagging_upstream_never_stale"] = (
                fed.get("upstreams", {}).get(LAG_UPSTREAM, {}).get("stale") is False
            )
            # recovery: release the hold; the held window floods out and
            # the verdict decays
            server_c.cluster.hold_watch(False)
            body = wait_for(
                lambda b: b["subjects"].get(f"upstream/{LAG_UPSTREAM}", {}).get("state")
                == "healthy",
                guilty={f"upstream/{LAG_UPSTREAM}"},
            )
            checks["lagging_upstream_recovers"] = body is not None

            # -- final: everything healthy, zero collateral verdicts -----
            body = wait_for(lambda b: not confirmed_set(b), timeout=20.0)
            checks["final_all_healthy"] = body is not None
            checks["zero_collateral_verdicts"] = not collateral
            result["collateral"] = collateral
            result["final_actions"] = (body or {}).get("actions")
        finally:
            stop_churn.set()
            for thread in threads:
                thread.join(timeout=10)
            for app, thread in reversed(apps):
                app.stop()
                thread.join(timeout=15)
    result["ok"] = bool(checks) and all(checks.values())
    return result


def main(argv: Optional[List[str]] = None) -> int:
    args = smoke_args(__doc__.splitlines()[0], "health_smoke", argv)
    result = run_smoke(args.device)
    out = write_artifact(result, args.out)
    checks = checks_line(result["checks"])
    print(f"{'PASS' if result['ok'] else 'FAIL'}: {checks}")
    print(f"artifact: {out}")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
