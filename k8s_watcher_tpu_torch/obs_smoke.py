"""Observability-plane smoke: freshness watermarks + SLO burn rates
end to end over real processes-shaped apps (the port's twin of ``make obs-smoke``).

Boots ONE full mock-backed upstream ``WatcherApp`` (mock apiserver +
serve plane on a fixed port) and ONE federator ``WatcherApp``
(``federation.enabled`` pointing at it, ``slo.enabled`` with tight
windows and a deliberately-tight staleness objective), then drives the
freshness & SLO contract the tentpole promises:

1. **labeled exposition** — the federator's ``/metrics?format=
   prometheus`` renders real labels: ``federation_upstream_lag_rv
   {upstream="cluster-a"}``, ``slo_burn_rate{objective=...,window=...}``;
2. **propagation telemetry** — ``watch_to_global_view_seconds`` and
   ``serve_wire_seconds`` populate through the negotiated ``?fresh=1``
   per-frame stamps while churn flows (pod event on the upstream's mock
   apiserver -> merged global view);
3. **watermarks advance under churn** — ``/debug/freshness`` shows a
   small per-upstream watermark age while the upstream churns;
4. **watermarks age when the upstream pauses** — churn stops; the
   watermark age grows past the pause without any reconnect/staleness
   machinery firing (the upstream is alive, just quiet — exactly the
   signal staleness detection cannot give);
5. **a breaching SLO degrades the /healthz BODY, never liveness** —
   the tight staleness objective (watermark age <= 1 s) burns through
   both windows during the pause: ``/healthz`` stays 200 while
   ``body.slo.healthy`` flips false with the objective named;
6. **recovery** — churn resumes; the watermark re-advances and the
   breach clears once the slow window drains.

Then the **multi-process leg** (``run_multiproc_smoke``): a third app
with REAL worker processes on both tiers (``ingest.shards: 2`` +
``ingest.processes: 2`` over a second mock apiserver,
``federation.processes: 2`` over the upstream plus a never-connecting
"ghost" upstream) gates the process-observability surfaces — worker-
labeled series on the parent ``/metrics`` scrape, ``/debug/processes``
reporting all four workers, a worker-side anomaly trace (the ghost's
staleness verdict, captured inside a merge worker) queryable at the
parent's ``/debug/trace?uid=``, and the ``/healthz`` BODY's worker-
stats freshness fold.

The port's twin of the JAX package's ``scripts/obs_smoke.py``, with the
same stages and named checks; every app's analytics run on ``--device``
(default ``cuda:0``, raising without CUDA; ``cpu`` for tests):

    python -m k8s_watcher_tpu_torch.obs_smoke [--device cpu] [--out F]

Artifact: ``artifacts/obs_smoke_gpu.json`` (``--out``). Exit 0 on PASS.

The LATENCY gate on the same histograms (3-upstream p50/p99 budgets) is
bench-smoke's ``bench_federation``; this script gates the surfaces —
labels, watermarks, /debug/freshness, /debug/slo, the healthz fold —
over real wire and real app lifecycles.
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
from k8s_watcher_tpu_torch.config import FederationUpstream, SloConfig, load_app_config
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
from k8s_watcher_tpu_torch.watch.fake import build_pod

N_PODS = 5
TOKEN = "obs-smoke-token"
AUTH = {"Authorization": f"Bearer {TOKEN}"}
DEADLINE_S = 60.0
#: tight staleness objective: watermark age must stay under this
TIGHT_MAX_AGE_S = 1.0
#: SLO windows (short, so a breach surfaces within the pause leg)
FAST_WINDOW_S = 2.0
SLOW_WINDOW_S = 5.0
PAUSE_S = SLOW_WINDOW_S + 3.0

#: the named checks the artifact carries (the JAX package's drill's own)
CHECKS = (
    "federation_connected",
    "propagation_histograms_populated",
    "labeled_exposition_renders",
    "watermark_advances_under_churn",
    "watermark_ages_when_paused",
    "tight_slo_breaches_degraded_body",
    "generous_slo_not_breaching",
    "debug_slo_detail",
    "watermark_recovers_on_resume",
    "slo_breach_clears_after_recovery",
    "debug_processes_reports_fleet",
    "worker_labeled_series_render",
    "ingest_shipped_series_render",
    "worker_anomaly_trace_in_parent_ring",
    "healthz_processes_fold",
)


def _upstream_config(tmp: Path, server_url: str, serve_port: int):
    kc_path = tmp / "kubeconfig.json"
    write_kubeconfig(kc_path, server_url)
    config = load_app_config("development", str(REPO / "config"), env={})
    return dataclasses.replace(
        config,
        kubernetes=dataclasses.replace(
            config.kubernetes, use_mock=False, config_file=str(kc_path),
            watch_timeout_seconds=5,
        ),
        clusterapi=dataclasses.replace(config.clusterapi, base_url=server_url),
        watcher=dataclasses.replace(config.watcher, status_auth_token=TOKEN),
        serve=dataclasses.replace(config.serve, enabled=True, port=serve_port),
        slo=SloConfig(),  # the federator owns the SLO leg
    )


def _federator_config(upstreams, notify_url: str, status_port: int):
    config = load_app_config("development", str(REPO / "config"), env={})
    return dataclasses.replace(
        config,
        kubernetes=dataclasses.replace(config.kubernetes, use_mock=True),
        clusterapi=dataclasses.replace(config.clusterapi, base_url=notify_url),
        watcher=dataclasses.replace(
            config.watcher, status_port=status_port, status_auth_token=TOKEN,
        ),
        serve=dataclasses.replace(config.serve, enabled=True, port=0),
        federation=dataclasses.replace(
            config.federation,
            enabled=True,
            upstreams=tuple(upstreams),
            stale_after_seconds=5.0,
            resync_backoff_seconds=0.2,
        ),
        slo=SloConfig.from_raw({
            "enabled": True,
            "tick_seconds": 0.25,
            "ring_size": 256,
            "fast_window_seconds": FAST_WINDOW_S,
            "slow_window_seconds": SLOW_WINDOW_S,
            "objectives": [
                # the tentpole's flagship objective (generously budgeted
                # — this one must NOT breach in the smoke)
                {"name": "global-propagation-p99",
                 "histogram": "watch_to_global_view_seconds",
                 "quantile": 0.99, "max_seconds": 5.0, "target": 0.95},
                # deliberately tight: breaches during the pause leg
                {"name": "watermark-tight",
                 "gauge": "federation_upstream_watermark_age_seconds",
                 "max": TIGHT_MAX_AGE_S, "target": 0.99},
            ],
        }),
    )


def _start_app(device, config):
    app = WatcherApp(config, device=device)
    thread = threading.Thread(target=app.run, daemon=True)
    thread.start()
    return app, thread


def _churn(server, stop: threading.Event, beat: float = 0.1, prefix: str = "obs-pod") -> None:
    phases = ("Running", "Pending")
    r = 0
    while not stop.is_set():
        for i in range(N_PODS):
            server.cluster.set_phase("default", f"{prefix}-{i}", phases[r % 2])
        r += 1
        time.sleep(beat)


def _get(status_port: int, path: str, **kw):
    return http_get(f"http://127.0.0.1:{status_port}{path}", headers=AUTH, timeout=5, **kw)


def _watermark_age(status_port: int):
    body = _get(status_port, "/debug/freshness").json()["freshness"]
    upstream = body.get("federation", {}).get("upstreams", {}).get("cluster-a", {})
    return upstream.get("watermark_age_seconds"), body


def run_smoke(device) -> dict:
    import tempfile

    result: dict = {
        "timestamp_utc": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "checks": {},
    }
    checks = result["checks"]
    with tempfile.TemporaryDirectory(prefix="obs-smoke-") as tmp_str, MockApiServer() as server:
        tmp = Path(tmp_str)
        for i in range(N_PODS):
            server.cluster.add_pod(build_pod(
                f"obs-pod-{i}", "default", uid=f"obs-uid-{i}",
                phase="Pending", tpu_chips=4,
            ))
        serve_port = free_port()
        status_f = free_port()
        upstream_app, upstream_thread = _start_app(device, 
            _upstream_config(tmp, server.url, serve_port)
        )
        federator = fed_thread = None
        stop_churn = threading.Event()
        churner = None
        try:
            # upstream materializes its fleet
            deadline = time.monotonic() + DEADLINE_S
            while time.monotonic() < deadline:
                try:
                    snap = http_get(
                        f"http://127.0.0.1:{serve_port}/serve/fleet",
                        headers=AUTH, timeout=5,
                    ).json()
                    if len([o for o in snap.get("objects", []) if o.get("kind") == "pod"]) >= N_PODS:
                        break
                except Exception:
                    pass
                time.sleep(0.2)
            else:
                raise RuntimeError("upstream never materialized its pods")

            federator, fed_thread = _start_app(device, _federator_config(
                [FederationUpstream(
                    url=f"http://127.0.0.1:{serve_port}", name="cluster-a", token=TOKEN,
                )],
                server.url,
                status_f,
            ))
            deadline = time.monotonic() + DEADLINE_S
            while time.monotonic() < deadline:
                try:
                    health = _get(status_f, "/healthz").json()
                    fed = health.get("federation", {})
                    if fed.get("upstreams", {}).get("cluster-a", {}).get("connected"):
                        break
                except Exception:
                    pass
                time.sleep(0.2)
            else:
                raise RuntimeError("federator never connected to the upstream")
            checks["federation_connected"] = True

            # phase 1: churn -> propagation telemetry + advancing watermark
            churner = threading.Thread(target=_churn, args=(server, stop_churn), daemon=True)
            churner.start()
            populated = False
            deadline = time.monotonic() + DEADLINE_S
            while time.monotonic() < deadline:
                metrics = _get(status_f, "/metrics").json()
                w2g = metrics.get("watch_to_global_view_seconds", {}).get("count", 0)
                wire = metrics.get("serve_wire_seconds", {}).get("count", 0)
                if w2g > 0 and wire > 0:
                    populated = True
                    break
                time.sleep(0.3)
            checks["propagation_histograms_populated"] = populated
            result["watch_to_global_view_seconds"] = {
                k: v for k, v in metrics.get("watch_to_global_view_seconds", {}).items()
                if k in ("count", "p50_ms", "p99_ms")
            }

            # labeled Prometheus exposition (the tentpole's metric layer)
            # retried: the per-upstream gauges are set by the federation
            # monitor's ~1 Hz tick, which may not have fired yet when the
            # histogram poll above returns on its first pass
            wanted_lines = (
                'federation_upstream_lag_rv{upstream="cluster-a"}',
                'federation_upstream_watermark_age_seconds{upstream="cluster-a"}',
                'slo_burn_rate{objective="watermark-tight",window="fast"}',
                'slo_breaching{objective="global-propagation-p99"}',
            )
            missing = list(wanted_lines)
            deadline = time.monotonic() + 15.0
            while missing and time.monotonic() < deadline:
                text = _get(status_f, "/metrics", params={"format": "prometheus"}).text
                missing = [line for line in wanted_lines if line not in text]
                if missing:
                    time.sleep(0.5)
            checks["labeled_exposition_renders"] = not missing
            if missing:
                result["missing_exposition_lines"] = missing

            # watermark advances (stays young) under churn
            ages = []
            for _ in range(5):
                age, _body = _watermark_age(status_f)
                if age is not None:
                    ages.append(age)
                time.sleep(0.3)
            checks["watermark_advances_under_churn"] = (
                len(ages) >= 3 and min(ages) < TIGHT_MAX_AGE_S
            )
            result["churn_watermark_ages"] = ages

            # phase 2: pause the upstream's churn — the watermark AGES
            # (no reconnect, no staleness; the upstream is alive & idle)
            stop_churn.set()
            churner.join()
            time.sleep(PAUSE_S)
            paused_age, freshness_body = _watermark_age(status_f)
            checks["watermark_ages_when_paused"] = (
                paused_age is not None and paused_age >= PAUSE_S * 0.8
            )
            result["paused_watermark_age"] = paused_age
            result["freshness_at_pause"] = freshness_body

            # the deliberately-tight SLO breached: /healthz body degrades
            # while LIVENESS stays 200 (an error budget is an alert, not
            # a reason to crash-loop the watcher)
            r = _get(status_f, "/healthz")
            body = r.json()
            slo_body = body.get("slo", {})
            checks["tight_slo_breaches_degraded_body"] = (
                r.status_code == 200
                and body.get("alive") is True
                and slo_body.get("healthy") is False
                and "watermark-tight" in slo_body.get("breaching", [])
            )
            # ...and the generous objective did NOT breach (no traffic
            # during the pause = no latency burn; staleness is the gauge
            # objective's job)
            checks["generous_slo_not_breaching"] = (
                "global-propagation-p99" not in slo_body.get("breaching", [])
            )
            result["healthz_at_breach"] = {"status": r.status_code, "slo": slo_body}
            slo_detail = _get(status_f, "/debug/slo").json()["slo"]
            tight = slo_detail["objectives"]["watermark-tight"]
            checks["debug_slo_detail"] = (
                tight["breaching"] is True
                and tight["windows"]["fast"]["burn_rate"] > 1.0
                and tight["windows"]["slow"]["burn_rate"] > 1.0
            )
            result["slo_detail_at_breach"] = tight

            # phase 3: resume churn — watermark recovers, breach clears
            # once the slow window drains
            stop_churn.clear()
            churner = threading.Thread(target=_churn, args=(server, stop_churn), daemon=True)
            churner.start()
            recovered = False
            breach_cleared = False
            deadline = time.monotonic() + SLOW_WINDOW_S * 4 + DEADLINE_S
            while time.monotonic() < deadline:
                age, _body = _watermark_age(status_f)
                slo_health = _get(status_f, "/healthz").json().get("slo", {})
                recovered = age is not None and age < TIGHT_MAX_AGE_S
                breach_cleared = slo_health.get("healthy") is True
                if recovered and breach_cleared:
                    break
                time.sleep(0.5)
            checks["watermark_recovers_on_resume"] = recovered
            checks["slo_breach_clears_after_recovery"] = breach_cleared
        finally:
            stop_churn.set()
            if churner is not None:
                churner.join(timeout=5)
            for app, thread in ((federator, fed_thread), (upstream_app, upstream_thread)):
                if app is not None:
                    app.stop()
                    thread.join(timeout=15)
    result["ok"] = bool(checks) and all(checks.values())
    return result


def _multiproc_config(tmp: Path, server_url: str, upstreams, status_port: int):
    """App 3: REAL worker processes on both tiers — 2 ingest shard
    readers over the mock apiserver and 2 federation merge workers —
    with the worker registry/trace export on (the default)."""
    kc_path = tmp / "mp-kubeconfig.json"
    write_kubeconfig(kc_path, server_url)
    config = load_app_config("development", str(REPO / "config"), env={})
    return dataclasses.replace(
        config,
        kubernetes=dataclasses.replace(
            config.kubernetes, use_mock=False, config_file=str(kc_path),
            watch_timeout_seconds=5,
        ),
        clusterapi=dataclasses.replace(config.clusterapi, base_url=server_url),
        watcher=dataclasses.replace(
            config.watcher, status_port=status_port, status_auth_token=TOKEN,
        ),
        ingest=dataclasses.replace(config.ingest, shards=2, processes=2),
        state=dataclasses.replace(
            config.state, checkpoint_path=str(tmp / "mp-ckpt.json"),
        ),
        trace=dataclasses.replace(config.trace, enabled=True, sample_rate=4),
        federation=dataclasses.replace(
            config.federation,
            enabled=True,
            processes=2,
            upstreams=tuple(upstreams),
            stale_after_seconds=1.0,
            resync_backoff_seconds=0.2,
        ),
    )


def run_multiproc_smoke(device) -> dict:
    """The multi-process leg: worker-labeled series render on the parent
    scrape, /debug/processes reports the fleet, a worker-side anomaly
    trace (never-connected "ghost" upstream going stale inside a merge
    worker) lands in the parent's shared ring, and the /healthz BODY
    folds worker-stats freshness."""
    import tempfile

    from k8s_watcher_tpu_torch.watch.sharded import shard_of

    result: dict = {"checks": {}}
    checks = result["checks"]
    # the ghost must hash to the OTHER merge worker so both spawn (an
    # ownerless fan-in worker is not spawned at all)
    ghost = next(
        name for name in ("ghost-a", "ghost-b", "ghost-c", "ghost-d")
        if shard_of(name, 2) != shard_of("cluster-a", 2)
    )
    result["ghost_upstream"] = ghost
    expected = {
        "ingest-shard-0", "ingest-shard-1", "merge-worker-0", "merge-worker-1",
    }
    with tempfile.TemporaryDirectory(prefix="obs-smoke-mp-") as tmp_str, \
            MockApiServer() as server_a, MockApiServer() as server_b:
        tmp = Path(tmp_str)
        for i in range(N_PODS):
            server_a.cluster.add_pod(build_pod(
                f"obs-pod-{i}", "default", uid=f"obs-uid-{i}",
                phase="Pending", tpu_chips=4,
            ))
            server_b.cluster.add_pod(build_pod(
                f"obsm-pod-{i}", "default", uid=f"obsm-uid-{i}",
                phase="Pending", tpu_chips=4,
            ))
        serve_port = free_port()
        status_m = free_port()
        upstream_app, upstream_thread = _start_app(device, 
            _upstream_config(tmp, server_a.url, serve_port)
        )
        mp_app = mp_thread = None
        stop_churn = threading.Event()
        churners = []
        try:
            mp_app, mp_thread = _start_app(device, _multiproc_config(
                tmp, server_b.url,
                [
                    FederationUpstream(
                        url=f"http://127.0.0.1:{serve_port}",
                        name="cluster-a", token=TOKEN,
                    ),
                    # never connects: goes stale inside its merge worker
                    # after the grace window -> worker-side anomaly trace
                    FederationUpstream(
                        url=f"http://127.0.0.1:{free_port()}",
                        name=ghost, token=TOKEN,
                    ),
                ],
                status_m,
            ))
            for server, prefix in ((server_a, "obs-pod"), (server_b, "obsm-pod")):
                t = threading.Thread(
                    target=_churn, args=(server, stop_churn, 0.1, prefix),
                    daemon=True,
                )
                t.start()
                churners.append(t)

            # the fleet spins up: all four workers alive with fresh stats
            rows = []
            deadline = time.monotonic() + DEADLINE_S * 2
            while time.monotonic() < deadline:
                try:
                    body = _get(status_m, "/debug/processes").json()["processes"]
                    rows = body["workers"]
                    alive = {r["process"] for r in rows if r["alive"]}
                    if alive >= expected:
                        break
                except Exception:
                    pass
                time.sleep(0.3)
            checks["debug_processes_reports_fleet"] = (
                {r["process"] for r in rows if r["alive"]} >= expected
                and all(r["generation"] >= 1 for r in rows)
            )
            result["process_rows"] = rows

            # worker-labeled series render on the PARENT scrape
            wanted = [f'process="{label}"' for label in expected]
            missing = list(wanted)
            deadline = time.monotonic() + DEADLINE_S
            while missing and time.monotonic() < deadline:
                text = _get(status_m, "/metrics", params={"format": "prometheus"}).text
                missing = [w for w in wanted if w not in text]
                if missing:
                    time.sleep(0.5)
            checks["worker_labeled_series_render"] = not missing
            if missing:
                result["missing_worker_series"] = missing
            checks["ingest_shipped_series_render"] = (
                'k8s_watcher_ingest_events_shipped_total{process="ingest-shard-' in text
            )

            # the ghost upstream's staleness verdict, captured INSIDE a
            # merge worker, queryable at the parent's /debug/trace?uid=
            traces = []
            deadline = time.monotonic() + DEADLINE_S
            while time.monotonic() < deadline:
                traces = _get(
                    status_m, "/debug/trace", params={"uid": ghost},
                ).json().get("traces", [])
                if traces:
                    break
                time.sleep(0.5)
            checks["worker_anomaly_trace_in_parent_ring"] = bool(traces) and (
                traces[0].get("anomaly") is True
                and str(traces[0].get("process", "")).startswith("merge-worker-")
            )
            result["ghost_traces"] = traces[:2]

            # /healthz BODY folds worker-stats freshness (alive workers
            # report in well under the staleness threshold)
            health = _get(status_m, "/healthz").json()
            processes_fold = health.get("processes", {})
            checks["healthz_processes_fold"] = (
                health.get("alive") is True
                and processes_fold.get("healthy") is True
                and processes_fold.get("processes", 0) >= 4
            )
            result["healthz_processes"] = processes_fold
        finally:
            stop_churn.set()
            for t in churners:
                t.join(timeout=5)
            for app, thread in ((mp_app, mp_thread), (upstream_app, upstream_thread)):
                if app is not None:
                    app.stop()
                    thread.join(timeout=20)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    args = smoke_args(__doc__.splitlines()[0], "obs_smoke", argv)
    result = run_smoke(args.device)
    mp = run_multiproc_smoke(args.device)
    result["multiproc"] = {k: v for k, v in mp.items() if k != "checks"}
    result["checks"].update(mp["checks"])
    result["ok"] = bool(result["checks"]) and all(result["checks"].values())
    out = write_artifact(result, args.out)
    checks = checks_line(result["checks"])
    print(f"{'PASS' if result['ok'] else 'FAIL'}: {checks}")
    print(f"artifact: {out}")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
