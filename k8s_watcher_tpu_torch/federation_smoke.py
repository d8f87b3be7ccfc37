"""Federation-plane smoke: two clusters, one global view, an upstream
killed and restarted mid-churn (the port's twin of ``make federation-smoke``).

Boots TWO full mock-backed ``WatcherApp``s (each its own mock apiserver,
serving plane on a fixed port, history WAL — the PR-5 restart-surviving
rv line) plus ONE federator ``WatcherApp`` (``federation.enabled``,
upstreams pointing at both serve planes, bearer-authenticated), then
drives the multi-cluster contract end to end:

1. **materialize** — both upstream fleets appear in the federator's
   ``/serve/fleet`` under cluster-prefixed keys;
2. **gapless global consumption** — a resume-protocol consumer
   (``federate.client.ResumeLoop`` — the same implementation the plane
   itself runs) follows the GLOBAL view through churn on both clusters
   with zero gaps/dups;
3. **kill** — upstream A is stopped mid-churn (SIGTERM-shape shutdown:
   WAL drained, terminal snapshot written); the federator's /healthz
   must DEGRADE (federation.healthy=false once A is stale) while B's
   churn keeps flowing into the global view;
4. **restart** — a brand-new upstream-A process on the same directories
   and port recovers its rv line from the WAL (same view instance); the
   federator's subscriber resumes with its held token — ZERO resyncs,
   zero gaps/dups through the restart (the PR-5 contract, exercised
   across process AND cluster boundaries) — and /healthz RECOVERS;
5. **converge** — the merged terminal state equals the union of both
   upstream snapshots under cluster-prefixed keys, and the consumer's
   replayed model equals the federator's final snapshot.

The port's twin of the JAX package's ``scripts/federation_smoke.py``, with the
same stages and named checks; every app's analytics run on ``--device``
(default ``cuda:0``, raising without CUDA; ``cpu`` for tests):

    python -m k8s_watcher_tpu_torch.federation_smoke [--device cpu] [--out F]

Artifact: ``artifacts/federation_smoke_gpu.json`` (``--out``). Exit 0 on PASS.

The fan-in LATENCY gate (pod-event->global-view p50 across 3 upstreams)
is bench-smoke's ``bench_federation``; this script gates the protocol
and the failover story over real processes-shaped lifecycles.
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
from k8s_watcher_tpu_torch.config import load_app_config
from k8s_watcher_tpu_torch.federate import (
    FleetClient,
    ResumeLoop,
    merged_equals_union,
    model_from_objects,
)
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

N_PODS = 6
TOKEN = "federation-smoke-token"
DEADLINE_S = 60.0
STALE_AFTER_S = 2.0
AUTH = {"Authorization": f"Bearer {TOKEN}"}

#: the named checks the artifact carries (the JAX package's drill's own)
CHECKS = (
    "upstreams_materialized",
    "global_view_materialized",
    "upstream_kill_clean",
    "healthz_degrades_on_dark_upstream",
    "healthz_recovers_after_restart",
    "global_consumer_gapless",
    "upstream_restart_resume_gapless",
    "merged_equals_union_of_upstreams",
    "fanin_codec_negotiated",
    "consumer_codec_negotiated",
    "federation_metrics_live",
)


def _upstream_config(tmp: Path, name: str, server_url: str, serve_port: int, status_port: int):
    """One upstream cluster's watcher: mock apiserver + serve plane on a
    FIXED port (the federator's configured target must survive restarts)
    + history WAL (the restart-surviving rv line under test)."""
    kc_path = tmp / f"kubeconfig-{name}.json"
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
        serve=dataclasses.replace(
            config.serve, enabled=True, port=serve_port,
            queue_depth=64, compact_horizon=4096,
        ),
        history=dataclasses.replace(
            config.history, enabled=True, dir=str(tmp / f"history-{name}"),
            fsync="interval", fsync_interval_seconds=0.2,
            segment_max_bytes=64 * 1024, retain_segments=16,
        ),
        state=dataclasses.replace(
            config.state, checkpoint_path=str(tmp / f"checkpoint-{name}.json"),
            checkpoint_interval_seconds=0.5,
        ),
    )


def _federator_config(tmp: Path, upstreams, notify_url: str, status_port: int):
    """The federator: in-process fake ingest (it federates, it does not
    watch a cluster of its own here), serve plane republishing the merged
    view, federation.enabled with tight staleness so the kill leg shows
    in /healthz within a couple of heartbeats."""
    config = load_app_config("development", str(REPO / "config"), env={})
    return dataclasses.replace(
        config,
        kubernetes=dataclasses.replace(config.kubernetes, use_mock=True),
        clusterapi=dataclasses.replace(config.clusterapi, base_url=notify_url),
        watcher=dataclasses.replace(
            config.watcher, status_port=status_port, status_auth_token=TOKEN,
        ),
        serve=dataclasses.replace(
            config.serve, enabled=True, port=0,
            queue_depth=128, compact_horizon=8192,
        ),
        federation=dataclasses.replace(
            config.federation,
            enabled=True,
            upstreams=tuple(upstreams),
            stale_after_seconds=STALE_AFTER_S,
            resync_backoff_seconds=0.2,
            drop_stale=False,
        ),
        state=dataclasses.replace(
            config.state, checkpoint_path=str(tmp / "federator-checkpoint.json"),
        ),
    )


def _churn(server, prefix: str, rounds: int, flip_offset: int = 0, stop=None) -> None:
    phases = ("Running", "Pending")
    for r in range(rounds):
        if stop is not None and stop.is_set():
            return
        for i in range(N_PODS):
            server.cluster.set_phase(
                "default", f"{prefix}-pod-{i}", phases[(r + flip_offset) % 2]
            )
        time.sleep(0.05)


def _start_app(device, config) -> tuple:
    app = WatcherApp(config, device=device)
    thread = threading.Thread(target=app.run, daemon=True)
    thread.start()
    return app, thread


def _wait_upstream(serve_port: int, min_pods: int, deadline_s: float) -> None:
    deadline = time.monotonic() + deadline_s
    client = FleetClient(f"http://127.0.0.1:{serve_port}", token=TOKEN)
    while time.monotonic() < deadline:
        try:
            snap = client.snapshot()
            if len([o for o in snap.objects if o.get("kind") == "pod"]) >= min_pods:
                return
        except Exception:
            pass
        time.sleep(0.2)
    raise RuntimeError(f"upstream on :{serve_port} never materialized {min_pods} pods")


def _healthz(status_port: int) -> tuple:
    r = http_get(f"http://127.0.0.1:{status_port}/healthz", timeout=5)
    return r.status_code, r.json()


def run_smoke(device) -> dict:
    import tempfile

    result: dict = {
        "timestamp_utc": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "checks": {},
    }
    checks = result["checks"]
    from k8s_watcher_tpu_torch.config import FederationUpstream

    with tempfile.TemporaryDirectory(prefix="federation-smoke-") as tmp_str, \
            MockApiServer() as server_a, MockApiServer() as server_b:
        tmp = Path(tmp_str)
        for server, prefix in ((server_a, "a"), (server_b, "b")):
            for i in range(N_PODS):
                server.cluster.add_pod(build_pod(
                    f"{prefix}-pod-{i}", "default", uid=f"{prefix}-uid-{i}",
                    phase="Pending", tpu_chips=4,
                ))
        port_a, port_b = free_port(), free_port()
        status_a, status_b, status_f = free_port(), free_port(), free_port()

        cfg_a = _upstream_config(tmp, "a", server_a.url, port_a, status_a)
        cfg_b = _upstream_config(tmp, "b", server_b.url, port_b, status_b)
        app_a, thread_a = _start_app(device, cfg_a)
        app_b, thread_b = _start_app(device, cfg_b)
        federator = fed_thread = None
        try:
            _wait_upstream(port_a, N_PODS, DEADLINE_S)
            _wait_upstream(port_b, N_PODS, DEADLINE_S)
            checks["upstreams_materialized"] = True

            federator, fed_thread = _start_app(device, _federator_config(
                tmp,
                [
                    FederationUpstream(url=f"http://127.0.0.1:{port_a}", name="cluster-a", token=TOKEN),
                    FederationUpstream(url=f"http://127.0.0.1:{port_b}", name="cluster-b", token=TOKEN),
                ],
                server_a.url,
                status_f,
            ))
            # global view materializes both fleets under prefixed keys
            deadline = time.monotonic() + DEADLINE_S
            fed_base = None
            while time.monotonic() < deadline:
                if federator.serve is not None and federator.serve.port:
                    fed_base = f"http://127.0.0.1:{federator.serve.port}"
                    try:
                        snap = FleetClient(fed_base, token=TOKEN).snapshot()
                        federated = [o for o in snap.objects if o.get("cluster")]
                        if len(federated) >= 2 * N_PODS:
                            break
                    except Exception:
                        pass
                time.sleep(0.2)
            else:
                raise RuntimeError("federator never materialized both fleets")
            checks["global_view_materialized"] = True
            result["federator_port"] = federator.serve.port

            # the global-view consumer: the SAME resume-loop implementation
            # the plane runs, sequence-checked
            consumer = ResumeLoop(FleetClient(fed_base, token=TOKEN))
            consumer.start()

            # phase 1: churn both clusters under a live consumer
            churner_a = threading.Thread(target=_churn, args=(server_a, "a", 8), daemon=True)
            churner_b = threading.Thread(target=_churn, args=(server_b, "b", 8), daemon=True)
            churner_a.start()
            churner_b.start()
            while churner_a.is_alive() or churner_b.is_alive():
                consumer.poll(timeout=0.5)
            churner_a.join()
            churner_b.join()

            # phase 2: kill upstream A mid-churn (clean SIGTERM shape: the
            # WAL drains and the terminal snapshot anchors the rv line)
            stop_b = threading.Event()
            churner_b2 = threading.Thread(
                target=_churn, args=(server_b, "b", 200, 1, stop_b), daemon=True
            )
            churner_b2.start()
            app_a.stop()
            thread_a.join(timeout=15)
            checks["upstream_kill_clean"] = not thread_a.is_alive()

            # the /healthz BODY must degrade once A is stale (federation
            # .healthy=false, per-upstream stale detail) while LIVENESS
            # stays 200 — a dark remote cluster must never crash-loop the
            # federator (B's churn keeps flowing through it)
            degraded = False
            liveness_stayed_up = True
            degrade_deadline = time.monotonic() + STALE_AFTER_S * 10
            while time.monotonic() < degrade_deadline:
                consumer.poll(timeout=0.3)
                code, body = _healthz(status_f)
                liveness_stayed_up &= code == 200
                fed_health = body.get("federation", {})
                if fed_health.get("healthy") is False:
                    up = fed_health.get("upstreams", {}).get("cluster-a", {})
                    degraded = up.get("stale") is True
                    if degraded:
                        break
            checks["healthz_degrades_on_dark_upstream"] = degraded and liveness_stayed_up
            result["degraded_health"] = {
                "cluster_a_stale": degraded,
                "cluster_b_objects": fed_health.get("upstreams", {}).get("cluster-b", {}).get("objects"),
            }

            # phase 3: restart upstream A on the same dirs + port; the
            # federator's held resume token must ride the recovered rv
            # line — zero resyncs, zero gaps — and /healthz must recover
            app_a, thread_a = _start_app(device, _upstream_config(tmp, "a", server_a.url, port_a, free_port()))
            _wait_upstream(port_a, N_PODS, DEADLINE_S)
            churner_a2 = threading.Thread(target=_churn, args=(server_a, "a", 8, 1), daemon=True)
            churner_a2.start()
            recovered = False
            recover_deadline = time.monotonic() + DEADLINE_S
            while time.monotonic() < recover_deadline:
                consumer.poll(timeout=0.3)
                _, body = _healthz(status_f)
                if body.get("federation", {}).get("healthy") is True:
                    recovered = True
                    break
            churner_a2.join()
            stop_b.set()
            churner_b2.join()
            checks["healthz_recovers_after_restart"] = recovered

            # drain the consumer, then the verdicts
            consumer.drain(polls=40, timeout=0.3)
            fed_snap = FleetClient(fed_base, token=TOKEN).snapshot()
            truth = model_from_objects(fed_snap.objects)
            checks["global_consumer_gapless"] = (
                consumer.checker.gaps == 0
                and consumer.checker.dups == 0
                and consumer.checker.delivered > 0
                and consumer.resyncs == 0
                and consumer.model == truth
            )
            result["consumer"] = {
                **consumer.checker.to_dict(),
                "polls": consumer.polls,
                "resyncs": consumer.resyncs,
                "model_matches_snapshot": consumer.model == truth,
            }

            # the PR-5 leg: the federator's upstream-A subscriber resumed
            # across the restart on its held token — no re-snapshot storm
            _, body = _healthz(status_f)
            up_a = body.get("federation", {}).get("upstreams", {}).get("cluster-a", {})
            checks["upstream_restart_resume_gapless"] = (
                up_a.get("resyncs") == 0
                and up_a.get("gaps") == 0
                and up_a.get("dups") == 0
                and up_a.get("reconnects", 0) > 0  # it DID lose the connection
            )
            result["upstream_a"] = up_a
            result["upstream_b"] = body.get("federation", {}).get("upstreams", {}).get("cluster-b")

            # converge: merged state == union of upstream snapshots under
            # cluster-prefixed keys (the shared federate.merged_equals_union
            # gate — same check bench_federation runs)
            def union_matches() -> bool:
                return merged_equals_union(
                    FleetClient(fed_base, token=TOKEN).snapshot().objects,
                    {
                        name: FleetClient(f"http://127.0.0.1:{port}", token=TOKEN).snapshot().objects
                        for name, port in (("cluster-a", port_a), ("cluster-b", port_b))
                    },
                )

            converged = False
            converge_deadline = time.monotonic() + 15.0
            while time.monotonic() < converge_deadline:
                if union_matches():
                    converged = True
                    break
                time.sleep(0.3)
            checks["merged_equals_union_of_upstreams"] = converged

            # codec negotiation on the fan-in wire: the federator's
            # upstream subscribers (config codec: auto) and the global
            # consumer both negotiated msgpack when available — and the
            # gapless/merged==union verdicts above all rode that wire
            from k8s_watcher_tpu_torch.serve.view import msgpack_available

            _, body = _healthz(status_f)
            upstream_codecs = {
                name: up.get("codec")
                for name, up in body.get("federation", {}).get("upstreams", {}).items()
            }
            expected_codec = "msgpack" if msgpack_available() else "json"
            checks["fanin_codec_negotiated"] = bool(upstream_codecs) and all(
                c == expected_codec for c in upstream_codecs.values()
            )
            checks["consumer_codec_negotiated"] = (
                consumer.client.active_codec == expected_codec
            )
            result["codecs"] = {
                "upstreams": upstream_codecs,
                "consumer": consumer.client.active_codec,
            }

            metrics = http_get(
                f"http://127.0.0.1:{status_f}/metrics", headers=AUTH, timeout=5
            ).json()
            checks["federation_metrics_live"] = (
                metrics.get("federation_deltas_applied", {}).get("count", 0) > 0
                and metrics.get("federation_merged_objects", {}).get("value", 0) >= 2 * N_PODS
                and metrics.get("federation_reconnects", {}).get("count", 0) > 0
            )
            result["metrics"] = {
                k: v for k, v in metrics.items() if k.startswith("federation")
            }
        finally:
            for app, thread in ((federator, fed_thread), (app_a, thread_a), (app_b, thread_b)):
                if app is not None:
                    app.stop()
                    thread.join(timeout=15)
    result["ok"] = bool(checks) and all(checks.values())
    return result


def main(argv: Optional[List[str]] = None) -> int:
    args = smoke_args(__doc__.splitlines()[0], "federation_smoke", argv)
    result = run_smoke(args.device)
    out = write_artifact(result, args.out)
    checks = checks_line(result["checks"])
    print(f"{'PASS' if result['ok'] else 'FAIL'}: {checks}")
    consumer = result.get("consumer") or {}
    if consumer:
        print(
            "global consumer: %d polls, %d deltas, gaps=%d dups=%d resyncs=%d"
            % (consumer["polls"], consumer["delivered"], consumer["gaps"],
               consumer["dups"], consumer["resyncs"])
        )
    print(f"artifact: {out}")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
