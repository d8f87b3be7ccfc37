"""Trace-plane smoke: the full mock cluster, end to end, through the REAL
app wiring (the port's twin of ``make trace-smoke``).

Boots the in-repo mock apiserver (which doubles as the clusterapi notify
target), points a ``WatcherApp`` at it over real HTTP with tracing on,
churns pod phases, and asserts the tracing plane's three contracts:

1. ``watch_to_notify_seconds`` is POPULATED (count > 0) in ``/metrics`` —
   the watch-observed -> notify-delivered histogram exists and moves;
2. the Prometheus text exposition carries real ``le`` buckets for it
   (content negotiation on the same route);
3. a head-sampled trace whose journey completed cleanly shows ALL SIX
   stages at ``/debug/trace`` — shard_receive, queue_wait, pipeline,
   lane_wait, conn_borrow, post — i.e. no hand-off drops the span context.

Then the FEDERATION leg: a second WatcherApp (an upstream with the serve
plane on) watches the same mock apiserver while a federator WatcherApp
subscribes to it with ``trace.federation`` enabled, and the leg asserts
the cross-cluster contracts:

4. one ``/debug/trace?uid=`` query at the FEDERATOR returns a single
   JOINED journey for a pod that originated in the upstream cluster —
   watch (shard_receive) -> pipeline -> serve_wire -> federate_merge ->
   global_serve — spanning both processes, with monotone stage ordering;
5. ``/debug/trace/diagnosis`` attributes propagation time per upstream
   per stage (slowest-stage attribution present), and the labeled
   ``trace_stage_seconds{stage=,upstream=}`` series render in /metrics.

The port's twin of the JAX package's ``scripts/trace_smoke.py``, with the
same stages and named checks; every app's analytics run on ``--device``
(default ``cuda:0``, raising without CUDA; ``cpu`` for tests):

    python -m k8s_watcher_tpu_torch.trace_smoke [--device cpu] [--out F]

Artifact: ``artifacts/trace_smoke_gpu.json`` (``--out``). Exit 0 on PASS.

The overhead side of the tracing budget (<3% at 1/256 sampling) is gated
separately by ``bench.py --smoke`` (bench_trace_overhead); this script
gates CORRECTNESS of the plane at a sample rate high enough to observe
quickly (1/8).
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
from k8s_watcher_tpu_torch.config import FederationUpstream, load_app_config
from k8s_watcher_tpu_torch.k8s.mock_server import MockApiServer
from k8s_watcher_tpu_torch.smoke_common import (
    REPO,
    RequestError,
    checks_line,
    free_port,
    http_get,
    smoke_args,
    write_artifact,
    write_kubeconfig,
)
from k8s_watcher_tpu_torch.trace import STAGES
from k8s_watcher_tpu_torch.watch.fake import build_pod

N_PODS = 8
SAMPLE_RATE = 8
DEADLINE_S = 45.0

#: the named checks the artifact carries (the JAX package's drill's own)
CHECKS = (
    "watch_to_notify_populated",
    "prometheus_le_buckets",
    "six_stage_sampled_trace",
    "federation_joined_trace_spans_both_processes",
    "federation_joined_stage_order_monotone",
    "federation_stitched_journeys_present",
    "federation_diagnosis_slowest_stage",
    "federation_diagnosis_serve_wire_counted",
    "federation_labeled_stage_series_render",
)


def _smoke_config(tmp: Path, server_url: str, status_port: int):
    kc_path = tmp / "kubeconfig.json"
    write_kubeconfig(kc_path, server_url)
    config = load_app_config("development", str(REPO / "config"), env={})
    return dataclasses.replace(
        config,
        kubernetes=dataclasses.replace(
            config.kubernetes, use_mock=False, config_file=str(kc_path),
            watch_timeout_seconds=5,
        ),
        # the mock apiserver IS the notify target (it serves /health +
        # /api/pods/update[_batch]) — the POSTs are real HTTP round-trips
        clusterapi=dataclasses.replace(
            config.clusterapi, base_url=server_url,
            # per-item POSTs + no coalescing: every churned transition
            # must complete its own journey, so sampled journeys aren't
            # collapsed away before they reach the post stage
            coalesce=False, batch_max=1,
        ),
        watcher=dataclasses.replace(config.watcher, status_port=status_port),
        trace=dataclasses.replace(
            config.trace, enabled=True, sample_rate=SAMPLE_RATE, ring_size=256,
        ),
    )


def run_smoke(device) -> dict:
    import tempfile

    status_port = free_port()
    base = f"http://127.0.0.1:{status_port}"
    result: dict = {
        "timestamp_utc": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "sample_rate": SAMPLE_RATE,
        "checks": {},
    }
    with tempfile.TemporaryDirectory(prefix="trace-smoke-") as tmp, MockApiServer() as server:
        for i in range(N_PODS):
            server.cluster.add_pod(build_pod(
                f"trace-pod-{i}", "default", uid=f"uid-{i}",
                phase="Pending", tpu_chips=4,
            ))
        app = WatcherApp(_smoke_config(Path(tmp), server.url, status_port), device=device)
        thread = threading.Thread(target=app.run, daemon=True)
        thread.start()
        try:
            deadline = time.monotonic() + DEADLINE_S
            # churn phases while polling: each flip is a significant delta
            # -> a notification -> (for the sampled 1/8) a full journey
            phase_flip, churned = ("Running", "Pending"), 0
            metrics_json: dict = {}
            six_stage_trace = None
            while time.monotonic() < deadline:
                for i in range(N_PODS):
                    server.cluster.set_phase(
                        "default", f"trace-pod-{i}", phase_flip[churned % 2]
                    )
                churned += 1
                time.sleep(0.25)
                try:
                    metrics_json = http_get(f"{base}/metrics", timeout=5).json()
                    traces = http_get(
                        f"{base}/debug/trace?n=100", timeout=5
                    ).json().get("traces", [])
                except RequestError:
                    continue  # status server still coming up
                six_stage_trace = next(
                    (
                        t for t in traces
                        if t["sampled_by"] == "head" and t["outcome"] == "sent"
                        and {s["stage"] for s in t["spans"]} >= set(STAGES)
                    ),
                    None,
                )
                populated = (
                    metrics_json.get("watch_to_notify_seconds", {}).get("count", 0) > 0
                )
                if populated and six_stage_trace is not None:
                    break
            prom_text = http_get(
                f"{base}/metrics", params={"format": "prometheus"}, timeout=5
            ).text
            w2n = metrics_json.get("watch_to_notify_seconds", {})
            result["churn_rounds"] = churned
            result["watch_to_notify_seconds"] = {
                k: w2n.get(k) for k in ("count", "p50_ms", "p90_ms", "p99_ms")
            }
            result["six_stage_trace"] = six_stage_trace
            result["checks"] = {
                "watch_to_notify_populated": w2n.get("count", 0) > 0,
                "prometheus_le_buckets": (
                    'k8s_watcher_watch_to_notify_seconds_bucket{le="' in prom_text
                ),
                "six_stage_sampled_trace": six_stage_trace is not None,
            }
        finally:
            app.stop()
            thread.join(timeout=10)
    result["ok"] = all(result["checks"].values())
    return result


def _federation_configs(tmp: Path, server_url: str, serve_port: int, fed_status_port: int):
    """(upstream config, federator config): the upstream watches the mock
    apiserver and serves its view on ``serve_port``; the federator
    subscribes with trace joining on. Both trace at 1/1 so every churned
    transition is a joinable journey."""
    kc_path = tmp / "fed-kubeconfig.json"
    write_kubeconfig(kc_path, server_url)
    base = load_app_config("development", str(REPO / "config"), env={})
    upstream = dataclasses.replace(
        base,
        kubernetes=dataclasses.replace(
            base.kubernetes, use_mock=False, config_file=str(kc_path),
            watch_timeout_seconds=5,
        ),
        clusterapi=dataclasses.replace(
            base.clusterapi, base_url=server_url, coalesce=False, batch_max=1,
        ),
        serve=dataclasses.replace(base.serve, enabled=True, port=serve_port),
        trace=dataclasses.replace(base.trace, enabled=True, sample_rate=1, ring_size=512),
    )
    federator = dataclasses.replace(
        base,
        # the federator's own watch source is the in-process fake — its
        # local pods are irrelevant; the journeys under test originate
        # in the UPSTREAM cluster and arrive over the federation wire
        kubernetes=dataclasses.replace(base.kubernetes, use_mock=True),
        clusterapi=dataclasses.replace(
            base.clusterapi, base_url=server_url, coalesce=False, batch_max=1,
        ),
        watcher=dataclasses.replace(base.watcher, status_port=fed_status_port),
        serve=dataclasses.replace(base.serve, enabled=True, port=0),
        federation=dataclasses.replace(
            base.federation, enabled=True,
            upstreams=(FederationUpstream(
                url=f"http://127.0.0.1:{serve_port}", name="cluster-a",
            ),),
            stale_after_seconds=5.0,
        ),
        trace=dataclasses.replace(
            base.trace, enabled=True, sample_rate=1, ring_size=512,
            federation=dataclasses.replace(
                base.trace.federation, enabled=True, forward_spans=True,
                max_joined=128,
            ),
        ),
    )
    return upstream, federator


#: the joined journey's required path (watch -> ... -> global view); the
#: smoke additionally requires monotone ordering along it
JOURNEY_STAGES = ("shard_receive", "pipeline", "serve_wire", "federate_merge", "global_serve")
#: cross-clock slack for the ordering check: upstream-local offsets are
#: monotonic-measured, cross-cluster offsets wall-measured — both anchor
#: at the watch receive instant, but the clocks are different
ORDER_SLACK_MS = 50.0


def _journey_ordered(trace: dict) -> bool:
    """Monotone stage ordering along the joined journey path."""
    starts = {}
    for span in trace["spans"]:
        stage = span["stage"]
        if stage not in starts:
            starts[stage] = span["start_ms"]
    prev = None
    for stage in JOURNEY_STAGES:
        if stage not in starts:
            return False
        if prev is not None and starts[stage] < prev - ORDER_SLACK_MS:
            return False
        prev = starts[stage]
    return True


def run_federation_leg(device) -> dict:
    import tempfile

    serve_port = free_port()
    fed_status_port = free_port()
    fed_base = f"http://127.0.0.1:{fed_status_port}"
    result: dict = {"checks": {}}
    with tempfile.TemporaryDirectory(prefix="trace-fed-smoke-") as tmp, MockApiServer() as server:
        for i in range(N_PODS):
            server.cluster.add_pod(build_pod(
                f"fed-pod-{i}", "default", uid=f"fed-uid-{i}",
                phase="Pending", tpu_chips=4,
            ))
        up_cfg, fed_cfg = _federation_configs(
            Path(tmp), server.url, serve_port, fed_status_port
        )
        upstream = WatcherApp(up_cfg, device=device)
        up_thread = threading.Thread(target=upstream.run, daemon=True)
        up_thread.start()
        federator = WatcherApp(fed_cfg, device=device)
        fed_thread = threading.Thread(target=federator.run, daemon=True)
        fed_thread.start()
        try:
            deadline = time.monotonic() + DEADLINE_S
            phase_flip, churned = ("Running", "Pending"), 0
            joined = None
            diagnosis: dict = {}
            stitched: dict = {}
            while time.monotonic() < deadline:
                for i in range(N_PODS):
                    server.cluster.set_phase(
                        "default", f"fed-pod-{i}", phase_flip[churned % 2]
                    )
                churned += 1
                time.sleep(0.25)
                try:
                    body = http_get(
                        f"{fed_base}/debug/trace?uid=fed-uid-3&n=50", timeout=5
                    ).json()
                    diagnosis = http_get(
                        f"{fed_base}/debug/trace/diagnosis", timeout=5
                    ).json().get("diagnosis", {})
                except RequestError:
                    continue  # federator status server still coming up
                stitched = body.get("stitched") or {}
                joined = next(
                    (
                        t for t in body.get("traces", [])
                        if t.get("outcome") == "merged"
                        and t.get("cluster") == "cluster-a"
                        and {s["stage"] for s in t["spans"]} >= set(JOURNEY_STAGES)
                    ),
                    None,
                )
                cluster_diag = (diagnosis.get("upstreams") or {}).get("cluster-a") or {}
                if joined is not None and cluster_diag.get("slowest_stage"):
                    break
            try:
                prom_text = http_get(
                    f"{fed_base}/metrics", params={"format": "prometheus"}, timeout=5
                ).text
            except RequestError:
                # a federator that never came up must FAIL the checks
                # below, not crash the smoke before the artifact writes
                prom_text = ""
            cluster_diag = (diagnosis.get("upstreams") or {}).get("cluster-a") or {}
            result["churn_rounds"] = churned
            result["joined_trace"] = joined
            result["diagnosis_cluster_a"] = cluster_diag
            result["checks"] = {
                # one query at the FEDERATOR answers the whole journey
                "joined_trace_spans_both_processes": joined is not None,
                "joined_stage_order_monotone": (
                    joined is not None and _journey_ordered(joined)
                ),
                # the stitched section rides the same ?uid= answer
                "stitched_journeys_present": bool(stitched.get("journeys")),
                # slowest-stage attribution per upstream per stage
                "diagnosis_slowest_stage": bool(cluster_diag.get("slowest_stage")),
                "diagnosis_serve_wire_counted": (
                    (cluster_diag.get("stages") or {}).get("serve_wire", {})
                    .get("count", 0) > 0
                ),
                # the labeled family the SLO/health planes consume
                "labeled_stage_series_render": (
                    'k8s_watcher_trace_stage_seconds_bucket{' in prom_text
                    and 'upstream="cluster-a"' in prom_text
                ),
            }
        finally:
            federator.stop()
            fed_thread.join(timeout=10)
            upstream.stop()
            up_thread.join(timeout=10)
    result["ok"] = all(result["checks"].values())
    return result


def main(argv: Optional[List[str]] = None) -> int:
    args = smoke_args(__doc__.splitlines()[0], "trace_smoke", argv)
    result = run_smoke(args.device)
    federation = run_federation_leg(args.device)
    result["federation"] = federation
    result["checks"].update(
        {f"federation_{k}": v for k, v in federation["checks"].items()}
    )
    result["ok"] = result["ok"] and federation["ok"]
    out = write_artifact(result, args.out)
    checks = checks_line(result["checks"])
    print(f"{'PASS' if result['ok'] else 'FAIL'}: {checks}")
    w2n = result.get("watch_to_notify_seconds") or {}
    if w2n.get("count"):
        print(
            "watch_to_notify_seconds: count=%d p50=%.2fms p90=%.2fms p99=%.2fms"
            % (w2n["count"], w2n["p50_ms"], w2n["p90_ms"], w2n["p99_ms"])
        )
    print(f"artifact: {out}")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
