"""Analytics-plane smoke: the full what-if contract, end to end, through
the REAL app wiring (the port's twin of ``make analytics-smoke``).

Boots the in-repo mock apiserver, points a ``WatcherApp`` at it with
``serve`` + ``history`` + ``analytics`` enabled and a bearer token,
forms two real TPU slices (indexed-Job pods with nodeName placement)
through the live pipeline/tracker, merges a synthetic second cluster
through the REAL federation merge keying (``GlobalMerge``), and gates:

1. **rollup exactness** — ``GET /serve/analytics``'s vectorized slice
   aggregates equal the tracker's incremental counters EXACTLY (the
   per-request cross-check, over local AND merged cluster-prefixed
   objects);
2. **drain cluster A** — the what-if names EXACTLY the quorum-losing
   slices: the merged cluster's healthy slice, never its already-
   degraded one (nothing below quorum can "lose" it), never a local
   slice;
3. **cordon one node** — exactly the local slice placed on that node
   loses quorum;
4. **auth + codec** — /serve/analytics 401s without the bearer and
   serves decode-identical bodies under msgpack negotiation;
5. **bulk replay** — after a clean shutdown (terminal WAL snapshot),
   the batched N-scenario replay (ONE deterministic replay, one
   scenario-axis kernel launch) produces verdicts EXACTLY equal to N
   sequential Python folds over the same capture.

The port's twin of the JAX package's ``scripts/analytics_smoke.py``, with the
same stages and named checks; every app's analytics run on ``--device``
(default ``cuda:0``, raising without CUDA; ``cpu`` for tests):

    python -m k8s_watcher_tpu_torch.analytics_smoke [--device cpu] [--out F]

Artifact: ``artifacts/analytics_smoke_gpu.json`` (``--out``). Exit 0 on PASS.

The SPEEDUP side of the batched-replay story (>=5x at 10k pods) is
gated by ``bench.py --smoke`` (bench_analytics); this script gates the
CONTRACT over real HTTP through the real app.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import sys
import threading
import time
from pathlib import Path
from typing import List, Optional

from k8s_watcher_tpu_torch.analytics import (
    Scenario,
    batched_replay_verdicts,
    comparable,
    sequential_replay_verdicts,
)
from k8s_watcher_tpu_torch.app import WatcherApp
from k8s_watcher_tpu_torch.config import load_app_config
from k8s_watcher_tpu_torch.federate.merge import GlobalMerge
from k8s_watcher_tpu_torch.k8s.mock_server import MockApiServer
from k8s_watcher_tpu_torch.smoke_common import (
    REPO,
    RequestError,
    checks_line,
    free_port,
    http_get,
    quote,
    smoke_args,
    write_artifact,
    write_kubeconfig,
)
from k8s_watcher_tpu_torch.watch.fake import build_pod

TOKEN = "analytics-smoke-token"
AUTH = {"Authorization": f"Bearer {TOKEN}"}
DEADLINE_S = 45.0
WORKERS = 4
CHIPS = 4

#: the named checks the artifact carries (the JAX package's drill's own)
CHECKS = (
    "local_fleet_materialized",
    "rollup_exact",
    "drain_cluster_a_exact",
    "cordon_node_exact",
    "max_scenarios_enforced",
    "auth_enforced",
    "codec_negotiated",
    "metrics_live",
    "replay_batched_equals_sequential",
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
        clusterapi=dataclasses.replace(config.clusterapi, base_url=server_url),
        watcher=dataclasses.replace(
            config.watcher, status_port=status_port, status_auth_token=TOKEN,
        ),
        serve=dataclasses.replace(config.serve, enabled=True, port=0),
        history=dataclasses.replace(
            config.history, enabled=True, dir=str(tmp / "wal"), fsync="never",
        ),
        analytics=dataclasses.replace(
            config.analytics, enabled=True, backend="auto", crosscheck=True,
        ),
    )


def _slice_pod(slice_name: str, i: int, node: str, phase: str = "Pending"):
    return build_pod(
        f"{slice_name}-{i}", "default", uid=f"uid-{slice_name}-{i}",
        phase=phase, node_name=node,
        labels={
            "job-name": slice_name,
            "batch.kubernetes.io/job-completion-index": str(i),
        },
        tpu_chips=CHIPS, tpu_topology="2x2x4",
        conditions=[{"type": "Ready", "status": "True"}],
    )


def _cluster_a_objects():
    """The synthetic second cluster merged through GlobalMerge: one
    healthy slice (quorum) and one already-degraded slice (no quorum —
    the drain verdict must NOT name it)."""
    objects = []

    def synthetic_slice(name: str, ready_workers: int):
        workers = []
        for i in range(WORKERS):
            up = i < ready_workers
            node = f"ca-{name}-n{i}"
            workers.append({
                "name": f"{name}-{i}", "worker_index": i,
                "phase": "Running" if up else "Pending",
                "ready": up, "restarts": 0, "node": node, "node_ready": True,
            })
            objects.append({
                "kind": "pod", "key": f"uid-{name}-{i}", "name": f"{name}-{i}",
                "namespace": "default", "phase": "Running" if up else "Pending",
                "ready": up, "node": node,
            })
        objects.append({
            "kind": "slice", "key": f"default/{name}", "slice": f"default/{name}",
            "expected_workers": WORKERS, "observed_workers": WORKERS,
            "ready_workers": ready_workers, "chips_per_worker": CHIPS,
            "phase": "Ready" if ready_workers == WORKERS else "Degraded",
            "workers": workers,
        })

    synthetic_slice("ca-ready", WORKERS)
    synthetic_slice("ca-degraded", 2)
    return objects


def _analytics(base: str, params: str = "", timings: Optional[list] = None) -> dict:
    """GET /serve/analytics; ``timings`` collects the request's wall ms."""
    t0 = time.perf_counter()
    r = http_get(f"{base}/serve/analytics{params}", headers=AUTH, timeout=5)
    if timings is not None:
        timings.append((time.perf_counter() - t0) * 1e3)
    r.raise_for_status()
    return r.json()


def _scenarios_param(scenarios) -> str:
    return "?scenarios=" + quote(
        json.dumps([s.to_wire() for s in scenarios])
    )


def run_smoke(device) -> dict:
    import tempfile

    status_port = free_port()
    result: dict = {
        "timestamp_utc": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "checks": {},
    }
    checks = result["checks"]
    with tempfile.TemporaryDirectory(prefix="analytics-smoke-") as tmp, MockApiServer() as server:
        for name, nodes in (("slice-a", "la"), ("slice-b", "lb")):
            for i in range(WORKERS):
                server.cluster.add_pod(_slice_pod(name, i, f"{nodes}-{i}"))
        config = _smoke_config(Path(tmp), server.url, status_port)
        wal_dir = config.history.dir
        app = WatcherApp(config, device=device)
        thread = threading.Thread(target=app.run, daemon=True)
        thread.start()
        try:
            # wait for the serve plane + the relist to materialize pods
            deadline = time.monotonic() + DEADLINE_S
            base = None
            while time.monotonic() < deadline:
                if app.serve is not None and app.serve.port:
                    base = f"http://127.0.0.1:{app.serve.port}"
                    try:
                        if _analytics(base)["fleet"]["pods"] >= 2 * WORKERS:
                            break
                    except RequestError:
                        pass
                time.sleep(0.2)
            else:
                raise RuntimeError("analytics plane never materialized the fleet")
            result["serve_port"] = app.serve.port

            # churn slice-b through real phase flips (WAL content + the
            # tracker recomputing aggregates), then settle both slices
            # READY and degrade slice-b by exactly one worker
            for round_idx in range(6):
                phase = "Running" if round_idx % 2 == 0 else "Pending"
                for i in range(WORKERS):
                    server.cluster.set_phase("default", f"slice-b-{i}", phase)
                time.sleep(0.05)
            for name in ("slice-a", "slice-b"):
                for i in range(WORKERS):
                    server.cluster.set_phase("default", f"{name}-{i}", "Running")
            time.sleep(0.3)
            server.cluster.set_phase("default", "slice-b-0", "Pending")

            def wait_for(predicate, what: str):
                while time.monotonic() < deadline:
                    body = _analytics(base)
                    if predicate(body):
                        return body
                    time.sleep(0.2)
                raise RuntimeError(f"timed out waiting for {what}: {_analytics(base)}")

            summary = wait_for(
                lambda b: b["fleet"]["slices"] == 2
                and b["fleet"]["slices_with_quorum"] == 1
                and b["fleet"]["ready_workers"] == 2 * WORKERS - 1,
                "slice-a quorum + degraded slice-b",
            )
            checks["local_fleet_materialized"] = True
            result["local_summary"] = summary

            # merge a synthetic second cluster through the REAL
            # federation keying (cluster-prefixed keys, cluster field)
            merge = GlobalMerge(app.serve.view, metrics=app.metrics)
            merge.reset_cluster("cluster-a", _cluster_a_objects())
            summary = wait_for(
                lambda b: b["fleet"]["slices"] == 4
                and b["fleet"]["slices_with_quorum"] == 2,
                "merged cluster-a slices",
            )
            result["merged_summary"] = summary

            # 1. rollup exactness over local + merged objects
            checks["rollup_exact"] = (
                summary["crosscheck"]["ok"]
                and summary["crosscheck"]["slices"] == 4
                and summary["fleet"]["chips_ready"]
                == (WORKERS + (WORKERS - 1) + WORKERS + 2) * CHIPS
            )

            # 2. drain cluster A: exactly the merged healthy slice loses
            # quorum — not its degraded sibling, not a local slice
            request_ms: dict = {"summary": [], "drain_cluster": [], "cordon_nodes": []}
            for _ in range(3):
                _analytics(base, timings=request_ms["summary"])
            drain = _analytics(base, "?drain_cluster=cluster-a", request_ms["drain_cluster"])
            verdict = drain["scenarios"][0]
            checks["drain_cluster_a_exact"] = (
                verdict["slices_losing_quorum"] == ["cluster-a/default/ca-ready"]
                and verdict["slices_with_quorum"] == 1
                and verdict["chips_ready"] == (WORKERS + (WORKERS - 1)) * CHIPS
                and drain["crosscheck"]["ok"]
            )
            result["drain_cluster_a"] = verdict

            # 3. cordon one local node: exactly slice-a loses quorum
            cordon = _analytics(base, _scenarios_param(
                [Scenario("cordon_nodes", nodes=("la-1",))]
            ), request_ms["cordon_nodes"])
            result["request_ms"] = request_ms
            verdict = cordon["scenarios"][0]
            checks["cordon_node_exact"] = (
                verdict["slices_losing_quorum"] == ["default/slice-a"]
                and "unknown_nodes" not in verdict
            )
            result["cordon_la_1"] = verdict

            # over-cap request 400s with the declared bound
            over = http_get(
                f"{base}/serve/analytics" + _scenarios_param(
                    [Scenario("baseline")] * (config.analytics.max_scenarios + 1)
                ),
                headers=AUTH, timeout=5,
            )
            checks["max_scenarios_enforced"] = over.status_code == 400

            # 4. auth posture + msgpack negotiation (decode-identical)
            checks["auth_enforced"] = (
                http_get(f"{base}/serve/analytics", timeout=5).status_code == 401
            )
            mp = http_get(
                f"{base}/serve/analytics",
                headers={**AUTH, "Accept": "application/x-msgpack"}, timeout=5,
            )
            try:
                import msgpack

                decoded = msgpack.unpackb(mp.content, raw=False)
                checks["codec_negotiated"] = (
                    mp.headers.get("Content-Type") == "application/x-msgpack"
                    and decoded["fleet"] == _analytics(base)["fleet"]
                )
            except ImportError:  # stripped env: JSON fallback is the contract
                checks["codec_negotiated"] = mp.headers.get(
                    "Content-Type", ""
                ).startswith("application/json")
            metrics = http_get(
                f"http://127.0.0.1:{status_port}/metrics", headers=AUTH, timeout=5
            ).json()
            result["analytics_metrics"] = {
                k: v.get("count") for k, v in metrics.items() if k.startswith("analytics_")
            }
            # the card's encode and kernel times per request (the port's
            # addition to the artifact)
            result["analytics_histograms"] = {
                k: v for k, v in metrics.items() if k.startswith("analytics_") and k.endswith("_seconds")
            }
            checks["metrics_live"] = (
                result["analytics_metrics"].get("analytics_requests", 0) > 0
                and result["analytics_metrics"].get("analytics_crosscheck_failures", 1) == 0
            )
        finally:
            app.stop()
            thread.join(timeout=15)

        # 5. bulk replay over the capture: batched == N sequential folds
        scenarios = [
            Scenario("baseline"),
            Scenario("drain_cluster", cluster="cluster-a"),
            Scenario("drain_cluster", cluster=""),
            Scenario("cordon_nodes", nodes=("la-1", "lb-1")),
        ]
        t0 = time.perf_counter()
        batched = batched_replay_verdicts(wal_dir, scenarios, device=device)
        t_batched = time.perf_counter() - t0
        t0 = time.perf_counter()
        sequential = sequential_replay_verdicts(wal_dir, scenarios)
        t_sequential = time.perf_counter() - t0
        checks["replay_batched_equals_sequential"] = (
            comparable(batched) == comparable(sequential)
            and batched["rv_mismatches"] == 0
            and batched["crosscheck"]["ok"]
        )
        result["replay"] = {
            "scenarios": len(scenarios),
            "rv": batched["rv"],
            "deltas_applied": batched["deltas_applied"],
            "batched_seconds": round(t_batched, 4),
            "sequential_seconds": round(t_sequential, 4),
            "batched": comparable(batched),
        }
    result["ok"] = bool(checks) and all(checks.values())
    return result


def main(argv: Optional[List[str]] = None) -> int:
    args = smoke_args(__doc__.splitlines()[0], "analytics_smoke", argv)
    result = run_smoke(args.device)
    out = write_artifact(result, args.out)
    checks = checks_line(result["checks"])
    print(f"{'PASS' if result['ok'] else 'FAIL'}: {checks}")
    replay = result.get("replay") or {}
    if replay:
        print(
            "replay: %d scenarios over rv=%d (%d deltas), batched %.3fs vs sequential %.3fs"
            % (replay["scenarios"], replay["rv"], replay["deltas_applied"],
               replay["batched_seconds"], replay["sequential_seconds"])
        )
    print(f"artifact: {out}")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
