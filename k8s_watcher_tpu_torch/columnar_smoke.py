"""Columnar-core smoke: the columnar ``FleetView`` vs a dict-core shadow
fed the SAME journal, through the REAL app wiring (the port's twin of ``make columnar-smoke``).

Boots the in-repo mock apiserver, points a ``WatcherApp`` at it with
``serve`` enabled (``serve.columnar: auto`` -> the columnar core — the
knob's plumbing is itself asserted), materializes a ~50k-pod TPU fleet
plus two indexed-Job slices through the live relist/watch pipeline, then
churns it: phase flips (some pods parked Pending), deletions, and a
slice-worker degradation. A second ``FleetView(columnar=False)`` shadow
is folded from the live view's OWN journal (``read_since`` — the exact
deltas every subscriber sees) at each stage, and the smoke gates:

1. **A/B byte-identity** — same rv line (every journaled delta applies
   cleanly to the shadow), identical ``snapshot()`` objects, and the
   snapshot BODIES byte-identical in both codecs — including the body
   actually served over HTTP by ``GET /serve/fleet``;
2. **memory ceiling** — the columnar store's deep-walked resident bytes
   stay under ``MEM_RATIO_CEILING`` x the dict shadow's on identical
   state, and the O(1) ``view_resident_bytes`` estimate tracks the
   walk within ``EST_ERROR_PCT``;
3. **verdict identity** — a health plane ticked against each core at
   each churn stage produces the same escalations and the same terminal
   subject-state map, and an analytics plane on each core returns the
   same summary document (rollup, phase counts, crosscheck verdict).

The port's twin of the JAX package's ``scripts/columnar_smoke.py``, with the
same stages and named checks; every app's analytics run on ``--device``
(default ``cuda:0``, raising without CUDA; ``cpu`` for tests):

    python -m k8s_watcher_tpu_torch.columnar_smoke [--device cpu] [--out F]

Artifact: ``artifacts/columnar_smoke_gpu.json`` (``--out``). Exit 0 on PASS.

The SPEEDUP and 0.5x-memory claims at 1M pods are gated by ``bench.py``
(bench_columnar_view, ingest-faithful json-decoded objects); this script
gates the CONTRACT through the real app. The memory ceiling here is
deliberately looser (0.75x): tracker-normalized objects share interned
literal key strings across pods, which flatters the dict core relative
to the decoded-object shape production ingests.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import sys
import threading
import time
from pathlib import Path
from typing import List, Optional

from k8s_watcher_tpu_torch.analytics.plane import AnalyticsPlane
from k8s_watcher_tpu_torch.app import WatcherApp
from k8s_watcher_tpu_torch.config import load_app_config
from k8s_watcher_tpu_torch.health.plane import HealthPlane
from k8s_watcher_tpu_torch.k8s.mock_server import MockApiServer
from k8s_watcher_tpu_torch.metrics import MetricsRegistry
from k8s_watcher_tpu_torch.serve.view import FleetView, msgpack_available
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

TOKEN = "columnar-smoke-token"
AUTH = {"Authorization": f"Bearer {TOKEN}"}
DEADLINE_S = 180.0
#: the fleet's size unless ``--pods`` says otherwise
N_PODS = int(os.environ.get("COLUMNAR_SMOKE_PODS", "50000"))
WORKERS = 4
MEM_RATIO_CEILING = 0.75
EST_ERROR_PCT = 15.0

#: the named checks the artifact carries (the JAX package's drill's own)
CHECKS = (
    "columnar_core_active",
    "rv_line_identical",
    "objects_identical",
    "json_body_identical",
    "msgpack_body_identical",
    "http_body_identical",
    "memory_under_ceiling",
    "resident_estimate_tracks",
    "health_ticks_identical",
    "health_states_identical",
    "analytics_identical",
    "analytics_crosscheck_ok",
)


def churn_sizes(pods: int) -> tuple:
    """(pods phase-flipped per stage, left Pending for the pending-age
    signal, tombstoned mid-run) for a fleet of ``pods``."""
    churn = min(3000, pods // 4)
    return churn, min(200, churn // 4), min(500, pods // 10)


def _retained_bytes(root) -> int:
    """Deep getsizeof walk with id-memo — identical accounting for both
    stores (bench.py's _retained_bytes, inlined to keep the script
    standalone)."""
    seen = set()
    stack = [root]
    total = 0
    while stack:
        obj = stack.pop()
        oid = id(obj)
        if oid in seen:
            continue
        seen.add(oid)
        total += sys.getsizeof(obj)
        if isinstance(obj, dict):
            stack.extend(obj.keys())
            stack.extend(obj.values())
        elif isinstance(obj, (list, tuple, set, frozenset)):
            stack.extend(obj)
        elif hasattr(obj, "__dict__"):
            stack.append(obj.__dict__)
    return total


def _smoke_config(tmp: Path, server_url: str, status_port: int, pods: int):
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
        # horizon must hold the WHOLE run's journal: the dict-core shadow
        # folds every delta from rv 0 — a trimmed journal would force a
        # resnapshot and the A/B would no longer be an independent fold
        serve=dataclasses.replace(
            config.serve, enabled=True, port=0,
            compact_horizon=pods * 3 + 50_000,
        ),
    )


def _slice_pod(slice_name: str, i: int, node: str, phase: str = "Running"):
    return build_pod(
        f"{slice_name}-{i}", "default", uid=f"uid-{slice_name}-{i}",
        phase=phase, node_name=node,
        labels={
            "job-name": slice_name,
            "batch.kubernetes.io/job-completion-index": str(i),
        },
        tpu_chips=4, tpu_topology="2x2x4",
        conditions=[{"type": "Ready", "status": "True"}],
    )


def run_smoke(device, pods: int = N_PODS) -> dict:
    import tempfile

    n_churn, n_parked, n_delete = churn_sizes(pods)
    status_port = free_port()
    result: dict = {
        "timestamp_utc": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "pods": pods,
        "churned": n_churn,
        "parked_pending": n_parked,
        "deleted": n_delete,
        "checks": {},
    }
    checks = result["checks"]
    with tempfile.TemporaryDirectory(prefix="columnar-smoke-") as tmp, MockApiServer() as server:
        for i in range(pods):
            server.cluster.add_pod(build_pod(
                f"fleet-{i:05d}", "default", uid=f"uid-fleet-{i:05d}",
                phase="Running", node_name=f"node-{i // 8}", tpu_chips=4,
            ))
        for name in ("slice-a", "slice-b"):
            for i in range(WORKERS):
                server.cluster.add_pod(_slice_pod(name, i, f"{name}-n{i}"))
        config = _smoke_config(Path(tmp), server.url, status_port, pods)
        app = WatcherApp(config, device=device)
        thread = threading.Thread(target=app.run, daemon=True)
        thread.start()
        deadline = time.monotonic() + DEADLINE_S
        try:
            expected = pods + 2 * WORKERS + 2  # pods + slice pods + slices
            view = None
            while time.monotonic() < deadline:
                if app.serve is not None and app.serve.port:
                    view = app.serve.view
                    if view.object_count() >= expected:
                        break
                time.sleep(0.2)
            else:
                raise RuntimeError(
                    f"fleet never materialized: {view and view.object_count()}/{expected}"
                )
            base = f"http://127.0.0.1:{app.serve.port}"
            # the knob's plumbing: development inherits base.yaml's
            # `columnar: auto`, and auto means the columnar core
            checks["columnar_core_active"] = view.columnar is True

            def settle(expect_count: int) -> int:
                """Wait until the view holds expect_count objects and the
                rv line stops moving for a beat (the watch is drained)."""
                last_rv, since = None, time.monotonic()
                while time.monotonic() < deadline:
                    rv = view.snapshot_tables()[0]
                    if view.object_count() == expect_count and rv == last_rv:
                        if time.monotonic() - since >= 1.0:
                            return rv
                    else:
                        last_rv, since = rv, time.monotonic()
                    time.sleep(0.2)
                raise RuntimeError(
                    f"settle timeout: count={view.object_count()} (want {expect_count})"
                )

            settle(expected)

            # the dict-core shadow, fed from the live view's own journal
            shadow = FleetView(
                compact_horizon=config.serve.compact_horizon, columnar=False,
            )
            shadow.instance = view.instance
            shadow_rv = 0

            def fold_shadow() -> int:
                """Fold every journal delta the shadow hasn't seen —
                the exact frames any subscriber would fold."""
                nonlocal shadow_rv
                applied = 0
                while True:
                    res = view.read_since(shadow_rv, max_deltas=1 << 30)
                    if res.status != "ok":
                        raise RuntimeError(f"shadow fold lost the journal: {res.status}")
                    if res.compacted:
                        raise RuntimeError("shadow fold got a compacted batch")
                    if not res.deltas:
                        return applied
                    applied += shadow.apply_batch([
                        (d.kind, d.key, d.object if d.type == "UPSERT" else None)
                        for d in res.deltas
                    ])
                    shadow_rv = res.to_rv

            # health + analytics planes on BOTH cores, ticked/compared at
            # every churn stage
            health_live = HealthPlane(config.health, view=view)
            health_shadow = HealthPlane(config.health, view=shadow)
            # each analytics plane on the app's device, with a registry of
            # its own for the card's encode and kernel times
            registries = (MetricsRegistry(), MetricsRegistry())
            analytics_live = AnalyticsPlane(config.analytics, view, metrics=registries[0], device=device)
            analytics_shadow = AnalyticsPlane(config.analytics, shadow, metrics=registries[1], device=device)
            tick_pairs = []

            def tick_both():
                fold_shadow()
                a = health_live.tick()
                b = health_shadow.tick()
                tick_pairs.append((
                    {k: a[k] for k in ("escalated", "deescalated", "actions")},
                    {k: b[k] for k in ("escalated", "deescalated", "actions")},
                ))

            tick_both()  # baseline at full fleet

            # stage 1: flip N_CHURN pods Pending (N_PARKED stay there)
            for i in range(n_churn):
                server.cluster.set_phase("default", f"fleet-{i:05d}", "Pending")
            settle(expected)
            tick_both()

            # stage 2: recover all but the parked pods; degrade slice-b
            # by one worker (side-table slice churn); delete a band
            for i in range(n_parked, n_churn):
                server.cluster.set_phase("default", f"fleet-{i:05d}", "Running")
            server.cluster.set_phase("default", "slice-b-0", "Pending")
            for i in range(n_churn, n_churn + n_delete):
                server.cluster.delete_pod("default", f"fleet-{i:05d}")
            final_rv = settle(expected - n_delete)
            tick_both()

            # -- gate 1: A/B byte-identity --------------------------------
            fold_shadow()
            rv_live, objs_live = view.snapshot()
            rv_shadow, objs_shadow = shadow.snapshot()
            checks["rv_line_identical"] = rv_live == rv_shadow == final_rv
            checks["objects_identical"] = objs_live == objs_shadow
            body_live = view.snapshot_bytes()
            body_shadow = shadow.snapshot_bytes()
            checks["json_body_identical"] = body_live == body_shadow
            if msgpack_available():
                checks["msgpack_body_identical"] = (
                    view.snapshot_bytes("msgpack") == shadow.snapshot_bytes("msgpack")
                )
            http_body = http_get(f"{base}/serve/fleet", headers=AUTH, timeout=30)
            checks["http_body_identical"] = http_body.content == body_shadow
            result["rv"] = rv_live
            result["objects"] = len(objs_live)
            result["body_mb"] = round(len(body_live) / 1e6, 2)

            # -- gate 2: memory ceiling -----------------------------------
            mem_col = _retained_bytes(view._objects)
            mem_dict = _retained_bytes(shadow._objects)
            est = view._objects.resident_bytes()
            ratio = mem_col / mem_dict if mem_dict else 1.0
            est_err = abs(est - mem_col) / mem_col * 100 if mem_col else 0.0
            checks["memory_under_ceiling"] = ratio <= MEM_RATIO_CEILING
            checks["resident_estimate_tracks"] = est_err <= EST_ERROR_PCT
            result["memory"] = {
                "columnar_mb": round(mem_col / 1e6, 1),
                "dict_mb": round(mem_dict / 1e6, 1),
                "ratio": round(ratio, 3),
                "ceiling": MEM_RATIO_CEILING,
                "estimate_error_pct": round(est_err, 1),
            }

            # -- gate 3: verdict identity ---------------------------------
            checks["health_ticks_identical"] = all(a == b for a, b in tick_pairs)
            snap_live = health_live.detector.snapshot()
            snap_shadow = health_shadow.detector.snapshot()
            states_live = {k: v["state"] for k, v in snap_live["subjects"].items()}
            states_shadow = {k: v["state"] for k, v in snap_shadow["subjects"].items()}
            checks["health_states_identical"] = states_live == states_shadow
            t0 = time.perf_counter()
            sum_live = analytics_live.summary()
            t1 = time.perf_counter()
            sum_shadow = analytics_shadow.summary()
            t2 = time.perf_counter()
            checks["analytics_identical"] = sum_live == sum_shadow
            checks["analytics_crosscheck_ok"] = (
                sum_live.get("crosscheck", {}).get("ok", False)
            )
            result["health_subjects"] = len(states_live)
            result["analytics_fleet"] = sum_live.get("fleet")
            result["health_ticks"] = len(tick_pairs)
            # the port's addition to the artifact: each summary's wall ms
            # and the planes' encode and kernel histograms
            result["analytics_summary_ms"] = {"columnar": (t1 - t0) * 1e3, "dict": (t2 - t1) * 1e3}
            result["analytics_histograms"] = {
                core: {k: v for k, v in registry.dump().items()
                       if k.startswith("analytics_") and k.endswith("_seconds")}
                for core, registry in zip(("columnar", "dict"), registries)
            }
        finally:
            app.stop()
            thread.join(timeout=15)
    result["ok"] = bool(checks) and all(checks.values())
    return result


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pods", type=int, default=N_PODS,
                        help="fleet size (default: COLUMNAR_SMOKE_PODS, else 50,000)")
    args = smoke_args(parser.description, "columnar_smoke", argv, parser)
    result = run_smoke(args.device, args.pods)
    out = write_artifact(result, args.out)
    checks = checks_line(result["checks"])
    print(f"{'PASS' if result['ok'] else 'FAIL'}: {checks}")
    mem = result.get("memory") or {}
    if mem:
        print(
            "memory: columnar %.1f MB vs dict %.1f MB (ratio %.3f <= %.2f), estimate err %.1f%%"
            % (mem["columnar_mb"], mem["dict_mb"], mem["ratio"], mem["ceiling"],
               mem["estimate_error_pct"])
        )
    print(f"artifact: {out}")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
