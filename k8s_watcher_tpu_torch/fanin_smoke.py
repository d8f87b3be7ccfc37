"""Sharded fan-in smoke: two clusters, two merge-worker PROCESSES, one
worker SIGKILLed and one upstream darkened mid-churn (the port's twin of ``make fanin-smoke``).

Boots TWO full mock-backed ``WatcherApp``s (each its own mock apiserver,
serving plane on a fixed port, history WAL) plus ONE federator
``WatcherApp`` with ``federation.processes: 2`` — the PR-16 sharded
fan-in: each merge worker is a REAL spawned OS process owning a disjoint
upstream partition (hash(cluster), the same ``shard_of`` the ingest tier
keys by), shipping prepared deltas to the parent sequencer over a
length-prefixed msgpack pipe. Upstream names are chosen so the partition
actually splits (one upstream per worker). Then the drill:

1. **materialize** — both fleets appear in the federator's merged
   ``/serve/fleet`` under cluster-prefixed keys, fed entirely through
   worker pipes;
2. **gapless global consumption** — a resume-protocol consumer
   (``federate.client.ResumeLoop``) follows the GLOBAL view through
   churn on both clusters with zero gaps/dups (the parent sequencer's
   dense-rv contract);
3. **merge-worker SIGKILL** — one worker is killed -9 mid-churn. The
   supervisor must respawn it, the respawn must RESUME from the
   per-upstream token files (hello carries ``resumed``), and the global
   consumer must stay gapless with ZERO resyncs — the parent's rv line
   never flinches (kill-window deltas are replayed by the resumed
   subscriber and deduped by the sequencer's per-cluster watermark,
   never double-applied);
4. **dark upstream through the pipe** — upstream A is STOPPED; the
   federator's /healthz must degrade on the WORKER's verdict
   (``staleness_owner: merge-workers`` — the parent only mirrors;
   the per-upstream detail carries ``mirrored: true``) while liveness
   stays 200 and cluster-D churn keeps flowing; a restarted upstream A
   on the same directories and port recovers healthz;
5. **converge** — merged terminal state equals the union of both
   upstream snapshots; the consumer's replayed model equals the
   federator's final snapshot; ``fanin_passthrough_frames`` > 0 (raw
   upstream frames crossed worker decode -> prefix rewrite -> pipe ->
   global view without a re-encode) and the workers report zero pipe
   sequence gaps.

The port's twin of the JAX package's ``scripts/fanin_smoke.py``, with the
same stages and named checks; every app's analytics run on ``--device``
(default ``cuda:0``, raising without CUDA; ``cpu`` for tests):

    python -m k8s_watcher_tpu_torch.fanin_smoke [--device cpu] [--out F]

Artifact: ``artifacts/fanin_smoke_gpu.json`` (``--out``). Exit 0 on PASS.

The merge THROUGHPUT gate (drain rate across 16 upstreams / 4 workers,
plus the sharded-vs-single-process A/B byte-identity leg) is
bench-smoke's ``bench_fanin_sharded``; this script gates supervision,
resume, and staleness-ownership correctness over real processes through
the real app wiring.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import signal
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
TOKEN = "fanin-smoke-token"
DEADLINE_S = 90.0
STALE_AFTER_S = 3.0
AUTH = {"Authorization": f"Bearer {TOKEN}"}
# hash(cluster) partition: "cluster-a" -> worker 1, "cluster-d" ->
# worker 0 under processes=2 (names chosen so BOTH workers own work;
# fanin_plans drops ownerless workers, which would thin the drill)
UP_A, UP_D = "cluster-a", "cluster-d"

#: the named checks the artifact carries (the JAX package's drill's own)
CHECKS = (
    "upstreams_materialized",
    "global_view_materialized",
    "both_workers_spawned",
    "staleness_owner_is_merge_workers",
    "worker_respawned_resumed",
    "upstream_kill_clean",
    "healthz_degrades_on_dark_upstream",
    "staleness_verdict_mirrored_from_worker",
    "healthz_recovers_after_restart",
    "global_consumer_gapless",
    "merged_equals_union_of_upstreams",
    "raw_passthrough_on_fanin_wire",
    "pipe_sequence_gapless",
)


def _upstream_config(tmp: Path, name: str, server_url: str, serve_port: int, status_port: int):
    """One upstream cluster's watcher: mock apiserver + serve plane on a
    FIXED port (the merge workers' configured target must survive the
    dark-upstream restart leg) + history WAL."""
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
    """The federator under test: ``federation.processes: 2`` swaps the
    in-process subscriber fleet for spawned merge workers; history is
    enabled so the per-upstream resume tokens live under the WAL dir
    (the worker-kill leg resumes from them)."""
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
            processes=2,
            upstreams=tuple(upstreams),
            stale_after_seconds=STALE_AFTER_S,
            resync_backoff_seconds=0.2,
            drop_stale=False,
        ),
        history=dataclasses.replace(
            config.history, enabled=True, dir=str(tmp / "federator-history"),
            fsync="interval", fsync_interval_seconds=0.2,
            segment_max_bytes=64 * 1024, retain_segments=16,
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

    with tempfile.TemporaryDirectory(prefix="fanin-smoke-") as tmp_str, \
            MockApiServer() as server_a, MockApiServer() as server_d:
        tmp = Path(tmp_str)
        for server, prefix in ((server_a, "a"), (server_d, "d")):
            for i in range(N_PODS):
                server.cluster.add_pod(build_pod(
                    f"{prefix}-pod-{i}", "default", uid=f"{prefix}-uid-{i}",
                    phase="Pending", tpu_chips=4,
                ))
        port_a, port_d = free_port(), free_port()
        status_a, status_d, status_f = free_port(), free_port(), free_port()

        cfg_a = _upstream_config(tmp, "a", server_a.url, port_a, status_a)
        cfg_d = _upstream_config(tmp, "d", server_d.url, port_d, status_d)
        app_a, thread_a = _start_app(device, cfg_a)
        app_d, thread_d = _start_app(device, cfg_d)
        federator = fed_thread = None
        try:
            _wait_upstream(port_a, N_PODS, DEADLINE_S)
            _wait_upstream(port_d, N_PODS, DEADLINE_S)
            checks["upstreams_materialized"] = True

            federator, fed_thread = _start_app(device, _federator_config(
                tmp,
                [
                    FederationUpstream(url=f"http://127.0.0.1:{port_a}", name=UP_A, token=TOKEN),
                    FederationUpstream(url=f"http://127.0.0.1:{port_d}", name=UP_D, token=TOKEN),
                ],
                server_a.url,
                status_f,
            ))
            # global view materializes both fleets — through worker pipes
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

            # both workers spawned, each owning its partition slice
            fanin = federator.federation.fanin
            pids = [p for p in fanin.worker_pids() if p]
            checks["both_workers_spawned"] = len(pids) == 2
            _, body = _healthz(status_f)
            checks["staleness_owner_is_merge_workers"] = (
                body.get("federation", {}).get("staleness_owner") == "merge-workers"
            )

            consumer = ResumeLoop(FleetClient(fed_base, token=TOKEN))
            consumer.start()

            # phase 1: churn both clusters under the live global consumer
            churner_a = threading.Thread(target=_churn, args=(server_a, "a", 8), daemon=True)
            churner_d = threading.Thread(target=_churn, args=(server_d, "d", 8), daemon=True)
            churner_a.start()
            churner_d.start()
            while churner_a.is_alive() or churner_d.is_alive():
                consumer.poll(timeout=0.5)
            churner_a.join()
            churner_d.join()

            # phase 2: SIGKILL one merge worker mid-churn; the supervisor
            # respawns it and the respawn RESUMES from per-upstream token
            # files — the global consumer must never see the episode
            stop_kill = threading.Event()
            churner_a2 = threading.Thread(
                target=_churn, args=(server_a, "a", 60, 1, stop_kill), daemon=True
            )
            churner_d2 = threading.Thread(
                target=_churn, args=(server_d, "d", 60, 1, stop_kill), daemon=True
            )
            churner_a2.start()
            churner_d2.start()
            time.sleep(0.3)
            os.kill(pids[0], signal.SIGKILL)
            respawned = resumed = False
            respawn_deadline = time.monotonic() + DEADLINE_S
            while time.monotonic() < respawn_deadline:
                consumer.poll(timeout=0.3)
                stats = fanin.worker_stats()
                if stats["respawns"] >= 1:
                    respawned = True
                    hellos = [h for h in stats["hellos"] if h]
                    resumed = any(h.get("resumed") for h in hellos)
                    if resumed:
                        break
            stop_kill.set()
            churner_a2.join()
            churner_d2.join()
            checks["worker_respawned_resumed"] = respawned and resumed
            result["worker_stats_after_kill"] = fanin.worker_stats()

            # phase 3: dark upstream THROUGH THE PIPE — the kill verdict
            # is computed by the surviving worker and only mirrored by
            # the parent (mirrored: true); liveness stays 200 while
            # cluster-D churn keeps flowing
            stop_d = threading.Event()
            churner_d3 = threading.Thread(
                target=_churn, args=(server_d, "d", 400, 0, stop_d), daemon=True
            )
            churner_d3.start()
            app_a.stop()
            thread_a.join(timeout=15)
            checks["upstream_kill_clean"] = not thread_a.is_alive()

            degraded = mirrored = False
            liveness_stayed_up = True
            degrade_deadline = time.monotonic() + STALE_AFTER_S * 10
            while time.monotonic() < degrade_deadline:
                consumer.poll(timeout=0.3)
                code, body = _healthz(status_f)
                liveness_stayed_up &= code == 200
                fed_health = body.get("federation", {})
                if fed_health.get("healthy") is False:
                    up = fed_health.get("upstreams", {}).get(UP_A, {})
                    degraded = up.get("stale") is True
                    mirrored = up.get("mirrored") is True
                    if degraded:
                        break
            checks["healthz_degrades_on_dark_upstream"] = degraded and liveness_stayed_up
            checks["staleness_verdict_mirrored_from_worker"] = mirrored

            # restart upstream A on the same dirs + port; the worker's
            # subscriber resumes and healthz recovers
            app_a, thread_a = _start_app(device, _upstream_config(tmp, "a", server_a.url, port_a, free_port()))
            _wait_upstream(port_a, N_PODS, DEADLINE_S)
            churner_a3 = threading.Thread(target=_churn, args=(server_a, "a", 8, 1), daemon=True)
            churner_a3.start()
            recovered = False
            recover_deadline = time.monotonic() + DEADLINE_S
            while time.monotonic() < recover_deadline:
                consumer.poll(timeout=0.3)
                _, body = _healthz(status_f)
                if body.get("federation", {}).get("healthy") is True:
                    recovered = True
                    break
            churner_a3.join()
            stop_d.set()
            churner_d3.join()
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

            # converge: merged state == union of upstream snapshots
            def union_matches() -> bool:
                return merged_equals_union(
                    FleetClient(fed_base, token=TOKEN).snapshot().objects,
                    {
                        name: FleetClient(f"http://127.0.0.1:{port}", token=TOKEN).snapshot().objects
                        for name, port in ((UP_A, port_a), (UP_D, port_d))
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

            # the encode-once invariant crossed the process boundary:
            # workers rewrote raw upstream frames in place and the
            # sequencer spliced them into the global view — counted, and
            # the pipe sequence line never gapped
            stats = fanin.worker_stats()
            metrics = http_get(
                f"http://127.0.0.1:{status_f}/metrics", headers=AUTH, timeout=5
            ).json()
            checks["raw_passthrough_on_fanin_wire"] = (
                stats["passthrough"] > 0
                and metrics.get("fanin_passthrough_frames", {}).get("count", 0) > 0
            )
            checks["pipe_sequence_gapless"] = stats["wire_gaps"] == 0
            result["worker_stats"] = stats
            result["metrics"] = {
                k: v for k, v in metrics.items()
                if k.startswith(("federation", "fanin"))
            }
        finally:
            for app, thread in ((federator, fed_thread), (app_a, thread_a), (app_d, thread_d)):
                if app is not None:
                    app.stop()
                    thread.join(timeout=15)
    result["ok"] = bool(checks) and all(checks.values())
    return result


def main(argv: Optional[List[str]] = None) -> int:
    args = smoke_args(__doc__.splitlines()[0], "fanin_smoke", argv)
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
