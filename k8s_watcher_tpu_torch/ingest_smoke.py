"""Multi-process ingest smoke: the procpool tier end to end, through the
REAL app wiring, across a worker-process KILL (the port's twin of ``make ingest-smoke``).

Boots the in-repo mock apiserver, points a ``WatcherApp`` at it with
``ingest.shards: 2 / ingest.processes: 2`` (two REAL spawned shard-reader
processes, each owning its watch stream, prefilter, and per-shard rv
checkpoint file) plus the serving plane, then:

1. **materialize** — the workers relist/watch the cluster over real HTTP
   and the parent's FleetView materializes every TPU pod (non-TPU pods
   prove the prefilter: their frames are skipped pre-parse in the worker
   and counted, never decoded);
2. **churn ramp** — phase-flip churn at increasing rates while a
   sequence-checked consumer (the shared ``federate.client`` SequenceChecker
   — the same accountant every other smoke trusts) follows the serve
   plane's dense rv line;
3. **mid-run SIGKILL** — one shard-reader process is killed -9 mid-churn.
   The supervisor must respawn it, the respawned worker must RESUME from
   its per-shard checkpoint (hello carries ``resumed_shards``), and the
   consumer must stay gapless through the whole episode (0 gaps/dups, 0
   resyncs — the parent's rv line never even flinches);
4. **terminal truth** — after the ramp the consumer's replayed model must
   equal a fresh snapshot, and every TPU pod's phase in the view must
   equal the mock cluster's (kill-window events were REPLAYED, not
   skipped: the drain loop only commits rvs that reached the pipe);
5. **drain** — SIGTERM-shape shutdown leaves no worker process behind.

The port's twin of the JAX package's ``scripts/ingest_smoke.py``, with the
same stages and named checks; every app's analytics run on ``--device``
(default ``cuda:0``, raising without CUDA; ``cpu`` for tests):

    python -m k8s_watcher_tpu_torch.ingest_smoke [--device cpu] [--out F]

Artifact: ``artifacts/ingest_smoke_gpu.json`` (``--out``). Exit 0 on PASS.

The >=100k ev/s multi-process THROUGHPUT gate runs in ``bench --smoke``
(bench_ingest_procs); this script gates supervision + resume correctness
over real HTTP through the real app.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
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
    ResyncRequired,
    model_from_objects,
)
from k8s_watcher_tpu_torch.k8s.mock_server import MockApiServer
from k8s_watcher_tpu_torch.smoke_common import (
    REPO,
    http_get,
    smoke_args,
    write_artifact,
    write_kubeconfig,
)
from k8s_watcher_tpu_torch.watch.fake import build_pod

N_TPU_PODS = 8
N_PLAIN_PODS = 24  # prefilter fodder: frames the workers must skip unparsed
TOKEN = "ingest-smoke-token"
DEADLINE_S = 90.0
RAMP = (40, 80, 160)  # phase flips per stage — the churn ramp

#: the named checks the artifact carries (the JAX package's drill's own)
CHECKS = (
    "workers_up",
    "worker_respawned",
    "respawn_resumed_from_checkpoint",
    "per_shard_checkpoints_exist",
    "consumer_gapless_through_kill",
    "terminal_view_matches_cluster",
    "prefilter_counted_skips",
    "zero_wire_gaps",
    "workers_drained_on_shutdown",
)


def _smoke_config(tmp: Path, server_url: str):
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
            config.watcher, status_port=0, status_auth_token=TOKEN,
        ),
        serve=dataclasses.replace(config.serve, enabled=True, port=0),
        state=dataclasses.replace(
            config.state,
            checkpoint_path=str(tmp / "checkpoint.json"),
            # fast rv durability so the killed worker's resume point is
            # recent — production uses seconds; the contract is identical
            checkpoint_interval_seconds=0.2,
        ),
        ingest=dataclasses.replace(
            config.ingest, shards=2, processes=2, prefilter="auto",
        ),
    )


def _flip(server, rounds: int, offset: int = 0, delay: float = 0.05) -> None:
    phases = ("Running", "Pending")
    for r in range(rounds):
        for i in range(N_TPU_PODS):
            server.cluster.set_phase(
                "default", f"ing-tpu-{i}", phases[(r + offset) % 2]
            )
        # non-TPU churn rides the same watch stream and must be skipped
        # pre-parse by the workers (events_prefiltered keeps counting)
        for i in range(0, N_PLAIN_PODS, 4):
            server.cluster.set_phase(
                "default", f"ing-plain-{i}", phases[(r + offset) % 2]
            )
        time.sleep(delay)


def run_smoke(device) -> dict:
    import tempfile

    result: dict = {
        "timestamp_utc": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "processes": 2,
        "shards": 2,
        "checks": {},
    }
    checks = result["checks"]
    with tempfile.TemporaryDirectory(prefix="ingest-smoke-") as tmp, MockApiServer() as server:
        for i in range(N_TPU_PODS):
            server.cluster.add_pod(build_pod(
                f"ing-tpu-{i}", "default", uid=f"ing-tpu-uid-{i}",
                phase="Pending", tpu_chips=4,
            ))
        for i in range(N_PLAIN_PODS):
            server.cluster.add_pod(build_pod(
                f"ing-plain-{i}", "default", uid=f"ing-plain-uid-{i}",
                phase="Running",
            ))
        app = WatcherApp(_smoke_config(Path(tmp), server.url), device=device)
        thread = threading.Thread(target=app.run, daemon=True)
        thread.start()
        try:
            from k8s_watcher_tpu_torch.watch.procpool import ProcessShardedWatchSource

            if not isinstance(app.ingest, ProcessShardedWatchSource):
                raise RuntimeError("ingest.processes: 2 must build the procpool source")

            # 1. materialize: both workers up, every TPU pod in the view
            deadline = time.monotonic() + DEADLINE_S
            client = None
            while time.monotonic() < deadline:
                if app.serve is not None and app.serve.port:
                    base = f"http://127.0.0.1:{app.serve.port}"
                    client = FleetClient(base, token=TOKEN)
                    try:
                        snap = client.snapshot()
                        pods = [o for o in snap.objects if o.get("kind") == "pod"]
                        if len(pods) >= N_TPU_PODS and all(
                            p is not None for p in app.ingest.worker_pids()
                        ):
                            break
                    except (OSError, ResyncRequired):
                        pass
                time.sleep(0.2)
            else:
                raise RuntimeError("procpool ingest never materialized the fleet")
            stats = app.ingest.worker_stats()
            checks["workers_up"] = (
                len([p for p in app.ingest.worker_pids() if p]) == 2
                and stats["events_delivered"] >= N_TPU_PODS
            )
            result["initial_stats"] = {
                k: v for k, v in stats.items() if k != "hellos"
            }

            # 2. churn ramp stage 1 under a sequence-checked consumer
            consumer = ResumeLoop(client)
            consumer.start()
            flipper = threading.Thread(
                target=_flip, args=(server, RAMP[0]), daemon=True
            )
            flipper.start()
            while flipper.is_alive() or consumer.polls == 0:
                consumer.poll(timeout=1.0)
            flipper.join()

            # 3. SIGKILL one shard-reader mid-churn, keep churning
            victim_pid = app.ingest.worker_pids()[0]
            flipper = threading.Thread(
                target=_flip, args=(server, RAMP[1], 1, 0.03), daemon=True
            )
            flipper.start()
            os.kill(victim_pid, signal.SIGKILL)
            while flipper.is_alive():
                consumer.poll(timeout=0.5)
            flipper.join()
            # respawn must have happened and the new incarnation must have
            # RESUMED from its per-shard checkpoint file
            respawned = False
            resumed_shards = []
            respawn_deadline = time.monotonic() + 30.0
            while time.monotonic() < respawn_deadline:
                consumer.poll(timeout=0.2)
                stats = app.ingest.worker_stats()
                new_pid = app.ingest.worker_pids()[0]
                hello = stats["hellos"][0] or {}
                if (
                    stats["respawns"] >= 1
                    and new_pid is not None
                    and new_pid != victim_pid
                    and hello.get("resumed_shards")
                ):
                    respawned = True
                    resumed_shards = hello["resumed_shards"]
                    break
            checks["worker_respawned"] = respawned
            checks["respawn_resumed_from_checkpoint"] = bool(resumed_shards)
            result["kill"] = {
                "victim_pid": victim_pid,
                "new_pid": app.ingest.worker_pids()[0],
                "respawns": stats["respawns"],
                "resumed_shards": resumed_shards,
            }
            shard_files = sorted(
                os.listdir(Path(tmp) / "checkpoint.json.ingest-shards")
            )
            result["checkpoint_files"] = shard_files
            checks["per_shard_checkpoints_exist"] = any(
                f.startswith("shard-0-of-2") for f in shard_files
            ) and any(f.startswith("shard-1-of-2") for f in shard_files)

            # 4. ramp stage 3 through the RESPAWNED worker, then terminal
            # truth: consumer model == snapshot == mock cluster phases
            _flip(server, RAMP[2], 0, 0.02)
            settle_deadline = time.monotonic() + 30.0
            truth = {}
            converged = False
            while time.monotonic() < settle_deadline:
                consumer.poll(timeout=0.3)
                consumer.drain(polls=5, timeout=0.2)
                snap = client.snapshot()
                truth = model_from_objects(snap.objects)
                view_pods = {
                    k[1]: o for k, o in truth.items()
                    if k[0] == "pod" and o.get("name", "").startswith("ing-tpu-")
                }
                # cluster truth read over the mock's PUBLIC apiserver
                # surface, not its internals
                listed = http_get(
                    f"{server.url}/api/v1/pods", timeout=5.0
                ).json().get("items", [])
                expected = {
                    (p.get("metadata") or {}).get("name"): (p.get("status") or {}).get("phase")
                    for p in listed
                    if (p.get("metadata") or {}).get("name", "").startswith("ing-tpu-")
                }
                live = {o.get("name"): o.get("phase") for o in view_pods.values()}
                if (
                    consumer.model == truth
                    and len(view_pods) == N_TPU_PODS
                    and all(live.get(n) == p for n, p in expected.items())
                ):
                    converged = True
                    break
            checker = consumer.checker
            checks["consumer_gapless_through_kill"] = (
                checker.gaps == 0 and checker.dups == 0
                and consumer.resyncs == 0 and checker.delivered > 0
            )
            checks["terminal_view_matches_cluster"] = converged
            result["consumer"] = {
                "polls": consumer.polls, "delivered": checker.delivered,
                "gaps": checker.gaps, "dups": checker.dups,
                "resyncs": consumer.resyncs,
            }

            # 5. prefilter + wire accounting
            stats = app.ingest.worker_stats()
            result["final_stats"] = {k: v for k, v in stats.items() if k != "hellos"}
            checks["prefilter_counted_skips"] = (
                app.metrics.counter("events_prefiltered").value > 0
            )
            checks["zero_wire_gaps"] = stats["wire_gaps"] == 0
            # every live reader pid, captured BEFORE shutdown — checking
            # only the respawned worker would let the never-killed one
            # leak through this gate unnoticed
            worker_pids = [p for p in app.ingest.worker_pids() if p]
        finally:
            app.stop()
            app.shutdown()
        # 6. SIGTERM drain: no reader process survives shutdown
        time.sleep(1.0)
        leftovers = [
            pid
            for pid in {*worker_pids, result.get("kill", {}).get("new_pid")}
            if pid and Path(f"/proc/{pid}").exists()
        ]
        checks["workers_drained_on_shutdown"] = not leftovers

    result["ok"] = all(checks.values())
    return result


def main(argv: Optional[List[str]] = None) -> int:
    args = smoke_args(__doc__.splitlines()[0], "ingest_smoke", argv)
    result = run_smoke(args.device)
    out = write_artifact(result, args.out, indent=1)
    for name, ok in result["checks"].items():
        print(f"  {'PASS' if ok else 'FAIL'}  {name}")
    print(f"{'PASS' if result['ok'] else 'FAIL'}: ingest smoke -> {out}")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
