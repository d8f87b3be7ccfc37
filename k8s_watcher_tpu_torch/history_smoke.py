"""History-plane smoke: restart-surviving resume + time travel + replay,
end to end through the REAL app wiring (the port's twin of ``make history-smoke``).

Boots the in-repo mock apiserver, points a ``WatcherApp`` at it with
``serve.enabled`` + ``history.enabled``, and drives the durable-history
contract across a REAL process-lifecycle boundary:

1. **capture** — churn pod phases while a consumer long-polls resumable
   deltas (gap/dup-checked, model replayed), leaving a resume token
   ``T`` + view instance id ``V`` and a WAL capture on disk;
2. **SIGTERM** — stop the app (the exact code path cli.py routes
   SIGTERM to), which drains the WAL and writes the terminal snapshot
   anchor;
3. **restart** — a brand-new ``WatcherApp`` on the same directories
   recovers the view from the WAL: same instance id, same monotonic rv
   line — and the consumer resumes from ``T`` (pre-restart!) with ZERO
   gaps, dups or 410s while fresh churn flows (the serve-smoke restart
   leg used to re-snapshot here; now it must not);
4. **time travel** — ``GET /serve/fleet?at=T`` against the RESTARTED
   process reconstructs the exact pre-restart snapshot the consumer's
   model had at ``T``;
5. **inventory** — ``/debug/history`` lists segments (bearer-gated like
   every debug route);
6. **replay** — after shutdown, two offline replays of the captured WAL
   reduce to byte-identical terminal snapshots whose object map equals
   the final live snapshot.

The port's twin of the JAX package's ``scripts/history_smoke.py``, with the
same stages and named checks; every app's analytics run on ``--device``
(default ``cuda:0``, raising without CUDA; ``cpu`` for tests):

    python -m k8s_watcher_tpu_torch.history_smoke [--device cpu] [--out F]

Artifact: ``artifacts/history_smoke_gpu.json`` (``--out``). Exit 0 on PASS.
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
from k8s_watcher_tpu_torch.federate import FleetClient, ResumeLoop, model_from_objects
from k8s_watcher_tpu_torch.history.replay import replay_digest
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
from k8s_watcher_tpu_torch.watch.fake import build_pod

N_PODS = 8
TOKEN = "history-smoke-token"
DEADLINE_S = 60.0
AUTH = {"Authorization": f"Bearer {TOKEN}"}

#: the named checks the artifact carries (the JAX package's drill's own)
CHECKS = (
    "capture_gapless",
    "first_shutdown_clean",
    "view_instance_survives_restart",
    "rv_line_continues",
    "resume_across_restart_gapless",
    "time_travel_matches_pre_restart_model",
    "time_travel_validates_rv",
    "debug_history_inventory",
    "second_shutdown_clean",
    "replay_byte_identical",
    "replay_reaches_final_rv",
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
        serve=dataclasses.replace(
            config.serve, enabled=True, port=0,
            queue_depth=64, compact_horizon=4096,
        ),
        history=dataclasses.replace(
            config.history, enabled=True, dir=str(tmp / "history"),
            fsync="interval", fsync_interval_seconds=0.2,
            segment_max_bytes=64 * 1024, retain_segments=16,
        ),
        state=dataclasses.replace(
            config.state, checkpoint_path=str(tmp / "checkpoint.json"),
            checkpoint_interval_seconds=0.5,
        ),
    )


def _churn(server, rounds: int, flip_offset: int = 0) -> None:
    phases = ("Running", "Pending")
    for r in range(rounds):
        for i in range(N_PODS):
            server.cluster.set_phase(
                "default", f"hist-pod-{i}", phases[(r + flip_offset) % 2]
            )
        time.sleep(0.05)


def _wait_materialized(app, deadline_s: float) -> str:
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if app.serve is not None and app.serve.port:
            base = f"http://127.0.0.1:{app.serve.port}"
            try:
                snap = http_get(f"{base}/serve/fleet", headers=AUTH, timeout=5).json()
                if len([o for o in snap.get("objects", []) if o.get("kind") == "pod"]) >= N_PODS:
                    return base
            except RequestError:
                pass
        time.sleep(0.2)
    raise RuntimeError("serving plane never materialized the fleet")


def run_smoke(device) -> dict:
    import tempfile

    result: dict = {
        "timestamp_utc": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "checks": {},
    }
    checks = result["checks"]
    with tempfile.TemporaryDirectory(prefix="history-smoke-") as tmp_str, MockApiServer() as server:
        tmp = Path(tmp_str)
        for i in range(N_PODS):
            server.cluster.add_pod(build_pod(
                f"hist-pod-{i}", "default", uid=f"uid-{i}",
                phase="Pending", tpu_chips=4,
            ))

        # ---- incarnation 1: capture --------------------------------------
        app = WatcherApp(_smoke_config(tmp, server.url, free_port()), device=device)
        thread = threading.Thread(target=app.run, daemon=True)
        thread.start()
        try:
            base = _wait_materialized(app, DEADLINE_S)
            # the shared resume-protocol consumer (federate/client.py):
            # long-poll loop + sequence checker + model replay — the one
            # implementation this smoke used to hand-roll
            consumer = ResumeLoop(FleetClient(base, token=TOKEN))
            consumer.start()
            view_id = consumer.view
            churner = threading.Thread(target=_churn, args=(server, 12), daemon=True)
            churner.start()
            while churner.is_alive() or consumer.polls == 0:
                consumer.poll(timeout=1.0)
            churner.join()
            consumer.drain(timeout=0.3)
            token = consumer.rv  # the resume token minted BEFORE "SIGTERM"
            model_at_token = dict(consumer.model)
            checks["capture_gapless"] = (
                consumer.checker.gaps == 0 and consumer.checker.dups == 0
                and consumer.checker.delivered > 0
            )
            result["capture"] = {
                "polls": consumer.polls, "delivered": consumer.checker.delivered,
                "gaps": consumer.checker.gaps, "dups": consumer.checker.dups,
                "resyncs": consumer.resyncs, "token": token, "view": view_id,
            }
        finally:
            # the SIGTERM leg: cli.py routes SIGTERM to app.stop(); the
            # run loop then drives the full shutdown (WAL drain, terminal
            # snapshot, fsync)
            app.stop()
            thread.join(timeout=15)
        checks["first_shutdown_clean"] = not thread.is_alive()

        # ---- incarnation 2: restart + resume -----------------------------
        status_port2 = free_port()
        app2 = WatcherApp(_smoke_config(tmp, server.url, status_port2), device=device)
        thread2 = threading.Thread(target=app2.run, daemon=True)
        thread2.start()
        try:
            base2 = _wait_materialized(app2, DEADLINE_S)
            snap2 = http_get(f"{base2}/serve/fleet", headers=AUTH, timeout=5).json()
            checks["view_instance_survives_restart"] = snap2["view"] == view_id
            checks["rv_line_continues"] = snap2["rv"] >= token
            result["restart"] = {"view": snap2["view"], "rv": snap2["rv"]}

            # resume with the PRE-RESTART token against the new process:
            # fresh churn flows and the sequence checker must see zero
            # gaps/dups — and zero 410s (that re-snapshot storm is the
            # failure mode this plane exists to kill)
            consumer.client.retarget(base2)
            churner2 = threading.Thread(target=_churn, args=(server, 12, 1), daemon=True)
            churner2.start()
            resumed_polls_ok = True
            while churner2.is_alive():
                resumed_polls_ok &= consumer.poll(timeout=1.0)
            churner2.join()
            consumer.drain(timeout=0.3)
            final = consumer.client.snapshot()
            truth = model_from_objects(final.objects)
            checks["resume_across_restart_gapless"] = (
                resumed_polls_ok
                and consumer.checker.gaps == 0 and consumer.checker.dups == 0
                and consumer.resyncs == 0
                and consumer.model == truth
            )
            result["resume"] = {
                "polls": consumer.polls, "delivered": consumer.checker.delivered,
                "gaps": consumer.checker.gaps, "dups": consumer.checker.dups,
                "resyncs": consumer.resyncs, "final_rv": consumer.rv,
                "model_matches_snapshot": consumer.model == truth,
            }

            # time travel: the RESTARTED process reconstructs the exact
            # snapshot the consumer's model held at the pre-restart token
            at = http_get(
                f"{base2}/serve/fleet", params={"at": token}, headers=AUTH, timeout=10,
            )
            at_body = at.json() if at.status_code == 200 else {}
            at_model = model_from_objects(at_body.get("objects", []))
            checks["time_travel_matches_pre_restart_model"] = (
                at.status_code == 200
                and at_body.get("historical") is True
                and at_model == model_at_token
            )
            result["time_travel"] = {
                "status": at.status_code, "at": token,
                "objects": len(at_model), "matches": at_model == model_at_token,
            }

            # a pre-retention rv answers 410 (not wrong data)
            gone = http_get(
                f"{base2}/serve/fleet", params={"at": -1}, headers=AUTH, timeout=10,
            )
            checks["time_travel_validates_rv"] = gone.status_code == 400

            # /debug/history: bearer-gated segment inventory
            inv = http_get(
                f"http://127.0.0.1:{status_port2}/debug/history", headers=AUTH, timeout=5,
            )
            inv_open = http_get(
                f"http://127.0.0.1:{status_port2}/debug/history", timeout=5,
            )
            history = inv.json().get("history", {}) if inv.status_code == 200 else {}
            checks["debug_history_inventory"] = (
                inv.status_code == 200
                and inv_open.status_code == 401
                and bool(history.get("segments"))
                and history.get("writer_alive") is True
            )
            result["inventory"] = {
                "segments": len(history.get("segments", [])),
                "total_bytes": history.get("total_bytes"),
                "durable_rv": history.get("durable_rv"),
                "retention_floor_rv": history.get("retention_floor_rv"),
            }
            final_rv = final.rv
        finally:
            app2.stop()
            thread2.join(timeout=15)
        checks["second_shutdown_clean"] = not thread2.is_alive()

        # ---- offline: deterministic replay byte-compare ------------------
        wal_dir = tmp / "history"
        d1 = replay_digest(wal_dir)
        d2 = replay_digest(wal_dir)
        checks["replay_byte_identical"] = (
            d1 == d2 and d1["sha256"] == d2["sha256"] and d1["rv_mismatches"] == 0
        )
        checks["replay_reaches_final_rv"] = d1["rv"] == final_rv
        result["replay"] = {
            "sha256": d1["sha256"], "rv": d1["rv"],
            "deltas_applied": d1["deltas_applied"],
            "snapshots_seen": d1["snapshots_seen"],
            "segments": d1["segments"], "rv_mismatches": d1["rv_mismatches"],
        }
    result["ok"] = bool(checks) and all(checks.values())
    return result


def main(argv: Optional[List[str]] = None) -> int:
    args = smoke_args(__doc__.splitlines()[0], "history_smoke", argv)
    result = run_smoke(args.device)
    out = write_artifact(result, args.out)
    checks = checks_line(result["checks"])
    print(f"{'PASS' if result['ok'] else 'FAIL'}: {checks}")
    resume = result.get("resume") or {}
    if resume:
        print(
            "resume across restart: %d polls, %d deltas, gaps=%d dups=%d resyncs=%d final_rv=%s"
            % (resume["polls"], resume["delivered"], resume["gaps"],
               resume["dups"], resume["resyncs"], resume["final_rv"])
        )
    print(f"artifact: {out}")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
