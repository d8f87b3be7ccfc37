"""Serving-plane smoke: the full mock cluster, end to end, through the
REAL app wiring (the port's twin of ``make serve-smoke``).

Boots the in-repo mock apiserver (doubling as the clusterapi notify
target), points a ``WatcherApp`` at it with ``serve.enabled`` and a
bearer token, churns pod phases, and drives real HTTP consumers —
built on the ONE serve-protocol implementation, ``federate/client.py``
(``FleetClient`` + ``ResumeLoop`` + ``SequenceChecker``) — through every
leg of the subscription protocol:

1. **snapshot** — ``GET /serve/fleet`` answers ``{rv, objects}`` with
   the churned pods materialized;
2. **resumable deltas** — a long-poll resume loop across SEPARATE
   connections: raw ranges must be dense (the rv space has no gaps),
   rvs strictly ascending (no dups), and the replayed model must equal
   a final snapshot;
3. **streaming watch** — one chunked ``?watch=1`` window decodes SYNC
   + UPSERT frames and closes with a final SYNC resume token;
4. **410 resync** — a resume token left behind the compaction horizon
   (the config shrinks it to force this) raises ``ResyncRequired``, a
   token echoing a stale ``view`` instance id (a "previous incarnation"
   of the rv space) does too, and the documented recovery (re-snapshot,
   watch from its rv) works;
5. **auth** — /serve routes raise ``AuthRejected`` without the bearer
   token while /serve/healthz stays open, and the status server's
   /healthz folds the serving plane's verdict in;
6. **encode-once plumbing** — the broadcast data plane's metrics are
   live after the legs above: frames were encoded (once per delta, at
   publish), fan-out bytes moved through the event loop, and
   back-to-back snapshots hit the rv-keyed byte cache.

The port's twin of the JAX package's ``scripts/serve_smoke.py``, with the
same stages and named checks; every app's analytics run on ``--device``
(default ``cuda:0``, raising without CUDA; ``cpu`` for tests):

    python -m k8s_watcher_tpu_torch.serve_smoke [--device cpu] [--out F]

Artifact: ``artifacts/serve_smoke_gpu.json`` (``--out``). Exit 0 on PASS.

The 5k-subscriber fan-out scale is gated separately by ``bench.py
--smoke`` (bench_serve_fanout, in-process); this script gates the
PROTOCOL over real HTTP through the real app.
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
    AuthRejected,
    FleetClient,
    ResumeLoop,
    ResyncRequired,
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

N_PODS = 8
TOKEN = "serve-smoke-token"
COMPACT_HORIZON = 64  # small on purpose: the 410 leg needs expiry fast
DEADLINE_S = 45.0
AUTH = {"Authorization": f"Bearer {TOKEN}"}

#: the named checks the artifact carries (the JAX package's drill's own)
CHECKS = (
    "snapshot_served",
    "codec_negotiated",
    "resume_loop_gapless",
    "stream_watch",
    "gone_resync",
    "auth_enforced",
    "healthz_folds_serve",
    "encode_once_metrics",
    "io_loop_healthy",
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
            config.watcher, status_port=status_port,
            # the bearer contract under test: /serve must not be an
            # unauthenticated side door (satellite #3)
            status_auth_token=TOKEN,
        ),
        serve=dataclasses.replace(
            config.serve, enabled=True, port=0,
            queue_depth=32, compact_horizon=COMPACT_HORIZON,
        ),
    )


def _churn(server, rounds: int, flip_offset: int = 0) -> None:
    """Flip every pod's phase ``rounds`` times (each flip is one delta)."""
    phases = ("Running", "Pending")
    for r in range(rounds):
        for i in range(N_PODS):
            server.cluster.set_phase(
                "default", f"serve-pod-{i}", phases[(r + flip_offset) % 2]
            )
        time.sleep(0.05)


def run_smoke(device) -> dict:
    import tempfile

    status_port = free_port()
    result: dict = {
        "timestamp_utc": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "compact_horizon": COMPACT_HORIZON,
        "checks": {},
    }
    checks = result["checks"]
    with tempfile.TemporaryDirectory(prefix="serve-smoke-") as tmp, MockApiServer() as server:
        for i in range(N_PODS):
            server.cluster.add_pod(build_pod(
                f"serve-pod-{i}", "default", uid=f"uid-{i}",
                phase="Pending", tpu_chips=4,
            ))
        app = WatcherApp(_smoke_config(Path(tmp), server.url, status_port), device=device)
        thread = threading.Thread(target=app.run, daemon=True)
        thread.start()
        try:
            # wait for the serving plane to bind + the relist to materialize
            deadline = time.monotonic() + DEADLINE_S
            client = None
            while time.monotonic() < deadline:
                if app.serve is not None and app.serve.port:
                    base = f"http://127.0.0.1:{app.serve.port}"
                    client = FleetClient(base, token=TOKEN)
                    try:
                        snap = client.snapshot()
                        if len(snap.objects) >= N_PODS:
                            break
                    except (OSError, ResyncRequired):
                        pass
                time.sleep(0.2)
            else:
                raise RuntimeError("serving plane never materialized the fleet")
            result["serve_port"] = app.serve.port

            # 1. snapshot
            snap = client.snapshot()
            pods = [o for o in snap.objects if o.get("kind") == "pod"]
            checks["snapshot_served"] = snap.rv > 0 and len(pods) == N_PODS
            result["snapshot"] = {"rv": snap.rv, "objects": len(snap.objects)}

            # 1b. codec negotiation: the default (auto) client negotiated
            # msgpack when available, and a JSON-pinned client decodes the
            # IDENTICAL snapshot — the codec changes wire bytes, never
            # content
            from k8s_watcher_tpu_torch.serve.view import msgpack_available

            json_client = FleetClient(base, token=TOKEN, codec="json")
            cross_codec_equal = False
            for _ in range(10):
                mp_snap = client.snapshot()
                json_snap = json_client.snapshot()
                if mp_snap.rv != json_snap.rv:
                    continue  # a delta landed between the two reads; retry
                cross_codec_equal = model_from_objects(
                    mp_snap.objects
                ) == model_from_objects(json_snap.objects)
                break
            expected_codec = "msgpack" if msgpack_available() else "json"
            checks["codec_negotiated"] = (
                client.active_codec == expected_codec
                and json_client.active_codec == "json"
                and cross_codec_equal
            )
            result["codecs"] = {
                "default_client": client.active_codec,
                "json_client": json_client.active_codec,
            }

            # 2. resumable delta long-poll loop across separate connections
            # — the shared ResumeLoop (carrying the snapshot's view
            # instance id and sequence-checking every batch, exactly what
            # the federation plane's consumers run)
            consumer = ResumeLoop(client)
            consumer.start()
            churner = threading.Thread(target=_churn, args=(server, 12), daemon=True)
            churner.start()
            while churner.is_alive() or consumer.polls == 0:
                consumer.poll(timeout=1.0)
            churner.join()
            consumer.drain(polls=20, timeout=0.3)
            truth = model_from_objects(client.snapshot().objects)
            checker = consumer.checker
            checks["resume_loop_gapless"] = (
                checker.gaps == 0 and checker.dups == 0
                and checker.delivered > 0 and consumer.model == truth
            )
            result["resume_loop"] = {
                "polls": consumer.polls, "delivered": checker.delivered,
                "gaps": checker.gaps, "dups": checker.dups,
                "resyncs": consumer.resyncs, "final_rv": consumer.rv,
                "model_matches_snapshot": consumer.model == truth,
            }

            # 3. one chunked streaming-watch window, decoded by the shared
            # client (open the stream — first frame is the opening SYNC —
            # before churning into it)
            stream = client.watch(consumer.rv, view=consumer.view, window_seconds=2)
            frames = [next(stream)]
            streamer = threading.Thread(target=_churn, args=(server, 4, 1), daemon=True)
            streamer.start()
            frames.extend(stream)
            streamer.join()
            types = [f["type"] for f in frames]
            checks["stream_watch"] = (
                bool(types) and types[0] == "SYNC" and "UPSERT" in types
                and types[-1] == "SYNC"
            )
            result["stream"] = {"frames": len(frames), "types": sorted(set(types))}

            # 4. 410 on an expired token, then the documented resync
            _churn(server, 12)  # > compact_horizon deltas: rv 1 expires
            gone_410 = False
            oldest_rv = None
            try:
                client.long_poll(1, timeout=1.0)
            except ResyncRequired as exc:
                gone_410 = True
                oldest_rv = exc.body.get("oldest_rv")
            resnap = client.snapshot()
            recovered_ok = False
            try:
                client.long_poll(resnap.rv, timeout=0.2)
                recovered_ok = True
            except ResyncRequired:
                pass
            # a token minted by a "previous incarnation" (stale view id)
            # must 410 the same way — never graft onto the new rv space
            stale_410 = False
            try:
                client.long_poll(resnap.rv, view="0" * 12, timeout=0.2)
            except ResyncRequired:
                stale_410 = True
            checks["gone_resync"] = gone_410 and stale_410 and recovered_ok
            result["gone"] = {
                "gone_410": gone_410,
                "stale_epoch_410": stale_410,
                "oldest_rv": oldest_rv,
                "resnapshot_rv": resnap.rv,
            }

            # 5. auth posture + /healthz folding
            auth_rejected = False
            try:
                FleetClient(client.base_url).snapshot()  # no token
            except AuthRejected:
                auth_rejected = True
            checks["auth_enforced"] = (
                auth_rejected
                and client.healthz().get("healthy") is True
            )
            healthz = http_get(
                f"http://127.0.0.1:{status_port}/healthz", timeout=5
            ).json()
            checks["healthz_folds_serve"] = (
                healthz.get("serve", {}).get("healthy") is True
                and healthz["serve"]["subscribers"] == 0
            )
            result["healthz_serve"] = healthz.get("serve")

            # 6. encode-once plumbing: frames encoded at publish, bytes
            # fanned out by the event loop, snapshot byte cache hitting
            # (two back-to-back snapshots with no churn = a guaranteed
            # same-rv second read)
            client.snapshot()
            client.snapshot()
            metrics = http_get(
                f"http://127.0.0.1:{status_port}/metrics", headers=AUTH, timeout=5
            ).json()
            checks["encode_once_metrics"] = (
                metrics.get("serve_frame_encodes", {}).get("count", 0) > 0
                and metrics.get("serve_fanout_bytes", {}).get("count", 0) > 0
                and metrics.get("serve_snapshot_cache_hits", {}).get("count", 0) > 0
                and metrics.get("serve_encode_seconds", {}).get("count", 0) > 0
            )
            result["encode_once"] = {
                k: metrics.get(k, {}).get("count")
                for k in (
                    "serve_frame_encodes", "serve_fanout_bytes",
                    "serve_snapshot_cache_hits", "serve_snapshot_cache_misses",
                )
            }
            io_loop = healthz.get("serve", {}).get("io_loop")
            checks["io_loop_healthy"] = bool(io_loop) and io_loop.get("healthy") is True
            result["io_loop"] = io_loop
        finally:
            app.stop()
            thread.join(timeout=10)
    result["ok"] = bool(checks) and all(checks.values())
    return result


def main(argv: Optional[List[str]] = None) -> int:
    args = smoke_args(__doc__.splitlines()[0], "serve_smoke", argv)
    result = run_smoke(args.device)
    out = write_artifact(result, args.out)
    checks = checks_line(result["checks"])
    print(f"{'PASS' if result['ok'] else 'FAIL'}: {checks}")
    loop = result.get("resume_loop") or {}
    if loop:
        print(
            "resume loop: %d polls, %d deltas, gaps=%d dups=%d, final_rv=%d"
            % (loop["polls"], loop["delivered"], loop["gaps"], loop["dups"], loop["final_rv"])
        )
    print(f"artifact: {out}")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
