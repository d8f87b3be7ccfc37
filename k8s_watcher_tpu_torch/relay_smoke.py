"""Relay-tier smoke: root app → relay PROCESS → consumer, with a relay
restart under a live consumer (the port's twin of ``make relay-smoke``).

Boots ONE full mock-backed root ``WatcherApp`` (serve plane, bearer
token, real churn against its mock apiserver) and ONE relay ``WatcherApp``
as a real SUBPROCESS (``relay.enabled``, its FleetView mirroring the
root over the raw-bytes passthrough), then drives the relay contract end
to end:

1. **mirror** — the relay materializes the root fleet under the SAME
   view instance id and rv line (a snapshot at the relay equals the
   snapshot at the root);
2. **zero re-encode** — the relay's ``/serve/healthz`` relay fold
   reports ``frame_encodes == 0`` with ``frames_relayed`` covering the
   churn (the PR-7 encode-once invariant across processes);
3. **gapless consumption via the relay** — a sequence-checked long-poll
   consumer follows the fleet THROUGH the relay under churn with zero
   gaps/dups;
4. **relay restart** — the relay process is killed and a brand-new one
   starts on the same port; its backfill re-warms the journal below its
   fresh snapshot, so the consumer's held resume token keeps working:
   ZERO resyncs, zero gaps/dups through the restart, reconnects > 0;
5. **depth + token portability** — the relay reports depth 1, and the
   consumer's post-restart token is accepted by the ROOT directly (one
   rv line across the tree);
6. **converge** — the consumer's replayed model equals the root's
   terminal snapshot.

The port's twin of the JAX package's ``scripts/relay_smoke.py``, with the
same stages and named checks; every app's analytics run on ``--device``
(default ``cuda:0``, raising without CUDA; ``cpu`` for tests):

    python -m k8s_watcher_tpu_torch.relay_smoke [--device cpu] [--out F]

Artifact: ``artifacts/relay_smoke_gpu.json`` (``--out``). Exit 0 on PASS.

The ≥100k 2-level-tree SCALE gate is bench-smoke's ``bench_relay_tree``;
this script gates the protocol and the restart story over real process
lifecycles.
"""

from __future__ import annotations

import dataclasses
import datetime
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import List, Optional

from k8s_watcher_tpu_torch.app import WatcherApp
from k8s_watcher_tpu_torch.config import load_app_config
from k8s_watcher_tpu_torch.federate import (
    FleetClient,
    ResyncRequired,
    SequenceChecker,
    apply_wire_deltas,
    model_from_objects,
)
from k8s_watcher_tpu_torch.k8s.mock_server import MockApiServer
from k8s_watcher_tpu_torch.smoke_common import (
    REPO,
    checks_line,
    free_port,
    smoke_args,
    write_artifact,
    write_kubeconfig,
)
from k8s_watcher_tpu_torch.watch.fake import build_pod

N_PODS = 6
TOKEN = "relay-smoke-token"
DEADLINE_S = 60.0

#: the named checks the artifact carries (the JAX package's drill's own)
CHECKS = (
    "root_materialized",
    "relay_mirrors_root",
    "consumer_gapless_via_relay",
    "relay_zero_reencode",
    "relay_depth_stamped",
    "consumer_gapless_through_relay_restart",
    "token_valid_at_root",
    "consumer_model_matches_root",
    "restarted_relay_backfilled",
)


def _root_config(tmp: Path, server_url: str, serve_port: int, status_port: int):
    kc_path = tmp / "kubeconfig-root.json"
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
            # queue_depth sized for a RELAY subscriber: a relay catching
            # up after its restart must not have its backfill stream
            # lag-shed (compaction would — correctly — 410 any consumer
            # token older than the first surviving delta; RUNBOOK covers
            # the sizing rule)
            config.serve, enabled=True, port=serve_port,
            queue_depth=4096, compact_horizon=8192,
        ),
        state=dataclasses.replace(
            config.state, checkpoint_path=str(tmp / "checkpoint-root.json"),
            checkpoint_interval_seconds=0.5,
        ),
    )


def _spawn_relay(root_port: int, relay_port: int, device) -> subprocess.Popen:
    """The relay node as a REAL subprocess (its own interpreter, its own
    zero-re-encode counters): this module re-invoked with --relay-child,
    its analytics on the parent's device."""
    return subprocess.Popen(
        [sys.executable, "-m", "k8s_watcher_tpu_torch.relay_smoke", "--relay-child",
         str(root_port), str(relay_port), str(device)],
        cwd=str(REPO),
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
    )


def _relay_child(root_port: int, relay_port: int, device: str) -> int:
    """Subprocess body: a full WatcherApp in relay mode (fake local
    ingest — a relay's pipeline stays detached from the mirrored view)."""
    from k8s_watcher_tpu_torch.config import FederationUpstream

    config = load_app_config("development", str(REPO / "config"), env={})
    config = dataclasses.replace(
        config,
        kubernetes=dataclasses.replace(config.kubernetes, use_mock=True),
        clusterapi=dataclasses.replace(
            config.clusterapi, base_url=f"http://127.0.0.1:{root_port}"
        ),
        watcher=dataclasses.replace(config.watcher, status_port=0),
        serve=dataclasses.replace(
            config.serve, enabled=True, port=relay_port,
            queue_depth=128, compact_horizon=8192,
        ),
        relay=dataclasses.replace(
            config.relay,
            enabled=True,
            upstream=FederationUpstream(
                url=f"http://127.0.0.1:{root_port}", name="root", token=TOKEN,
            ),
            stale_after_seconds=3.0,
            resync_backoff_seconds=0.2,
            backfill=4096,
            sync_timeout_seconds=20.0,
        ),
    )
    app = WatcherApp(config, device=device)
    app.run()
    return 0


def _relay_healthz(port: int) -> dict:
    try:
        return FleetClient(f"http://127.0.0.1:{port}", token=TOKEN).healthz() or {}
    except Exception:
        return {}


def _wait_relay_synced(port: int, deadline_s: float) -> dict:
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        body = _relay_healthz(port)
        relay = body.get("relay") or {}
        if relay.get("synced"):
            return body
        time.sleep(0.2)
    raise RuntimeError(f"relay on :{port} never synced")


class _Consumer:
    """Sequence-checked long-poll loop that RETRIES transport errors (the
    relay dies and comes back mid-run) without ever counting them as
    resyncs — only a real 410 re-snapshot does."""

    def __init__(self, base: str):
        self.client = FleetClient(base, token=TOKEN)
        self.checker = SequenceChecker()
        self.model = {}
        self.rv = 0
        self.view = ""
        self.resyncs = 0
        self.transport_errors = 0
        self.polls = 0

    def start(self) -> None:
        snap = self.client.snapshot()
        self.rv, self.view = snap.rv, snap.view
        self.model = model_from_objects(snap.objects)

    def poll(self, timeout: float = 0.5) -> None:
        self.polls += 1
        try:
            batch = self.client.long_poll(self.rv, view=self.view, timeout=timeout)
        except ResyncRequired:
            self.resyncs += 1
            self.start()
            return
        except Exception:
            self.transport_errors += 1
            time.sleep(0.2)
            return
        self.checker.observe(
            batch.from_rv, batch.to_rv, batch.compacted,
            (i["rv"] for i in batch.items),
        )
        apply_wire_deltas(self.model, batch.items)
        self.rv = batch.to_rv

    def drain(self, polls: int = 30, timeout: float = 0.3) -> None:
        for _ in range(polls):
            before = self.rv
            # reset per attempt: idle means the LAST poll was clean and
            # delivered nothing, not that no error ever happened
            self.transport_errors = 0
            self.poll(timeout=timeout)
            if self.rv == before and self.transport_errors == 0:
                break


def _churn(server, rounds: int, flip: int = 0, stop=None) -> None:
    phases = ("Running", "Pending")
    for r in range(rounds):
        if stop is not None and stop.is_set():
            return
        for i in range(N_PODS):
            server.cluster.set_phase("default", f"pod-{i}", phases[(r + flip) % 2])
        time.sleep(0.05)


def run_smoke(device) -> dict:
    import tempfile

    result: dict = {
        "timestamp_utc": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "checks": {},
    }
    checks = result["checks"]
    with tempfile.TemporaryDirectory(prefix="relay-smoke-") as tmp_str, \
            MockApiServer() as server:
        tmp = Path(tmp_str)
        for i in range(N_PODS):
            server.cluster.add_pod(build_pod(
                f"pod-{i}", "default", uid=f"uid-{i}", phase="Pending", tpu_chips=4,
            ))
        root_port, relay_port, status_port = free_port(), free_port(), free_port()
        root = WatcherApp(_root_config(tmp, server.url, root_port, status_port), device=device)
        root_thread = threading.Thread(target=root.run, daemon=True)
        root_thread.start()
        relay_proc = None
        try:
            # root materializes its fleet
            deadline = time.monotonic() + DEADLINE_S
            root_cli = FleetClient(f"http://127.0.0.1:{root_port}", token=TOKEN)
            while time.monotonic() < deadline:
                try:
                    if len([o for o in root_cli.snapshot().objects
                            if o.get("kind") == "pod"]) >= N_PODS:
                        break
                except Exception:
                    pass
                time.sleep(0.2)
            else:
                raise RuntimeError("root never materialized the fleet")
            checks["root_materialized"] = True

            relay_proc = _spawn_relay(root_port, relay_port, device)
            _wait_relay_synced(relay_port, DEADLINE_S)

            # 1. mirror: same instance, equal snapshots
            relay_cli = FleetClient(f"http://127.0.0.1:{relay_port}", token=TOKEN)
            root_snap = root_cli.snapshot()
            relay_snap = relay_cli.snapshot()
            checks["relay_mirrors_root"] = (
                relay_snap.view == root_snap.view
                and model_from_objects(relay_snap.objects)
                == model_from_objects(root_snap.objects)
            )

            # 3. gapless consumption through the relay, under churn
            consumer = _Consumer(f"http://127.0.0.1:{relay_port}")
            consumer.start()
            churner = threading.Thread(target=_churn, args=(server, 10), daemon=True)
            churner.start()
            while churner.is_alive():
                consumer.poll()
            churner.join()
            consumer.drain()
            checks["consumer_gapless_via_relay"] = (
                consumer.checker.clean and consumer.checker.delivered > 0
            )

            # 2. zero re-encode across the process boundary (the consumer
            # above rode plain JSON long-polls — bounded reads, not the
            # frame arrays; the STREAMED leaves in bench_relay_tree are
            # the frame-path consumers. Here a streaming leg pins it.)
            # fresh=1 matches the relay's upstream-negotiated shape, so
            # this stream rides the verbatim passthrough frames
            stream_cli = FleetClient(
                f"http://127.0.0.1:{relay_port}", token=TOKEN, fresh=True
            )
            streamed = 0
            for batch in stream_cli.watch_batches(0, window_seconds=1.0):
                streamed += sum(
                    1 for f in batch if f.get("type") in ("UPSERT", "DELETE")
                )
            relay_fold = _relay_healthz(relay_port).get("relay") or {}
            checks["relay_zero_reencode"] = (
                streamed > 0
                and relay_fold.get("frames_relayed", 0) > 0
                and relay_fold.get("frame_encodes") == 0
            )
            checks["relay_depth_stamped"] = relay_fold.get("depth") == 1
            result["relay_fold_pre_restart"] = relay_fold

            # 4. kill the relay mid-run; consumer sees transport errors
            # (never resyncs), then a NEW relay process on the same port
            # backfills and the held token resumes gapless
            relay_proc.send_signal(signal.SIGKILL)
            relay_proc.wait(timeout=10)
            for _ in range(5):
                consumer.poll(timeout=0.2)  # transport errors while dark
            errors_while_dark = consumer.transport_errors
            relay_proc = _spawn_relay(root_port, relay_port, device)
            stop_churn = threading.Event()
            churner2 = threading.Thread(
                target=_churn, args=(server, 30, 1, stop_churn), daemon=True
            )
            churner2.start()
            _wait_relay_synced(relay_port, DEADLINE_S)
            recover_deadline = time.monotonic() + DEADLINE_S
            while time.monotonic() < recover_deadline:
                # reset per attempt: "recovered" means the LAST poll
                # succeeded — a single transient error while the relay's
                # listener rebinds must not pin the flag and spin this
                # loop (and the drain below) to the full deadline
                consumer.transport_errors = 0
                consumer.poll(timeout=0.3)
                if consumer.transport_errors == 0:
                    break
            stop_churn.set()
            churner2.join()
            consumer.drain(polls=40)
            checks["consumer_gapless_through_relay_restart"] = (
                consumer.checker.clean
                and consumer.resyncs == 0
                and errors_while_dark > 0
            )
            result["consumer"] = {
                **consumer.checker.to_dict(),
                "polls": consumer.polls,
                "resyncs": consumer.resyncs,
                "errors_while_dark": errors_while_dark,
            }

            # 5. token portability: the relay-carried token reads from
            # the ROOT directly (one rv line across the tree)
            try:
                root_batch = root_cli.long_poll(
                    consumer.rv, view=consumer.view, timeout=0.3
                )
                checks["token_valid_at_root"] = root_batch.from_rv == consumer.rv
            except ResyncRequired:
                checks["token_valid_at_root"] = False

            # 6. converge: consumer model == root terminal snapshot
            deadline = time.monotonic() + 15.0
            converged = False
            while time.monotonic() < deadline:
                consumer.drain(polls=5)
                truth = model_from_objects(root_cli.snapshot().objects)
                if consumer.model == truth:
                    converged = True
                    break
                time.sleep(0.3)
            checks["consumer_model_matches_root"] = converged

            relay_fold = _relay_healthz(relay_port).get("relay") or {}
            checks["restarted_relay_backfilled"] = (
                relay_fold.get("synced") is True
                and relay_fold.get("frame_encodes") == 0
            )
            result["relay_fold_post_restart"] = relay_fold
        finally:
            if relay_proc is not None and relay_proc.poll() is None:
                relay_proc.terminate()
                try:
                    relay_proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    relay_proc.kill()
            root.stop()
            root_thread.join(timeout=15)
    result["ok"] = bool(checks) and all(checks.values())
    return result


def main(argv: Optional[List[str]] = None) -> int:
    args = smoke_args(__doc__.splitlines()[0], "relay_smoke", argv)
    result = run_smoke(args.device)
    out = write_artifact(result, args.out)
    checks = checks_line(result["checks"])
    print(f"{'PASS' if result['ok'] else 'FAIL'}: {checks}")
    consumer = result.get("consumer") or {}
    if consumer:
        print(
            "consumer via relay: %d polls, %d deltas, gaps=%d dups=%d resyncs=%d "
            "(errors while relay dark: %d)"
            % (consumer["polls"], consumer["delivered"], consumer["gaps"],
               consumer["dups"], consumer["resyncs"], consumer["errors_while_dark"])
        )
    print(f"artifact: {out}")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--relay-child":
        sys.exit(_relay_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
