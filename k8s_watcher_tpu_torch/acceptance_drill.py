"""Acceptance drill: multi-slice churn — 1k+ pod events/min with preemption
AND fault injection, AT ONCE, on ranks (the JAX package's
``scripts/acceptance_drill.py``).

The per-feature drills prove each plane alone; this one runs the deployment
shape under combined load:

- a full WatcherApp (watch -> pipeline -> slice tracking -> dispatcher)
  notifying a live HTTP sink, fed by the port's mock apiserver churning pod
  lifecycles at >= 1k events/min with real preemption markers;
- interleaved latency tracer pods timing the pod-event->notify path end to
  end (clock starts before the apiserver write) WHILE everything else runs —
  the <1 s p50 target must hold under combined load, not on an idle system;
- concurrently, a DaemonSet-shape probe loop on ranks over ``--slices``
  slices with a corrupted rank in the last slice: the slice-pair walk must
  localize that slice and the remediation policy must produce a confirmed
  DRY-RUN decision naming its node — while the churn flows.

A slice is a node on ranks (parallel/mesh.py:slice_grid), so the cluster
holds one node per slice, ``accept-tpu-node-<i>``, and the decision names
the last slice's node, where the JAX package's one-process drill names
``accept-tpu-node-0``.

    python -m k8s_watcher_tpu_torch.acceptance_drill --cpu-ranks 8 --out accept.json
    torchrun --nnodes=4 --nproc-per-node=gpu ... -m k8s_watcher_tpu_torch.acceptance_drill --out accept.json

``--cpu-ranks N`` runs the probe loop on N gloo ranks in CPU processes, split
into ``--slices`` nodes, and the watcher's analytics on the CPU; this process
holds the apiserver, the sink, the watcher and the churn. Under ``torchrun``
the probe loop runs on the launch's GPUs (``--slices`` must divide the node
count, else exit code 2) and rank 0 holds the rest, the watcher on its GPU.
Without ``--cpu-ranks`` and without CUDA it raises; it never falls back to
the CPU. Every gate is asserted and written to ``--out``; exit code 0 when
all pass, 1 when one fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import statistics
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from k8s_watcher_tpu_torch.chaos_remediate import PAIR_RTT_FLOOR_MS
from k8s_watcher_tpu_torch.drill_common import start_sink, tpu_node

REPO = Path(__file__).resolve().parent.parent
DEFAULT_OUT = REPO / "artifacts" / "acceptance_ranks.json"
NODE_PREFIX = "accept-tpu-node-"
STAGE_MODULE = "k8s_watcher_tpu_torch.acceptance_drill"
STOP_FILE = "stop"
PROGRESS_FILE = "progress.json"
DRAIN_S = 60.0  # tracers in flight and the confirming probe cycles, after the churn


def node_name(index: int) -> str:
    return f"{NODE_PREFIX}{index}"


def tpu_pod(name, uid, phase, node="accept-node-0", chips=4):
    from k8s_watcher_tpu_torch.watch.fake import build_pod

    return build_pod(
        name, uid=uid, phase=phase, tpu_chips=chips, tpu_topology="2x2x1",
        node_name=node,
        gke_slice_fields={"jobset.sigs.k8s.io/jobset-name": name.rsplit("-", 1)[0],
                          "batch.kubernetes.io/job-completion-index": int(name.rsplit("-", 1)[1])},
    )


def _write_progress(control_dir: str, state: Dict[str, Any]) -> None:
    tmp = os.path.join(control_dir, PROGRESS_FILE + ".tmp")
    with open(tmp, "w") as fh:
        json.dump({"cycles": state["cycles"], "decisions": len(state["decisions"])}, fh)
    os.replace(tmp, os.path.join(control_dir, PROGRESS_FILE))


def read_progress(control_dir: str) -> Dict[str, int]:
    try:
        with open(os.path.join(control_dir, PROGRESS_FILE)) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return {"cycles": 0, "decisions": 0}


def probe_loop(rank: int, world: int, *, api_url: str, n_slices: int, confirm_cycles: int,
               control_dir: Optional[str], device: Optional[str] = None,
               fault_slice: Optional[int] = None) -> Dict[str, Any]:
    """The DaemonSet-shape probe loop on this rank; every rank calls it
    together. Each cycle runs the multislice probe with the first rank of
    ``fault_slice`` (default: the last slice) corrupted; rank 0 forms the
    report and feeds a dry-run policy whose actuator talks to ``api_url``,
    and writes its progress to ``control_dir``. The loop ends when rank 0
    finds ``control_dir/stop``. Rank 0 returns the per-cycle suspects and
    the decisions."""
    import torch.distributed as dist

    from k8s_watcher_tpu_torch.faults.ici import IciFaultSpec
    from k8s_watcher_tpu_torch.k8s.client import K8sClient
    from k8s_watcher_tpu_torch.k8s.kubeconfig import K8sConnection
    from k8s_watcher_tpu_torch.probe.device import enumerate_devices, host_identity_map, resolve_device
    from k8s_watcher_tpu_torch.probe.multislice import run_multislice_probe
    from k8s_watcher_tpu_torch.probe.report import ProbeReport
    from k8s_watcher_tpu_torch.remediate import NodeActuator, ProbeRemediationPolicy

    dev = resolve_device(device)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    os.environ["NODE_NAME"] = node_name(rank // local)
    # CORRUPT a rank in one slice: every slice pair touching that slice
    # fails its checksum — deterministic under the drill's combined CPU
    # load, where a timing fault's separation drowns in churn noise
    fault_slice = n_slices - 1 if fault_slice is None else fault_slice
    fault = IciFaultSpec(corrupt_rank=fault_slice * (world // n_slices))
    devices = enumerate_devices(dev, expected_platform=None)
    hosts = host_identity_map(dev)
    policy = None
    if rank == 0:
        actuator = NodeActuator(
            K8sClient(K8sConnection(server=api_url), request_timeout=5.0),
            dry_run=True, cooldown_seconds=0.0, max_actions_per_hour=100, max_quarantined_nodes=8,
        )
        policy = ProbeRemediationPolicy(actuator, confirm_cycles=confirm_cycles)
    state: Dict[str, Any] = {"cycles": 0, "dcn_suspects": [], "decisions": [], "unreliable": 0}
    while True:
        stop = [rank == 0 and os.path.exists(os.path.join(control_dir, STOP_FILE))]
        dist.broadcast_object_list(stop, src=0)
        if stop[0]:
            break
        ms = run_multislice_probe(n_slices=n_slices, iters=3, inner_iters=4, fault=fault,
                                  pair_rtt_floor_ms=PAIR_RTT_FLOOR_MS[dev.type], device=dev)
        if rank == 0:
            state["cycles"] += 1
            state["dcn_suspects"].append(list(ms.dcn_suspect_slices))
            if ms.timing_unreliable:
                state["unreliable"] += 1
            report = ProbeReport(environment="accept", devices=devices, multislice=ms, hosts=hosts)
            state["decisions"] += [d.to_dict() for d in policy.observe_report(report)]
            _write_progress(control_dir, state)
        time.sleep(1.0)
    return state if rank == 0 else {}


def drill(args, world: int, app_device: str, start_probe: Callable[[str, str], Callable[[], Dict[str, Any]]]
          ) -> Dict[str, Any]:
    """The watcher under churn beside the probe loop, every gate checked.
    ``start_probe(api_url, control_dir)`` starts the ranks' probe loop and
    returns a function that waits for it and returns rank 0's state."""
    from k8s_watcher_tpu_torch.app import WatcherApp
    from k8s_watcher_tpu_torch.config import load_app_config
    from k8s_watcher_tpu_torch.k8s.mock_server import MockApiServer, MockCluster

    result: Dict[str, Any] = {
        "devices": world, "slices": args.slices,
        "offered_rate_per_sec": args.rate, "duration_seconds": args.seconds,
    }
    failures: List[str] = []

    # -- live HTTP sink with arrival timestamps ----------------------------
    arrivals: Dict[str, float] = {}
    payload_counts: Dict[str, int] = {}
    disruption_kinds: set = set()
    sink_lock = threading.Lock()

    def on_payload(body: dict, now: float) -> None:
        with sink_lock:
            kind = body.get("event_type", "?")
            payload_counts[kind] = payload_counts.get(kind, 0) + 1
            name = body.get("name", "")
            if name.startswith("tracer-"):
                arrivals.setdefault(name, now)
            if kind == "DELETED" and body.get("disruption"):
                disruption_kinds.add(body["disruption"].get("kind"))

    sink = start_sink(on_payload)

    # -- mock apiserver + the full watcher app -----------------------------
    cluster = MockCluster()
    for i in range(4):
        cluster.add_node(tpu_node(f"accept-node-{i}"))
    for i in range(args.slices):
        cluster.add_node(tpu_node(node_name(i)))

    with MockApiServer(cluster) as api, tempfile.TemporaryDirectory() as tmp:
        kc = Path(tmp) / "kubeconfig.json"
        kc.write_text(json.dumps({
            "apiVersion": "v1", "kind": "Config",
            "clusters": [{"name": "m", "cluster": {"server": api.url}}],
            "contexts": [{"name": "m", "context": {"cluster": "m", "user": "m"}}],
            "current-context": "m",
            "users": [{"name": "m", "user": {"token": "t"}}],
        }))
        config = load_app_config("development", REPO / "config", env={})
        config = dataclasses.replace(
            config,
            kubernetes=dataclasses.replace(
                config.kubernetes, use_mock=False, config_file=str(kc), watch_timeout_seconds=10,
            ),
            clusterapi=dataclasses.replace(
                config.clusterapi, base_url=f"http://127.0.0.1:{sink.server_address[1]}", api_key=None,
            ),
            watcher=dataclasses.replace(config.watcher, status_port=0),
            tpu=dataclasses.replace(config.tpu, probe_enabled=False),
            state=dataclasses.replace(config.state, checkpoint_path=str(Path(tmp) / "ck.json")),
        )
        app = WatcherApp(config, device=app_device)
        app_thread = threading.Thread(target=app.run, daemon=True)
        app_thread.start()
        time.sleep(1.0)  # let the watch connect

        # -- the probe loop on the ranks, with the injected fault ----------
        control_dir = os.path.join(tmp, "probe")
        os.mkdir(control_dir)
        finish_probe = start_probe(api.url, control_dir)

        # -- churn at >= 1k events/min with preemption + latency tracers ---
        # Explicit per-worker state: ALIVE workers flip phases, a periodic
        # victim is preempted (real k8s markers + DELETED), and preempted
        # workers RESCHEDULE (re-added with a fresh uid, like a controller
        # would) a few ticks later — the full lifecycle, not just deletes.
        n_jobsets = 8
        workers = 4
        alive: Dict[tuple, bool] = {}
        for j in range(n_jobsets):
            for w in range(workers):
                cluster.add_pod(tpu_pod(f"job{j}-{w}", f"uid-{j}-{w}", "Pending", node=f"accept-node-{w % 4}"))
                alive[(j, w)] = True
        rv_start = cluster.latest_rv()
        tracer_writes: Dict[str, float] = {}
        preemptions = 0
        reschedules = 0
        interval = 1.0 / args.rate
        t0 = time.monotonic()
        deadline = t0 + args.seconds
        i = 0
        while time.monotonic() < deadline:
            target = t0 + i * interval
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            step = i % 10
            preempted = [key for key, up in alive.items() if not up]
            if step == 4:  # every 10th write: a unique latency tracer
                name = f"tracer-{i}"
                tracer_writes[name] = time.monotonic()
                cluster.add_pod(tpu_pod(name, f"uid-{name}", "Running", chips=4))
            elif step == 7 and len(preempted) < n_jobsets:
                # preempt an alive worker: markers, then DELETED
                j, w = next(key for key, up in sorted(alive.items()) if up)
                victim = tpu_pod(f"job{j}-{w}", f"uid-{j}-{w}", "Failed", node=f"accept-node-{w % 4}")
                victim["status"]["reason"] = "Preempted"
                victim["status"].setdefault("conditions", []).append({
                    "type": "DisruptionTarget", "status": "True", "reason": "PreemptionByScheduler",
                })
                cluster.modify_pod(victim)
                cluster.delete_pod("default", f"job{j}-{w}")
                alive[(j, w)] = False
                preemptions += 1
            elif step == 8 and preempted:
                # the OLDEST preempted worker reschedules on another node,
                # with a fresh uid — exactly what its Job controller does
                j, w = preempted[0]
                cluster.add_pod(tpu_pod(f"job{j}-{w}", f"uid-{j}-{w}-r{i}", "Pending",
                                        node=f"accept-node-{(w + 1) % 4}"))
                alive[(j, w)] = True
                reschedules += 1
            else:
                # phase flips spread round-robin over workers that actually
                # EXIST — a set_phase on a deleted pod journals nothing
                alive_list = [key for key, up in sorted(alive.items()) if up]
                if alive_list:
                    j, w = alive_list[i % len(alive_list)]
                    phase = "Running" if (i // len(alive_list)) % 2 == 0 else "Pending"
                    cluster.set_phase("default", f"job{j}-{w}", phase)
            i += 1
        churn_seconds = time.monotonic() - t0
        # the gate counts REALIZED apiserver events (journal rv delta), not
        # offered writes — a write that journals nothing is not churn
        journaled = cluster.latest_rv() - rv_start
        realized_per_min = 60.0 * journaled / churn_seconds
        result["events_journaled"] = journaled
        result["realized_events_per_min"] = round(realized_per_min, 1)
        result["preemptions"] = preemptions
        result["reschedules"] = reschedules
        if realized_per_min < 1000.0:
            failures.append(f"realized rate {realized_per_min:.0f}/min < 1000/min")
        if not preemptions:
            failures.append("no preemption ever injected")
        if not reschedules:
            failures.append("no preempted worker ever rescheduled")

        # drain: tracers still in flight + probe confirmation cycles
        drain_deadline = time.monotonic() + DRAIN_S
        while time.monotonic() < drain_deadline:
            with sink_lock:
                tracers_done = len(arrivals)
            progress = read_progress(control_dir)
            if (tracers_done >= len(tracer_writes) and progress["decisions"] > 0
                    and progress["cycles"] >= args.confirm_cycles):
                break
            time.sleep(0.5)
        Path(control_dir, STOP_FILE).touch()
        probe_state = finish_probe()

        # -- latency under combined load -----------------------------------
        with sink_lock:
            latencies = sorted(1e3 * (arrivals[n] - tracer_writes[n]) for n in arrivals if n in tracer_writes)
            result["notifications_by_kind"] = dict(sorted(payload_counts.items()))
            result["disruption_kinds_seen"] = sorted(disruption_kinds)
        result["tracers"] = {"offered": len(tracer_writes), "completed": len(latencies)}
        if latencies:
            # nearest-rank percentile: ceil(q*n)-1
            p90_idx = max(0, -(-9 * len(latencies) // 10) - 1)
            result["latency_ms"] = {
                "p50": round(statistics.median(latencies), 2),
                "p90": round(latencies[p90_idx], 2),
                "max": round(latencies[-1], 2),
            }
            if result["latency_ms"]["p50"] >= 1000.0:
                failures.append(f"p50 {result['latency_ms']['p50']}ms >= 1s under load")
        else:
            failures.append("no latency tracer completed")
        if len(latencies) < 0.9 * len(tracer_writes):
            failures.append(f"only {len(latencies)}/{len(tracer_writes)} tracers notified")
        if "preemption" not in disruption_kinds:
            failures.append(f"no preemption-classified DELETED: {disruption_kinds}")
        overflow = app.metrics.counter("dispatch_dropped_overflow").value
        result["overflow_drops"] = overflow
        if overflow:
            failures.append(f"{overflow} notifications dropped (queue overflow)")

        # -- fault localization + dry-run decision under the same load -----
        target_slice = args.slices - 1
        localized = [s for s in probe_state["dcn_suspects"] if s == [target_slice]]
        result["probe"] = {
            "cycles": probe_state["cycles"],
            "dcn_suspects_per_cycle": probe_state["dcn_suspects"],
            "timing_unreliable_cycles": probe_state["unreliable"],
            "decisions": probe_state["decisions"],
        }
        if not localized:
            failures.append(f"DCN walk never localized slice {target_slice}: {probe_state['dcn_suspects']}")
        decisions = [d for d in probe_state["decisions"] if d["ok"] and d["dry_run"]]
        if not decisions:
            failures.append("no confirmed dry-run remediation decision under load")
        elif decisions[0]["node"] != node_name(target_slice) or f"slice {target_slice}" not in decisions[0]["reason"]:
            failures.append(f"decision mismatch: {decisions[0]}")
        for name in [f"accept-node-{i}" for i in range(4)] + [node_name(i) for i in range(args.slices)]:
            spec = (cluster.get_node(name) or {}).get("spec") or {}
            if spec.get("unschedulable") or spec.get("taints"):
                failures.append(f"dry-run drill wrote to the cluster: {name}: {spec}")

        app.shutdown()
        app_thread.join(timeout=10)
    sink.shutdown()
    sink.server_close()

    result["failures"] = failures
    result["ok"] = not failures
    result["timestamp_utc"] = datetime.datetime.now(datetime.timezone.utc).isoformat()
    return result


def _report(result: Dict[str, Any], out: str) -> int:
    artifact = Path(out)
    artifact.parent.mkdir(parents=True, exist_ok=True)
    artifact.write_text(json.dumps(result, indent=2) + "\n")
    print(json.dumps({k: v for k, v in result.items() if k not in ("notifications_by_kind",)}, indent=2))
    print(f"artifact: {artifact}")
    print(f"acceptance drill: {'PASS' if result['ok'] else 'FAIL'}")
    return 0 if result["ok"] else 1


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu-ranks", type=int, default=0, metavar="N",
                        help="run the probe loop on N gloo ranks in CPU processes instead of the GPUs")
    parser.add_argument("--slices", type=int, default=4)
    parser.add_argument("--seconds", type=float, default=75.0)
    parser.add_argument("--rate", type=float, default=20.0,
                        help="offered apiserver writes per second (>= 16.7 = 1k/min)")
    parser.add_argument("--confirm-cycles", type=int, default=2)
    parser.add_argument("--out", default=str(DEFAULT_OUT))
    args = parser.parse_args(argv)
    loop_args = dict(n_slices=args.slices, confirm_cycles=args.confirm_cycles)

    if args.cpu_ranks:
        from k8s_watcher_tpu_torch.parallel.cpu_ranks import run_cpu_ranks

        world = args.cpu_ranks
        if args.slices < 1 or world % args.slices:
            print(f"{world} ranks do not split into --slices {args.slices}", file=sys.stderr)
            return 2

        def start_probe(api_url: str, control_dir: str):
            box: Dict[str, Any] = {}

            def ranks():
                try:
                    box["ranks"] = run_cpu_ranks(
                        f"{STAGE_MODULE}:probe_loop", world,
                        dict(loop_args, api_url=api_url, control_dir=control_dir, device="cpu"),
                        local_world_size=world // args.slices)
                except BaseException as exc:  # noqa: BLE001 — re-raised in the caller's thread
                    box["error"] = exc

            thread = threading.Thread(target=ranks, name="probe-ranks", daemon=True)
            thread.start()

            def finish():
                thread.join()
                if "error" in box:
                    raise box["error"]
                return box["ranks"][0]

            return finish

        return _report(drill(args, world, "cpu", start_probe), args.out)

    import torch.distributed as dist

    from k8s_watcher_tpu_torch.parallel.mesh import initialize_process_group
    from k8s_watcher_tpu_torch.probe.device import process_count, process_index, resolve_device

    dev = resolve_device(None)  # raises without CUDA: the drill never falls back to the CPU
    initialize_process_group(dev)
    world, rank = process_count(), process_index()
    nodes = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if args.slices < 1 or world % args.slices or nodes % args.slices:
        dist.destroy_process_group()
        print(f"{world} ranks on {nodes} nodes do not split into --slices {args.slices}", file=sys.stderr)
        return 2
    urls: List[Any] = [None]
    try:
        if rank != 0:
            dist.broadcast_object_list(urls, src=0)
            probe_loop(rank, world, api_url=urls[0], control_dir=None, device="cuda", **loop_args)
            dist.barrier()
            return 0

        def start_probe(api_url: str, control_dir: str):
            urls[0] = api_url
            dist.broadcast_object_list(urls, src=0)
            box: Dict[str, Any] = {}

            def loop():
                try:
                    box["state"] = probe_loop(0, world, api_url=api_url, control_dir=control_dir, device="cuda",
                                              **loop_args)
                except BaseException as exc:  # noqa: BLE001 — re-raised in the caller's thread
                    box["error"] = exc

            thread = threading.Thread(target=loop, name="probe-rank-0", daemon=True)
            thread.start()

            def finish():
                thread.join()
                if "error" in box:
                    raise box["error"]
                return box["state"]

            return finish

        result = drill(args, world, "cuda", start_probe)
        dist.barrier()
        return _report(result, args.out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
