"""Production's watcher with its in-process probe, ingesting the open churn
of a seeded GPU cluster.

The app is ``python -m k8s_watcher_tpu_torch production``'s: the shipped
files with the configuration's environment and overrides merged over them
(the apiserver and sink URLs, free ports, directories in the run's own, the
GPU node labels, ``tpu.probe.interval_seconds`` 0), loaded by the port's
``load_app_config`` and built into a ``WatcherApp`` on the run's device, as
``cli.py`` builds it. Every plane the settings turn on runs; nothing stands
in for one.

Set-up: the traffic process (``portbench/traffic/apiserver.py``) builds the
cluster and starts encoding its churn; the app starts (the Lease, the paged
LIST, the WATCH, the node LIST and WATCH, its planes, the probe on the
device). Once the LIST is taken and the probe has run its warm cycles, the
churn starts on its schedule (``rate_per_s``), and ``warm_seconds`` later the
window opens at the next probe cycle's end, as ``probe_loop``'s does:
``probe_cycle_ms`` is its length over its cycles. The probe's work is counted
and checked by ``probe_loop``'s hooks and cycle plan.

After the window the schedule ends at the events due then; once the watcher
has taken every one and its egress lanes have drained, the app stops, and the
traffic process folds the LIST and the events its WATCH delivered
(``portbench/reference/watcher.py``) and holds the sink's payloads to the
fold. The backlog, at each of the window's ends, is the events due by the
schedule that the watcher has not yet taken off its stream or out of its
ingest queue.

``python3 -m portbench.drivers.watcher_churn --rate <events/s> --seed <n>
--seconds <s>`` runs the cell at another rate (the knee's sweep).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import sys
import threading
import time

from portbench.drivers import probe_loop
from portbench.drivers.probe_loop import CYCLE, GEMM_SAMPLE, State, instrument, settings, wait_cycles
from portbench.harness import ROOT, Check, RunError
from portbench.spans import Spans

CELL = "watcher-churn-probe"
POOL_MARGIN_S = 10.0  # churn encoded beyond the warm-up and the window
LIST_LIMIT_S = 600.0
DRAIN_LIMIT_S = 120.0
COMPARED = ("trend_alerts", "payloads_wrong", "notifications_lost", "out_of_order")


def cluster(run) -> dict:
    """The cluster's sizes, with a run's own overlay (the CPU tests')."""
    return {**run.config["cluster"], **(run.workload.get("cluster") or {})}


def pool_events(run) -> int:
    w = run.workload
    if w.get("churn_events"):
        return int(w["churn_events"])
    return int(w["rate_per_s"] * (w["warm_seconds"] + run.seconds + POOL_MARGIN_S))


def app_config(run, api_port: int, sink_port: int):
    """The app's settings: the shipped files with the deployment's environment
    and overrides (and a run's own ``overlay``) merged over them, written to
    the run's directory and loaded from there by ``load_app_config``."""
    from k8s_watcher_tpu_torch.config import deep_merge, load_app_config, load_raw_config

    from portbench.deploy import STATUS_TOKEN, _fill

    config, workdir = run.config, run.workdir
    kubeconfig = os.path.join(workdir, "kubeconfig")
    with open(kubeconfig, "w") as fh:
        json.dump({
            "apiVersion": "v1", "kind": "Config", "current-context": "stub",
            "clusters": [{"name": "stub", "cluster": {"server": f"http://127.0.0.1:{api_port}"}}],
            "contexts": [{"name": "stub", "context": {"cluster": "stub", "user": "stub"}}],
            "users": [{"name": "stub", "user": {"token": "stub-token"}}],
        }, fh)
    values = {"kubeconfig": kubeconfig, "sink_url": f"http://127.0.0.1:{sink_port}", "status_token": STATUS_TOKEN,
              "workdir": workdir}
    env = _fill(config["env"], values)
    raw = load_raw_config(config["environment"], os.path.join(ROOT, "config"), env=env)
    raw = deep_merge(raw, _fill(config["overrides"], values))
    if run.workload.get("overlay"):
        raw = deep_merge(raw, run.workload["overlay"])
    merged = os.path.join(workdir, "config")
    os.makedirs(merged, exist_ok=True)
    for name, body in (("base.yaml", {}), (f"{config['environment']}.yaml", raw)):
        with open(os.path.join(merged, name), "w") as fh:
            json.dump(body, fh)  # JSON is YAML
    return load_app_config(config["environment"], merged, env=env)


def setup(run) -> State:
    from k8s_watcher_tpu_torch.probe import spans as program_spans

    from portbench.traffic.apiserver import ChurnTraffic

    if not hasattr(program_spans, "watch_between"):
        raise RunError("the program keeps no watcher spans and no watch_events counter (probe/spans.py), which "
                       "this cell reads: it cannot run the cell")
    os.environ.update(run.config["process_env"])
    st = State()
    w = run.workload
    st.traffic = ChurnTraffic({"seed": run.seed, "cluster": cluster(run), "rate_per_s": w["rate_per_s"],
                               "gpu_share": w["gpu_share"], "pool_events": pool_events(run)}, run.traffic_cpus)
    st.app = st.thread = None
    try:
        return start(run, st)
    except BaseException:
        stop_app(st)
        if getattr(st, "spans", None) is not None:
            st.spans.restore()
        st.traffic.close()
        raise


def start(run, st: State) -> State:
    from k8s_watcher_tpu_torch.app import WatcherApp
    from k8s_watcher_tpu_torch.probe import spans as program_spans

    from portbench.reference.probe import cycle_plan

    st.cluster = st.traffic.reply(LIST_LIMIT_S)
    config = app_config(run, st.cluster["api"], st.cluster["sink"])
    st.plan = cycle_plan(settings(run), run.device.type == "cuda")
    st.spans = Spans()
    draw, taken = random.Random(f"gemm/{run.seed}"), []

    def take_gemm() -> bool:
        """The first cycle, and each later one with the chance GEMM_SAMPLE."""
        taken.append(1)
        return len(taken) == 1 or draw.random() < GEMM_SAMPLE

    instrument(st.spans, st.plan, take_gemm, control=run.control)
    st.ends, st.backlog = [], []
    st.cond = threading.Condition()
    st.t0 = None  # the churn's start, on the traffic process's schedule
    st.stopped = None  # the traffic process's answer to stop_churn
    st.errors = []

    def on_range(rng):
        if rng.name == CYCLE:
            with st.cond:
                st.ends.append(rng.t1)
                st.backlog.append((rng.t1, backlog(run, st, rng.t1)))
                st.cond.notify_all()

    st.spans.listeners.append(on_range)
    st.app = WatcherApp(config, device=run.device, expected_platform=run.expected_platform)
    st.app_s = time.monotonic() - run.start
    st.source = st.app.ingest.sources[0]
    st.taken0 = program_spans.RECORDER.taken()

    def serve():
        try:
            st.app.run()
        except BaseException as exc:  # noqa: BLE001 — reported by the check, fatal to the run
            st.errors.append(exc)
            with st.cond:
                st.cond.notify_all()

    st.thread = threading.Thread(target=serve, name="watcher", daemon=True)
    st.thread.start()
    list_rv = str(st.cluster["list_rv"])
    if not wait_for(lambda: st.source.resource_version == list_rv and st.app.ingest.queue.depth() == 0, st,
                    LIST_LIMIT_S):
        raise RuntimeError(f"the LIST was not taken in {LIST_LIMIT_S} s: rv {st.source.resource_version} "
                           f"of {list_rv}; {st.errors}")
    st.list_s = time.monotonic() - run.start
    warm = run.workload["warm_cycles"]
    if not wait_cycles(st, warm, 600):
        raise RuntimeError(f"{len(st.ends)} of {warm} warm-up cycles in 600 s: {st.errors}")
    st.churn = st.traffic.ask(LIST_LIMIT_S, cmd="churn")
    st.t0 = st.churn["t0"]
    time.sleep(run.workload["warm_seconds"])
    return st


def wait_for(predicate, st: State, timeout_s: float) -> bool:
    deadline = time.monotonic() + timeout_s
    while not predicate():
        if st.errors or time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    return True


def due(run, st: State, t: float) -> int:
    """The churn's events due by ``t`` on its schedule, which ends at the
    pool's last event or where the churn was stopped."""
    if st.t0 is None:
        return 0
    end = st.stopped["stop_at"] if st.stopped else pool_events(run)
    return min(max(0, int((t - st.t0) * run.workload["rate_per_s"])), end)


def backlog(run, st: State, t: float) -> int:
    """Events due at ``t`` that the watcher has not taken off its stream or
    out of its ingest queue."""
    from k8s_watcher_tpu_torch.probe import spans as program_spans

    return due(run, st, t) - (program_spans.RECORDER.taken() - st.taken0) + st.app.ingest.queue.depth()


def window(run, st: State) -> dict:
    return probe_loop.window(run, st)


def stop_app(st: State) -> None:
    if st.app is not None:
        st.app.stop()
        if st.thread is not None:
            st.thread.join(60)


def finish(run, st: State) -> None:
    try:
        st.stopped = st.traffic.ask(60, cmd="stop_churn")
        stop_at = st.stopped["stop_at"]
        want = str(st.cluster["list_rv"] + stop_at)
        t0 = time.monotonic()
        taken = wait_for(lambda: st.source.resource_version == want and st.app.ingest.queue.depth() == 0, st,
                         DRAIN_LIMIT_S)
        time.sleep(0.2)  # the pipeline's batch in flight
        st.drained = taken and st.app.dispatcher.drain(max(1.0, DRAIN_LIMIT_S - (time.monotonic() - t0)))
        st.drain_s = time.monotonic() - t0
    finally:
        stop_app(st)
        st.spans.restore()
        try:
            st.report = st.traffic.ask(600, cmd="report", wait_s=60)
        finally:
            st.traffic.close()


def check(run, st: State, w: dict):
    from k8s_watcher_tpu_torch.probe import spans as program_spans

    report = st.report
    if st.errors or (st.thread is not None and st.thread.is_alive()):
        raise RuntimeError(f"the watcher raised or did not stop: {st.errors}")
    if report["pod_lists"] != 1:
        raise RuntimeError(f"the watcher listed the pods {report['pod_lists']} times: the fold holds one LIST")
    outcome = probe_loop.check(run, st, w)
    limits = run.workload["limits"]
    outcome.checks += [Check(name, float(report[name]), float(limits[name])) for name in COMPARED]
    w0, w1 = w["w0"], w["w1"]
    kept, events = program_spans.watch_between(w0, w1)
    cycles = program_spans.cycles_between(w0, w1)
    gc_ms = [c.gc_ms() for c in cycles]
    stages = {}
    for c in cycles:
        for name, ms in c.stages_ms().items():
            stages.setdefault(name, []).append(ms)
    batches = [s for s in kept if s.name == "watch.batch"]
    ends = dict(st.backlog)
    outcome.observation.update(events_delivered=report["written"],
                               events_taken=program_spans.RECORDER.taken() - st.taken0)
    run.say("watcher run", {
        "rate_per_s": run.workload["rate_per_s"], "pool_events": pool_events(run), "app_built_s": st.app_s,
        "list_taken_s": st.list_s, "churn": st.churn,
        # (seconds after the churn's start, backlog) at the first cycle end of each second
        "backlog_by_second": sorted({int(t - st.t0): (round(t - st.t0, 2), n) for t, n in reversed(st.backlog)
                                     if t >= st.t0}.values()),
        "backlog_at_w0": ends.get(w0), "backlog_at_w1": ends.get(w1),
        "due_in_window": due(run, st, w1) - due(run, st, w0), "events_taken_in_window": events,
        "stop_at": st.stopped["stop_at"], "drained": st.drained, "drain_s": st.drain_s,
        "batches_in_window": len(batches),
        "batch_ms_mean": sum(s.ms for s in batches) / len(batches) if batches else None,
        "posts_in_window": sum(1 for s in kept if s.name == "notify.post"),
        "gc_ms_in_window": sum(gc_ms), "gc_ms_worst_cycle": max(gc_ms, default=None),
        "stage_ms_medians": {name: statistics.median(ms) for name, ms in stages.items()},
        "cluster": {k: st.cluster[k] for k in ("pods", "list_bytes", "build_s", "list_rv")},
        "traffic": {k: v for k, v in report.items() if k not in COMPARED},
        "metrics": {k: st.app.metrics.counter(k).value for k in (
            "events_received", "events_prefiltered", "dispatch_sent", "dispatch_failed", "dispatch_coalesced",
            "dispatch_dropped_overflow", "probe_trend_alerts", "probe_errors")},
    })
    return outcome


def main(argv=None) -> int:
    """One run of the cell at ``--rate`` events/s instead of its own."""
    from portbench import harness

    start = time.monotonic()
    parser = argparse.ArgumentParser(prog="python3 -m portbench.drivers.watcher_churn")
    parser.add_argument("--rate", type=float, required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    load_json = harness.load_json

    def at_rate(*parts):
        out = load_json(*parts)
        return dict(out, rate_per_s=args.rate) if parts == ("workloads", f"{CELL}.json") else out

    harness.load_json = at_rate
    return harness.main(["--workload", CELL, "--seed", str(args.seed), "--seconds", str(args.seconds),
                         "--trace", "0"], start)


if __name__ == "__main__":
    sys.exit(main())
