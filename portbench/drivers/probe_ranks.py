"""The probe DaemonSet as one node's group of ranks: ``probe_agent.run_loop``
on every rank, one rank a device, as ``torchrun --standalone --nnodes=1
--nproc-per-node`` starts it, with the cell's settings and its cycles back to
back.

Rank 0 runs on a thread of the harness's process, on ``run.device``; ranks
1 .. n-1 are its child processes (``python -m portbench.drivers.probe_ranks
<spec> <rank>``), rank ``r`` on device ``r``. Every rank gets the environment
``torchrun`` gives it (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) and the node's one
``NODE_NAME``. The ranks share the program's CPUs (``hostcpu.split``), as
``torchrun``'s ranks share their one pod's: the DaemonSet pins no rank.

Every rank is instrumented as ``probe_loop`` instruments its one rank, and
besides counts its calls into ``torch.distributed`` and keeps what its
collectives returned: the bandwidth all-reduce's output (compared once the
ICI stage is over), every pair exchange's, the merged link records, the link
walk's verdict and the findings gather's rows. On the card a timed call is a
kept graph's launches: its output after them is what is compared. Each
cycle's readings (the chain's round, the payload's bus bandwidth, each owned
link's hop) are kept too, and their medians shown. What each rank made is held
to ``portbench.reference.probe`` and ``portbench.reference.ranks`` once its
loop has stopped; a child writes its record to the run's directory and exits.

The window is rank 0's, as in ``probe_loop``: the collectives keep the ranks
in step. ``finish`` asks rank 0 alone to stop: the program's stop vote has to
carry the stop to every rank. A child that has not exited ``STOP_DEADLINE_S``
after rank 0's loop ended is killed, and counts as stopped apart.

With ``run.control`` every rank runs ``probe_loop``'s control (the read sweep
and block sums in bfloat16, the GEMM chain in float8), and every float32
all-reduce (sum) reduces in bfloat16.

A program whose ranks cannot stop together cannot run the cell: the run fails
before it starts a rank.
"""

from __future__ import annotations

import inspect
import json
import os
import random
import signal
import statistics
import subprocess
import sys
import threading
import time

from portbench.drivers import probe_loop
from portbench.drivers.probe_loop import CYCLE, GEMM_SAMPLE, instrument, settings, stage, wait_cycles
from portbench.harness import ROOT, Check, Outcome, Run, RunError, forbidden_modules
from portbench.spans import Spans

MASTER_ADDR = "127.0.0.1"  # torchrun --standalone's rendezvous is on the node itself
STOP_DEADLINE_S = 60.0  # a child's exit after rank 0's loop ended: its group's teardown and its record
COLLECTIVES = {"all_reduce": "all_reduce", "all_gather_into_tensor": "all_gather", "batch_isend_irecv": "exchange"}
VOTE = "probe.stop_vote"

window = probe_loop.window  # rank 0's window, as the one rank's


class State:
    pass


def rank_env(n: int, rank: int, port: int, node_name: str) -> dict:
    return {"RANK": str(rank), "WORLD_SIZE": str(n), "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(n),
            "MASTER_ADDR": MASTER_ADDR, "MASTER_PORT": str(port), "NODE_NAME": node_name}


def can_stop_together() -> bool:
    """Whether the program's loop ends its cycles with the stop vote."""
    from k8s_watcher_tpu_torch.probe.agent import ProbeAgent

    return "vote" in inspect.signature(ProbeAgent.run_once).parameters


def bf16_all_reduce(real):
    """``all_reduce`` that reduces a float32 sum in bfloat16 (the control)."""
    import torch
    import torch.distributed as dist

    def all_reduce(tensor, op=dist.ReduceOp.SUM, group=None, async_op=False):
        if tensor.dtype != torch.float32 or op != dist.ReduceOp.SUM:
            return real(tensor, op=op, group=group, async_op=async_op)
        low = tensor.to(torch.bfloat16)
        work = real(low, op=op, group=group)
        tensor.copy_(low)
        return work

    return all_reduce


def instrument_rank(run: Run, st: State, rank: int) -> None:
    """``probe_loop``'s instrumentation, and the collectives: every call
    into ``torch.distributed``, each output of the bandwidth all-reduce and
    of the pair exchanges (kept by reference, compared once their stage is
    over, off the timed launches), the merged link records, the walk's
    verdict and the findings gather."""
    import torch
    import torch.distributed as dist

    import k8s_watcher_tpu_torch.probe.agent as agent_mod
    import k8s_watcher_tpu_torch.probe.ici as ici_mod
    import k8s_watcher_tpu_torch.probe.links as links_mod
    import k8s_watcher_tpu_torch.probe.timing as timing_mod
    from portbench.reference.probe import cycle_plan
    from portbench.reference.ranks import CollectivePlan, bandwidth_sum, pair_round_trip, ring_links

    n = run.config["ranks"]
    sizes = settings(run)
    st.plan = cycle_plan(sizes, run.device.type == "cuda")
    st.rank_plan = CollectivePlan(n, bool(sizes.get("links_enabled")), on_card=run.device.type == "cuda")
    st.spans = Spans()
    draw, taken = random.Random(f"gemm/{run.seed}/{rank}"), []

    def take_gemm() -> bool:
        taken.append(1)
        return len(taken) == 1 or draw.random() < GEMM_SAMPLE

    if run.control:
        st.spans.replace(dist, "all_reduce", bf16_all_reduce(dist.all_reduce))
    instrument(st.spans, st.plan, take_gemm, control=run.control)

    def count(kind):
        def after(rng, args, kwargs, out):
            if rng is not None:
                rng.work[kind] = rng.work.get(kind, 0) + 1
        return after

    for attr, kind in COLLECTIVES.items():
        st.spans.hook(dist, attr, count(kind))

    def keep(key, make):
        def made(*args, **kwargs):
            out = make(*args, **kwargs)
            fn, rest = (out[0], out[1:]) if isinstance(out, tuple) else (out, None)

            def kept(x):
                y = fn(x)
                stack = st.spans._open()
                if stack:
                    stack[-1].work.setdefault(key, []).append(y)
                return y

            return kept if rest is None else (kept, *rest)
        return made

    for owner, attr, key in ((ici_mod, "make_allreduce_bandwidth_probe", "bandwidth_out"),
                             (links_mod, "make_pair_probe", "pair_out")):
        st.spans.replace(owner, attr, keep(key, getattr(owner, attr)))

    def graph_timed(rng, args, kwargs, samples):
        # a kept graph's timed launches (the card): its output after the last one; the
        # payload's is the ICI stage's bfloat16 one, the chain's float32 one is not compared
        out = args[1]
        if rng is None:
            return
        if rng.name == stage("run_link_probe"):
            rng.work.setdefault("pair_out", []).append(out.clone())
        elif rng.name == stage("run_ici_probe") and out.dtype == torch.bfloat16:
            rng.work.setdefault("bandwidth_out", []).append(out.clone())

    st.spans.hook(timing_mod, "collective_times_ms", graph_timed)
    want_bw, want_pair = bandwidth_sum(n), pair_round_trip()
    ring = [name for name, _, _ in ring_links(n)]

    def on_range(rng):
        if rng.name == CYCLE:
            with st.cond:
                st.ends.append(rng.t1)
                st.cond.notify_all()
        outs = rng.work.pop("bandwidth_out", None)
        if outs:
            gaps = torch.stack([(o.double() - want_bw).abs().amax() for o in outs]).cpu()
            rng.work["allreduce_gap"] = float(gaps.max()) / want_bw
        outs = rng.work.pop("pair_out", None)
        if outs:
            got = torch.cat([o.reshape(-1) for o in outs]).double().cpu()
            rng.work["pair_gap"] = float((got - want_pair).abs().max()) / want_pair

    def merged(rng, args, kwargs, out):
        if rng is not None:
            records, _ = out
            rng.work["merged"] = [(r.name, r.rtt_ms >= 0.0 and r.correct and r.error is None) for r in records]

    def ici_read(rng, args, kwargs, result):
        if rng is not None:  # the cycle's
            rng.work["ici_reading"] = {"chain_round_ms": result.psum_rtt_median_ms,
                                       "bus_gbps": result.bandwidth_gbps_median}

    def walked(rng, args, kwargs, result):
        rng.work["link_hops"] = {link.name: link.rtt_ms for link in result.links}
        found = rng.work.get("merged")
        rng.work["links_wrong"] = bool(result.suspect_links or result.suspect_devices or result.error
                                       or found is None or [name for name, _ in found] != ring
                                       or not all(ok for _, ok in found))

    def gathered(rng, args, kwargs, rows):
        if rng is not None:
            raw = args[0] if args else kwargs["raw"]
            rng.work["gather"] = (raw.decode("utf-8", "replace"), [r.decode("utf-8", "replace") for r in rows])

    st.spans.listeners.append(on_range)
    st.spans.hook(links_mod, "merge_owned_records", merged)
    st.spans.wrap(agent_mod, "run_link_probe", stage("run_link_probe"), walked)
    st.spans.hook(agent_mod, "run_ici_probe", ici_read)
    st.spans.hook(agent_mod, "all_gather_rows", gathered)


def start_loop(run: Run, st: State, config, on_thread: bool):
    """Rank ``RANK``'s ``run_loop``: on a thread (rank 0), or here."""
    from k8s_watcher_tpu_torch.probe_agent import run_loop

    st.ends, st.errors, st.loop = [], [], None
    st.cond = threading.Condition()
    st.stop = threading.Event()

    def loop():
        try:
            st.loop = run_loop(config, "production", st.stop, device=run.device,
                               expected_platform=run.expected_platform)
        except BaseException as exc:  # noqa: BLE001 — reported by the check, fatal to the run
            st.errors.append(exc)
            with st.cond:
                st.cond.notify_all()

    if not on_thread:
        loop()
        return
    st.thread = threading.Thread(target=loop, name="probe-loop", daemon=True)
    st.thread.start()


def setup(run: Run) -> State:
    import torch.distributed as dist

    from portbench.traffic.server import TrafficProcess

    if not can_stop_together():
        raise RunError("this program's probe loop has no stop vote: a group of ranks cannot stop together")
    if dist.is_initialized():  # rank 0 would join it, and never its children's
        raise RunError("a process group already exists in the harness's process")
    st = State()
    st.children = []
    st.saved_env = None
    n = run.config["ranks"]
    if run.device.type == "cuda":
        import torch

        if torch.cuda.device_count() < n:
            raise RunError(f"{n} ranks need {n} CUDA devices; torch sees {torch.cuda.device_count()}")
    node = run.config["process_env"]["NODE_NAME"]
    st.traffic = TrafficProcess({"node_names": [node]}, run.traffic_cpus)
    try:
        return start(run, st, n, node)
    except BaseException:
        stop_children(st, 0.0)
        if getattr(st, "stop", None) is not None:
            st.stop.set()
            st.thread.join(60)
        if getattr(st, "spans", None) is not None:
            st.spans.restore()
        restore_env(st)
        st.traffic.close()
        raise


def start(run: Run, st: State, n: int, node: str) -> State:
    from portbench.deploy import free_port

    ports = st.traffic.reply(120)
    port = free_port()
    spec = {"cell": run.cell, "config": run.config, "workload": run.workload, "seed": run.seed, "seconds": run.seconds,
            "workdir": run.workdir, "start": run.start, "device": run.device.type,
            "expected_platform": run.expected_platform, "control": run.control, "ports": ports}
    spec_path = os.path.join(run.workdir, "ranks.json")
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    for rank in range(1, n):
        env = {**os.environ, **rank_env(n, rank, port, node)}
        env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
        log = open(os.path.join(run.workdir, f"rank{rank}.log"), "w")
        proc = subprocess.Popen([sys.executable, "-m", "portbench.drivers.probe_ranks", spec_path, str(rank)],
                                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        log.close()
        st.children.append((rank, proc))
    st.saved_env = {k: os.environ.get(k) for k in rank_env(n, 0, port, node)}
    os.environ.update(rank_env(n, 0, port, node))
    st.config = rank_config(run, ports)
    instrument_rank(run, st, 0)
    start_loop(run, st, st.config, on_thread=True)
    run.say("ranks", {"n": n, "cpus": sorted(os.sched_getaffinity(0)), "children": [p.pid for _, p in st.children]})
    warm, deadline = run.workload["warm_cycles"], time.monotonic() + 600
    while not wait_cycles(st, warm, 1.0):
        ended = {r: p.poll() for r, p in st.children if p.poll() is not None}
        if ended or st.errors or time.monotonic() > deadline:
            logs = {r: log_tail(run, r) for r in ended}
            raise RuntimeError(f"{len(st.ends)} of {warm} warm-up cycles: rank 0 {st.errors}, "
                               f"children that exited {ended}, their logs' ends {logs}")
    return st


def log_tail(run: Run, rank: int, size: int = 3000) -> str:
    with open(os.path.join(run.workdir, f"rank{rank}.log")) as fh:
        return fh.read()[-size:]


def rank_config(run: Run, ports: dict):
    from portbench.deploy import agent_config

    workdir = os.path.join(run.workdir, f"rank{os.environ['RANK']}")
    os.makedirs(workdir, exist_ok=True)
    return agent_config(run.config, workdir, ports["api"], ports["sink"], run.workload.get("overlay"))


def stop_children(st: State, deadline_s: float) -> dict:
    """Each child's exit code once it has exited, waiting up to
    ``deadline_s`` in all; one still running is killed (None)."""
    codes, end = {}, time.monotonic() + deadline_s
    for rank, proc in st.children:
        try:
            codes[rank] = proc.wait(max(0.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            codes[rank] = None
    return codes


def restore_env(st: State) -> None:
    for k, v in (st.saved_env or {}).items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    st.saved_env = None


def finish(run: Run, st: State) -> None:
    st.stop.set()
    st.thread.join(60)
    st.codes = stop_children(st, STOP_DEADLINE_S)
    st.spans.restore()
    restore_env(st)
    try:
        st.report = st.traffic.ask(60, cmd="report")
    finally:
        st.traffic.close()


def rank_record(run: Run, st: State, rank: int) -> dict:
    """What this rank made, held to the references: the six numbers of
    ``probe_loop.check`` (with its node PATCHes left to rank 0), its calls
    into ``torch.distributed`` against the plan, and each cycle's
    collective outputs and verdicts; the program's own cycles (its spans)."""
    from k8s_watcher_tpu_torch.probe import spans as program

    cycles = sorted((r for r in st.spans.ranges if r.name == CYCLE), key=lambda r: r.t0)
    record = {"rank": rank, "joined": getattr(st.loop, "joined", None), "errors": [repr(e) for e in st.errors],
              "cycles": [], "program": []}
    if cycles:
        mine = State()
        # the node's PATCHes are the traffic's, counted once; the end-to-end numbers are rank 0's window's
        mine.__dict__.update(vars(st), report={}, setup_s=None)
        w = {"w0": cycles[0].t0, "w1": cycles[-1].t1, "cycles": len(cycles)}
        outcome = probe_loop.check(run, mine, w)
        record["checks"] = {c.name: c.value for c in outcome.checks if c.name != "node_patches"}
    off = 0
    for k, c in enumerate(cycles):
        inside = [r for r in st.spans.ranges if r.tid == c.tid and c.t0 <= r.t0 and r.t1 <= c.t1]
        calls = {kind: sum(r.work.get(kind, 0) for r in inside) for kind in COLLECTIVES.values()}
        want = st.rank_plan.calls(rank, first=k == 0)
        off += sum(abs(calls[kind] - want[kind]) for kind in want)
        entry = {"t0": c.t0, "t1": c.t1, "healthy": c.work.get("healthy"), "calls": calls}
        for r in inside:
            for key in ("allreduce_gap", "pair_gap", "links_wrong", "gather", "ici_reading", "link_hops"):
                if key in r.work:
                    entry[key] = r.work[key]
        record["cycles"].append(entry)
    record["collectives_off_plan"] = off
    tid = cycles[0].tid if cycles else None
    for c in program.cycles_between(cycles[0].t0, cycles[-1].t1) if cycles else ():
        if c.span.thread != tid:
            continue
        ici = c.named("probe.ici")
        record["program"].append({"start": c.start, "end": c.end, "ici_start": ici[0].start if ici else None,
                                  "votes": len(c.named(VOTE)), "stages_ms": c.stages_ms(),
                                  "collectives": c.counters.get("collectives")})
    if run.device.type == "cuda":
        import torch

        record["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(run.device))
    record["forbidden_modules"] = forbidden_modules()
    return record


def stopped_apart(records: dict, codes: dict) -> int:
    """Ranks whose last cycle is not rank 0's: their record is missing,
    their process did not exit 0 or their loop did not join, or they ran
    another number of cycles or of stop votes than rank 0."""
    first = records.get(0)
    apart = 0 if first and first["joined"] else 1
    for rank, rec in records.items():
        if rank == 0:
            continue
        if (rec is None or codes.get(rank) != 0 or not rec["joined"] or first is None
                or len(rec["cycles"]) != len(first["cycles"])
                or sum(c["votes"] for c in rec["program"]) != sum(c["votes"] for c in first["program"])):
            apart += 1
    return apart


def gather_off(records: dict) -> int:
    """Rows of every rank's findings gather that differ from what their
    rank put in, the ranks' cycles taken in step; a cycle with no gather
    counts one."""
    from portbench.reference.ranks import gathered_rows_off

    ranks = sorted(records)
    if any(records[r] is None for r in ranks):
        return len(ranks)
    off = 0
    for k in range(min(len(records[r]["cycles"]) for r in ranks)):
        got = [records[r]["cycles"][k].get("gather") for r in ranks]
        if any(g is None for g in got):
            off += 1
            continue
        inputs = [g[0] for g in got]
        off += sum(gathered_rows_off(inputs, rows) for _, rows in got)
    return off


def check(run: Run, st: State, w: dict) -> Outcome:
    n = run.config["ranks"]
    records = {0: rank_record(run, st, 0)}
    for rank, proc in st.children:
        path = os.path.join(run.workdir, f"rank{rank}.json")
        records[rank] = None
        if os.path.isfile(path):
            with open(path) as fh:
                records[rank] = json.load(fh)
    for rank, proc in st.children:
        if records[rank] is None or st.codes.get(rank) != 0:
            run.say(f"rank {rank} log", log_tail(run, rank))
    # rank 0's process is the harness's, which checks its own
    loaded = {r: rec["forbidden_modules"] for r, rec in records.items() if r and rec and rec["forbidden_modules"]}
    if loaded:
        raise RunError(f"modules of JAX or the JAX package are loaded in ranks' processes: {loaded}")
    present = [r for r in records.values() if r is not None and "checks" in r]
    limits = run.workload["limits"]

    def worst(name, combine, missing):
        values = [r["checks"][name] for r in present]
        return combine(values) + (missing if len(present) < n else 0) if values else missing

    def per_cycle(key):
        values = [c[key] for r in present for c in r["cycles"] if key in c]
        return values, sum(1 for r in present for c in r["cycles"] if key not in c)

    ar, ar_missing = per_cycle("allreduce_gap")
    pairs, pairs_missing = per_cycle("pair_gap")
    walks, walks_missing = per_cycle("links_wrong")
    calls = worst("calls_off_plan", sum, 1.0) + sum(r["collectives_off_plan"] for r in present)
    checks = [
        Check("calls_off_plan", float(calls), 0.0),
        Check("read_sweep_gap", worst("read_sweep_gap", max, 1.0), 0.0),
        Check("block_sums_gap", worst("block_sums_gap", max, 1.0), 0.0),
        Check("gemm_chain_gap", worst("gemm_chain_gap", max, 1.0), limits["gemm_chain_gap"]),
        Check("verdicts_wrong", worst("verdicts_wrong", sum, 1.0), 0.0),
        Check("node_patches", float(st.report.get("patches", 0)), 0.0),
        Check("allreduce_gap", max(ar) if ar and not ar_missing else 1.0, limits["allreduce_gap"]),
        Check("pair_gap", max(pairs) if pairs and not pairs_missing else 1.0, limits["pair_gap"]),
        Check("gather_rows_off", float(gather_off(records)), float(limits["gather_rows_off"])),
        Check("link_verdicts_wrong", float(sum(walks) + walks_missing + (0 if walks else 1)),
              float(limits["link_verdicts_wrong"])),
        Check("ranks_stopped_apart", float(stopped_apart(records, st.codes)), float(limits["ranks_stopped_apart"])),
    ]
    w0, w1 = w["w0"], w["w1"]
    first = records[0]["cycles"]
    in_window = [k for k, c in enumerate(first) if w0 < c["t1"] <= w1]
    failed = sum(1 for k in in_window
                 if any(r is None or k >= len(r["cycles"]) or not r["cycles"][k]["healthy"] for r in records.values()))
    run.say("ranks run", {
        "cycles": {r: len(rec["cycles"]) if rec else None for r, rec in records.items()},
        "unhealthy": {r: sum(1 for c in rec["cycles"] if not c["healthy"]) if rec else None
                      for r, rec in records.items()},
        "exit_codes": st.codes, "joined": {r: rec["joined"] if rec else None for r, rec in records.items()},
        "memory_peak_bytes": {r: rec.get("memory_peak_bytes") if rec else None for r, rec in records.items()},
        "stages_ms": {r: mean_stages(rec, w0, w1) if rec else None for r, rec in records.items()},
        "readings": {r: median_readings(rec, w0, w1) if rec else None for r, rec in records.items()},
        "errors": {r: rec["errors"] if rec else None for r, rec in records.items()},
    })
    return Outcome(
        end_to_end={"probe_cycle_ms": 1e3 * (w1 - w0) / w["cycles"], "setup_s": st.setup_s},
        checks=checks, attempted=w["cycles"], failed=failed,
        observation={"spans": st.spans, "window": (w0, w1),
                     "rank_cycles": [records[r]["program"] if records[r] else None for r in sorted(records) if r],
                     "collective_plan": {"n": n, "payload_bytes": settings(run)["payload_bytes"]}},
    )


def mean_stages(record: dict, w0: float, w1: float) -> dict:
    """The mean ms of each stage over the rank's cycles that overlap the
    window (rank 0's)."""
    inside = [c["stages_ms"] for c in record["program"] if c["end"] > w0 and c["start"] < w1]
    names = sorted({k for s in inside for k in s})
    return {k: sum(s.get(k, 0.0) for s in inside) / len(inside) for k in names} if inside else {}


def median_readings(record: dict, w0: float, w1: float) -> dict:
    """The program's own readings over the rank's cycles in the window
    (rank 0's), each the median: the chain's round and the payload's bus
    bandwidth (``IciProbeResult``), and each link's hop where this rank owns
    the link (``LinkResult.rtt_ms``), in ms and GB/s."""
    inside = [c for c in record["cycles"] if w0 < c["t1"] <= w1]
    out = {}
    for key in ("chain_round_ms", "bus_gbps"):
        values = [c["ici_reading"][key] for c in inside if "ici_reading" in c]
        if values:
            out[key] = statistics.median(values)
    for name in sorted({k for c in inside for k in c.get("link_hops", {})}):
        out[f"hop_ms {name}"] = statistics.median(c["link_hops"][name] for c in inside
                                                  if name in c.get("link_hops", {}))
    return out


def child(spec_path: str, rank: int) -> int:
    """Rank ``rank`` of the group, in a process of its own, until its loop
    has stopped; its record is written to the run's directory."""
    with open(spec_path) as fh:
        spec = json.load(fh)
    import torch

    device = torch.device("cuda", rank) if spec["device"] == "cuda" else torch.device("cpu")
    run = Run(spec["cell"], spec["config"], spec["workload"], spec["seed"],
              spec["seconds"], False, device, spec["workdir"], spec["start"],
              expected_platform=spec["expected_platform"], control=spec["control"])
    st = State()
    for signum in (signal.SIGINT, signal.SIGTERM):
        signal.signal(signum, lambda *_: getattr(st, "stop", threading.Event()).set())
    config = rank_config(run, spec["ports"])
    instrument_rank(run, st, rank)
    start_loop(run, st, config, on_thread=False)
    st.spans.restore()
    record = rank_record(run, st, rank)
    path = os.path.join(run.workdir, f"rank{rank}.json")
    with open(path + ".part", "w") as fh:
        json.dump(record, fh, default=str)
    os.replace(path + ".part", path)
    return 0 if not st.errors else 1


if __name__ == "__main__":
    sys.exit(child(sys.argv[1], int(sys.argv[2])))
