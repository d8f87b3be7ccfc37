"""The probe DaemonSet's loop: ``probe_agent.run_loop`` with the cell's
settings, its cycles back to back.

The window opens at the end of a cycle and closes at the end of the first
cycle that ends ``--seconds`` later: ``probe_cycle_ms`` is its length over the
cycles in it. What each cycle is defined to do comes from the configuration's
``shipped`` settings (``portbench.reference.probe.cycle_plan``), not from the
program. Every call of the HBM entries and every GEMM graph launch is counted
against that plan; every read-sweep total and block-sum vector is kept, and
the GEMM chain's output of the cycles drawn by ``--seed``; once the loop has
stopped they are held to ``portbench.reference.probe``. The stages' inputs are
their own fixed patterns, so the seed changes nothing else.

With ``run.control`` the plain reference takes the program's place one step
below the stated precision: the read sweep and the block sums in bfloat16,
the GEMM chain in float8.
"""

from __future__ import annotations

import os
import random
import threading
import time

from portbench.harness import Check, Outcome
from portbench.spans import Spans

CYCLE = "probe.cycle"
GEMM_SAMPLE = 1 / 8  # share of the cycles whose GEMM output is compared, after the first


def stage(name: str) -> str:
    return f"probe.agent.{name}"


class State:
    pass


def settings(run) -> dict:
    """``tpu.probe``'s sizes as the configuration states them, with a run's
    own overlay (the CPU tests' small sizes)."""
    overlay = ((run.workload.get("overlay") or {}).get("tpu") or {}).get("probe") or {}
    return {**run.config["shipped"], **overlay}


def substitute(spans: Spans, kernels, ici_mod) -> None:
    """The control: the reference, one step below the stated precision, in
    the places of the read sweep, the block sums and the GEMM chain."""
    import torch

    from portbench.reference.probe import block_sums_in, gemm_chain, read_sweep_in

    def read_sweep(x, repeats, *, timer=None):
        t0 = time.perf_counter()
        out = read_sweep_in(x, repeats, torch.bfloat16)
        if timer is not None:
            torch.cuda.synchronize(x.device)
            timer.value = 1e3 * (time.perf_counter() - t0)
        return out

    spans.replace(kernels, "read_sweep", read_sweep)
    spans.replace(kernels, "blocksums", lambda x: block_sums_in(x, torch.bfloat16))
    spans.replace(ici_mod, "mxu_chain", lambda a, b, inner_iters, inv_scale: gemm_chain(a, b, inner_iters, fp8=True))


def arg(args, kwargs, i: int, name: str):
    return args[i] if len(args) > i else kwargs[name]


def instrument(spans: Spans, plan, take_gemm, control: bool = False) -> None:
    """The cycle and its stages as ranges, the work each stage is defined to
    do, every call of the HBM entries with its sizes, and the outputs."""
    import k8s_watcher_tpu_torch.probe.agent as agent_mod
    import k8s_watcher_tpu_torch.probe.ici as ici_mod
    from k8s_watcher_tpu_torch.kernels import hbm as kernels

    if control:
        substitute(spans, kernels, ici_mod)

    def note(rng, key, item):
        if rng is not None:
            rng.work.setdefault(key, []).append(item)

    def cycle_done(rng, args, kwargs, report):
        rng.work.update(healthy=bool(report.healthy),
                        read_ok=bool((report.hbm or {}).get("integrity_ok")),
                        write_ok=bool((report.hbm_write or {}).get("integrity_ok")))

    def read_done(rng, args, kwargs, out):
        if out.get("bytes"):
            rng.work["bytes"] = plan.read_bytes

    def write_done(rng, args, kwargs, out):
        if out.get("bytes"):
            rng.work["bytes"] = plan.write_bytes

    def mxu_done(rng, args, kwargs, out):
        chain = rng.work.pop("chain_out", None)
        if out.get("size"):
            rng.work["flops"] = plan.gemm_flops
        # the first cycle's output and a share drawn from the seed, copied
        # once the stage is over: the graph's launches wrote it last
        if chain is not None and take_gemm():
            rng.work["gemm_out"] = chain.detach().to("cpu", copy=True)

    spans.wrap(agent_mod.ProbeAgent, "run_once", CYCLE, cycle_done)
    spans.wrap(agent_mod, "run_ici_probe", stage("run_ici_probe"))
    spans.wrap(agent_mod, "run_mxu_probe", stage("run_mxu_probe"), mxu_done)
    spans.wrap(agent_mod, "run_hbm_probe", stage("run_hbm_probe"), read_done)
    spans.wrap(agent_mod, "run_hbm_write_probe", stage("run_hbm_write_probe"), write_done)
    spans.hook(ici_mod, "graph_times_ms", lambda rng, a, kw, times: note(rng, "graph_launch", len(times)))
    spans.hook(ici_mod, "mxu_chain", lambda rng, a, kw, out: rng is not None and rng.work.update(chain_out=out))
    spans.hook(kernels, "read_sweep", lambda rng, a, kw, out: note(
        rng, "read_sweep", (out, arg(a, kw, 0, "x").shape[0], arg(a, kw, 1, "repeats"))))
    spans.hook(kernels, "fill", lambda rng, a, kw, out: note(
        rng, "fill", (arg(a, kw, 1, "num_blocks"), arg(a, kw, 2, "repeats"))))
    spans.hook(kernels, "blocksums", lambda rng, a, kw, out: note(rng, "blocksums", out))


def setup(run) -> State:
    from portbench.traffic.server import TrafficProcess

    st = State()
    st.traffic = TrafficProcess({"node_names": [run.config["process_env"]["NODE_NAME"]]}, run.traffic_cpus)
    try:
        return start(run, st)
    except BaseException:
        if getattr(st, "stop", None) is not None:
            st.stop.set()
            st.thread.join(60)
        st.traffic.close()
        raise


def start(run, st: State) -> State:
    os.environ.update(run.config["process_env"])
    from k8s_watcher_tpu_torch.probe_agent import run_loop

    from portbench.deploy import agent_config
    from portbench.reference.probe import cycle_plan

    ports = st.traffic.reply(120)
    config = agent_config(run.config, run.workdir, ports["api"], ports["sink"], run.workload.get("overlay"))
    st.plan = cycle_plan(settings(run), run.device.type == "cuda")
    st.spans = Spans()
    draw, taken = random.Random(f"gemm/{run.seed}"), []

    def take_gemm() -> bool:
        """The first cycle, and each later one with the chance GEMM_SAMPLE."""
        taken.append(1)
        return len(taken) == 1 or draw.random() < GEMM_SAMPLE

    instrument(st.spans, st.plan, take_gemm, control=run.control)
    st.ends = []
    st.cond = threading.Condition()

    def on_range(rng):
        if rng.name == CYCLE:
            with st.cond:
                st.ends.append(rng.t1)
                st.cond.notify_all()

    st.spans.listeners.append(on_range)
    st.stop = threading.Event()
    st.errors = []

    def loop():
        try:
            run_loop(config, "production", st.stop, device=run.device, expected_platform=run.expected_platform)
        except BaseException as exc:  # noqa: BLE001 — reported by the check, fatal to the run
            st.errors.append(exc)
            with st.cond:
                st.cond.notify_all()

    st.thread = threading.Thread(target=loop, name="probe-loop", daemon=True)
    st.thread.start()
    warm = run.workload["warm_cycles"]
    if not wait_cycles(st, warm, 600):
        raise RuntimeError(f"{len(st.ends)} of {warm} warm-up cycles in 600 s: {st.errors}")
    return st


def wait_cycles(st: State, n: int, timeout_s: float) -> bool:
    deadline = time.monotonic() + timeout_s
    with st.cond:
        while len(st.ends) < n and not st.errors:
            left = deadline - time.monotonic()
            if left <= 0:
                return False
            st.cond.wait(left)
    return len(st.ends) >= n


def window(run, st: State) -> dict:
    """From the next cycle's end to the end of the first cycle that ends
    ``seconds`` after it."""
    if not wait_cycles(st, len(st.ends) + 1, 600):
        raise RuntimeError("no cycle ended")
    first = len(st.ends) - 1
    w0 = st.ends[first]
    st.setup_s = w0 - run.start
    while True:
        if not wait_cycles(st, len(st.ends) + 1, 600):
            raise RuntimeError("the loop stopped cycling")
        if st.ends[-1] - w0 >= run.seconds:
            break
    last = len(st.ends) - 1
    return {"w0": w0, "w1": st.ends[last], "cycles": last - first}


def finish(run, st: State) -> None:
    st.stop.set()
    st.thread.join(60)
    st.spans.restore()
    try:
        st.report = st.traffic.ask(60, cmd="report")
    finally:
        st.traffic.close()


def calls_off(plan, found: dict) -> int:
    """How far one cycle's calls stray from its plan: each planned call
    missing, each one more, and each made with other sizes, counts one."""
    sizes = {"read_sweep": (plan.read_rows, plan.read_repeats), "fill": (plan.write_blocks, plan.write_repeats)}
    off = 0
    for entry, planned in plan.calls.items():
        made = found.get(entry, [])
        if entry == "graph_launch":  # launches are noted as counts, one a timing call
            count = sum(made)
        else:
            count = sum(1 for m in made if entry not in sizes or tuple(m[-2:]) == sizes[entry])
            off += len(made) - count
        off += abs(count - planned)
    return off


def check(run, st: State, w: dict) -> Outcome:
    import torch

    from portbench.reference.probe import (
        block_sums,
        gemm_chain,
        gemm_operands,
        read_totals,
        relative_norm_gap,
        worst_relative_gap,
    )

    plan = st.plan
    want_read, want_sums = read_totals(plan.read_rows, plan.read_repeats), block_sums(plan.write_blocks)
    want_gemm = gemm_chain(*gemm_operands(plan.gemm_size, run.device), plan.gemm_inner_iters).cpu().numpy()
    w0, w1 = w["w0"], w["w1"]
    cycles = sorted((r for r in st.spans.ranges if r.name == CYCLE), key=lambda r: r.t0)
    stages = [r for r in st.spans.ranges if r.name != CYCLE]
    read_gap = sums_gap = gemm_gap = 0.0
    verdicts_wrong = off = gemm_compared = 0
    for c in cycles:
        inside = [r for r in stages if r.tid == c.tid and c.t0 <= r.t0 and r.t1 <= c.t1]
        found = {}
        for r in inside:
            for key in ("read_sweep", "fill", "blocksums", "graph_launch"):
                found.setdefault(key, []).extend(r.work.get(key, ()))
        off += calls_off(plan, found)
        gaps = [worst_relative_gap(out.double().cpu().numpy(), want_read) for out, _, _ in found["read_sweep"]]
        sgaps = [worst_relative_gap(s.double().cpu().numpy(), want_sums) for s in found["blocksums"]]
        for r in inside:
            if "gemm_out" in r.work:
                gemm_gap = max(gemm_gap, relative_norm_gap(r.work["gemm_out"].to(torch.float64).numpy(), want_gemm))
                gemm_compared += 1
        read_ok = bool(gaps) and max(gaps) == 0.0
        write_ok = bool(sgaps) and max(sgaps) == 0.0
        read_gap = max([read_gap, *gaps])
        sums_gap = max([sums_gap, *sgaps])
        # on a quiet card the reference's verdict is its two integrity results
        want_healthy = read_ok and write_ok
        if (c.work.get("healthy"), c.work.get("read_ok"), c.work.get("write_ok")) != (want_healthy, read_ok, write_ok):
            verdicts_wrong += 1
    in_window = [c for c in cycles if w0 < c.t1 <= w1]
    unhealthy = sum(1 for c in in_window if not c.work.get("healthy"))
    checks = [
        Check("calls_off_plan", float(off + (0 if cycles else 1)), 0.0),
        Check("read_sweep_gap", read_gap, 0.0),
        Check("block_sums_gap", sums_gap, 0.0),
        Check("gemm_chain_gap", gemm_gap if gemm_compared else 1.0, run.workload["limits"]["gemm_chain_gap"]),
        Check("verdicts_wrong", float(verdicts_wrong + (0 if cycles else 1)), 0.0),
        Check("node_patches", float(st.report.get("patches", 0)), 0.0),
    ]
    run.say("probe run", {"cycles": len(cycles), "in_window": w["cycles"], "window_s": w1 - w0,
                          "plan": vars(plan), "gemm_outputs_compared": gemm_compared,
                          "probe_payloads": st.report.get("probe_payloads"), "errors": [repr(e) for e in st.errors]})
    return Outcome(
        end_to_end={"probe_cycle_ms": 1e3 * (w1 - w0) / w["cycles"], "setup_s": st.setup_s},
        checks=checks, attempted=w["cycles"], failed=unhealthy,
        observation={"spans": st.spans, "window": (w0, w1)},
    )
