"""One run of one cell: find its files by name, set up, measure, check, print.

The sequence, the same for every cell:

1. ``BENCHMARK.json``'s cell names its configuration (``configs/<config>.json``)
   and its workload (``workloads/<cell>.json``), which names its driver
   (``drivers/<driver>.py``);
2. the driver's ``setup(run)`` builds the system under test and warms up
   every shape the window uses; ``setup_s`` runs from the process's start to
   the window's;
3. the driver's ``window(run, state)`` measures for ``--seconds`` (under
   ``torch.profiler`` with ``--trace 1``), then ``memory_peak_bytes`` is read;
4. the driver's ``finish(run, state)`` stops the system and frees its state,
   and ``check(run, state)`` compares what the window produced with the plain
   reference;
5. with ``--trace 0`` the cell's end-to-end metrics are reported, with
   ``--trace 1`` its per-layer metrics, each read by ``metrics/<name>.py``;
6. no module of JAX or of the JAX package may be loaded by then.

The last lines on standard error are the numbers compared, each beside its
limit; the last line on standard output is the result.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

from portbench import hostcpu

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PACKAGE_DIR)
# compared with each loaded module's top-level name, whole
FORBIDDEN = ("jax", "jaxlib", "flax", "k8s_watcher_tpu")
# the program's kernel caches, at fixed paths inside the checkout
CACHE_DIR = os.path.join(ROOT, ".portbench_cache")


class RunError(Exception):
    """The run cannot give a result: it exits non-zero and prints none."""


def forbidden_modules(names=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def load_json(*parts) -> dict:
    path = os.path.join(PACKAGE_DIR, *parts)
    if not os.path.isfile(path):
        raise RunError(f"missing {os.path.relpath(path, ROOT)}")
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.isfile(path):
        raise RunError("no BENCHMARK.json at the checkout's root")
    with open(path) as fh:
        return json.load(fh)


def cell_metrics(bench: dict, cell: str) -> tuple:
    """``(end_to_end, per_layer)``: the metric entries this cell reports."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def load_reader(name: str):
    """``metrics/<name>.py``'s ``read(observation)``."""
    path = os.path.join(PACKAGE_DIR, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        raise RunError(f"no reader for the per-layer metric {name} (portbench/metrics/{name}.py)")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit: the run is
    correct when ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Run:
    """What a driver is given: the cell, its files, the arguments, where the
    program runs, and the run's scratch directory."""

    cell: str
    config: dict
    workload: dict
    seed: int
    seconds: float
    trace: bool
    device: object  # a torch.device; the CPU in the benchmark's own tests
    workdir: str
    start: float  # the process's start, monotonic
    expected_platform: str = "auto"
    traffic_cpus: list = None  # where the traffic process runs (hostcpu.py); None: anywhere
    control: bool = False  # the driver's control in the program's place (control.py)

    def say(self, label: str, body) -> None:
        print(f"{label}: {json.dumps(body, default=str)}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Outcome:
    """What a driver's run produced, for the harness to report."""

    end_to_end: dict  # metric name -> value (trace 0)
    checks: list  # Check
    attempted: int
    failed: int
    observation: dict = dataclasses.field(default_factory=dict)  # what the per-layer readers read
    memory_peak_bytes: int = 0


def drive(run: Run) -> Outcome:
    """Steps 2-4 of the module's sequence, for any driver."""
    from portbench.devtrace import Profiled

    driver = importlib.import_module(f"portbench.drivers.{run.workload['driver']}")
    if run.trace and run.device.type == "cuda":
        from portbench.devtrace import warm_profiler

        warm_profiler(run)
    state = driver.setup(run)
    try:
        with Profiled(run.trace, os.path.join(run.workdir, "trace.json")) as prof:
            window = driver.window(run, state)
        memory = 0
        if run.device.type == "cuda":
            import torch

            memory = int(torch.cuda.max_memory_allocated(run.device))
    finally:
        driver.finish(run, state)
    if run.trace:
        run.say("profiler", {"start_s": getattr(prof, "start_s", None)})
        if prof.trace is not None and "w0" in window:
            # the per-layer window is the measured one, inside the traced span
            prof.trace.window = (max(prof.trace.window[0], window["w0"]), min(prof.trace.window[1], window["w1"]))
    outcome = driver.check(run, state, window)
    outcome.memory_peak_bytes = memory
    outcome.observation["device_trace"] = prof.trace
    return outcome


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def parse_args(argv):
    parser = argparse.ArgumentParser(prog="python3 -m portbench.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), required=True)
    return parser.parse_args(argv)


def measure(cell_name: str, seed: int, seconds: float, trace: bool, start: float, control: bool = False):
    """One run of ``cell_name`` on this machine's first GPU: ``(result line,
    outcome)``; with ``control``, the driver's control runs in the program's
    place."""
    bench = benchmark()
    cell = {w["name"]: w for w in bench["workloads"]}.get(cell_name)
    if cell is None:
        raise RunError(f"no cell {cell_name} in BENCHMARK.json")
    workload = load_json("workloads", f"{cell_name}.json")
    config = load_json("configs", f"{cell['config']}.json")
    e2e, layer = cell_metrics(bench, cell_name)
    readers = {m["name"]: load_reader(m["name"]) for m in layer} if trace else {}
    os.makedirs(CACHE_DIR, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    program_cpus, traffic_cpus = hostcpu.split()
    if program_cpus:
        os.sched_setaffinity(0, program_cpus)  # before torch or the program makes a thread
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        raise RunError(f"the cell needs {cell['chips']} CUDA device(s); torch sees "
                       f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(device)
    with tempfile.TemporaryDirectory(prefix="portbench-") as workdir:
        run = Run(cell_name, config, workload, seed, seconds, trace, device, workdir, start,
                  traffic_cpus=traffic_cpus, control=control)
        run.say("device", {"name": name, "power_limit": power_limit(), "cell": cell_name, "seed": seed,
                           "seconds": seconds, "trace": int(trace), "program_cpus": program_cpus,
                           "traffic_cpus": traffic_cpus, "control": control})
        outcome = drive(run)
    loaded = forbidden_modules()
    if loaded:
        raise RunError(f"modules of JAX or the JAX package are loaded: {loaded}")
    device_info = {"platform": "gpu", "kind": name, "count": cell["chips"]}
    return report(outcome, e2e, readers, bench, device_info, int(trace)), outcome


def main(argv, start: float, control: bool = False) -> int:
    args = parse_args(argv)
    try:
        result, outcome = measure(args.workload, args.seed, args.seconds, bool(args.trace), start, control)
    except RunError as exc:
        print(f"portbench: {exc}", file=sys.stderr, flush=True)
        return 2
    for c in outcome.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def report(outcome: Outcome, e2e: list, readers: dict, bench: dict, device: dict, trace: int) -> dict:
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    trace_obj = outcome.observation.get("device_trace")
    device = dict(device, memory_peak_bytes=outcome.memory_peak_bytes)
    breakdown = None
    if trace:
        if trace_obj is None:
            raise RunError("the traced run holds no device trace")
        busy, (w0, w1) = trace_obj.busy_s(), trace_obj.window
        if busy <= 0:
            raise RunError("no operation ran on the device in the traced window")
        device.update(busy_s=busy, window_s=w1 - w0)
        for name, read in readers.items():
            value = read(outcome.observation)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        ranges = outcome.observation.get("spans").ranges if outcome.observation.get("spans") else []
        breakdown = {"device_ops": trace_obj.top_ops(), "idle_gaps": trace_obj.idle_gaps(ranges)}
    else:
        for m in e2e:
            if m["name"] not in outcome.end_to_end:
                raise RunError(f"the driver measured no {m['name']}")
            metrics[m["name"]] = {"value": outcome.end_to_end[m["name"]], "unit": m["unit"]}
    result = {"correct": all(c.ok for c in outcome.checks), "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return result
