#!/usr/bin/env python3
"""Where a steady-state probe cycle of the PyTorch port spends its time on one GPU.

Usage: ``python3 scripts/torch_cycle_trace.py [--cycles N] [--out DIR]`` from
the root of a checkout, on a machine with a CUDA GPU.

Runs three untraced cycles with the ``production`` probe settings (the first
sets the process up), then ``N`` cycles (default 3) with
``tpu.probe.profile_dir`` set, so the agent itself writes one
``torch.profiler`` chrome trace per cycle (``--out``, default ``_traces/`` in
the checkout, git-ignored), then two more untraced cycles. From each trace it
reads the device work (kernels, copies, sets: the union of their intervals)
and prints one JSON line per cycle: the cycle's ``duration_ms``, the device's
busy time and idle share over it, and device time by kernel name. The
untraced cycles after the first give the profiler's cost. Exits 1 when a
trace holds no device work, or on a machine with no GPU.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_intervals(trace: dict) -> list:
    """(start_us, end_us, name) of every device event of a chrome trace."""
    out = []
    for event in trace.get("traceEvents", []):
        if event.get("ph") == "X" and event.get("cat") in DEVICE_CATEGORIES:
            start = float(event["ts"])
            out.append((start, start + float(event.get("dur", 0.0)), event.get("name", "?")))
    return out


def union_us(intervals: list) -> float:
    """Length of the union of ``(start, end, _)`` intervals."""
    total, end = 0.0, float("-inf")
    for start, stop, _ in sorted(intervals):
        if start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def main(argv: list) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script measures a GPU", file=sys.stderr)
        return 1
    cycles = int(argv[argv.index("--cycles") + 1]) if "--cycles" in argv else 3
    out_dir = Path(argv[argv.index("--out") + 1] if "--out" in argv else REPO / "_traces")
    sys.path.insert(0, str(REPO))
    from k8s_watcher_tpu_torch.config import load_config
    from k8s_watcher_tpu_torch.probe.agent import PROFILE_PREFIX, PROFILE_SUFFIX, ProbeAgent

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"nvidia-smi: {smi.stdout.strip()}")
    dev = torch.device("cuda", 0)
    config = load_config("production", REPO / "config")
    plain = ProbeAgent(config, environment="production", sink=lambda n: None, device=dev)
    untraced = [plain.run_once().duration_ms for _ in range(3)][1:]  # the first sets up the process

    out_dir.mkdir(parents=True, exist_ok=True)
    for stale in out_dir.glob(f"{PROFILE_PREFIX}*{PROFILE_SUFFIX}"):
        stale.unlink()
    traced_agent = ProbeAgent(dataclasses.replace(config, probe_profile_dir=str(out_dir)),
                              environment="production", sink=lambda n: None, device=dev)
    reports = [traced_agent.run_once() for _ in range(cycles)]
    untraced += [plain.run_once().duration_ms for _ in range(2)]
    traces = sorted(out_dir.glob(f"{PROFILE_PREFIX}*{PROFILE_SUFFIX}"))[-cycles:]
    if len(traces) != cycles:
        print(f"expected {cycles} traces under {out_dir}, found {len(traces)}", file=sys.stderr)
        return 1

    rows = []
    for report, path in zip(reports, traces):
        intervals = device_intervals(json.loads(path.read_text()))
        if not intervals:
            print(f"{path.name}: no device events: the profiler did not trace the card", file=sys.stderr)
            return 1
        by_name = collections.Counter()
        for start, stop, name in intervals:
            by_name[name[:60]] += (stop - start) / 1e3
        busy_ms = union_us(intervals) / 1e3
        row = {
            "trace": os.path.relpath(path, REPO),
            "healthy": report.healthy,
            "duration_ms": report.duration_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / report.duration_ms,
            "device_events": len(intervals),
            "device_ms_by_kernel": dict(by_name.most_common(8)),
        }
        rows.append(row)
        print(json.dumps(row))
    print(json.dumps({
        "traced_duration_ms_median": statistics.median(r["duration_ms"] for r in rows),
        "untraced_duration_ms": untraced,
        "untraced_duration_ms_median": statistics.median(untraced),
        "device_idle_share_median": statistics.median(r["device_idle_share"] for r in rows),
        "device": torch.cuda.get_device_name(0),
    }))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0 if all(r["healthy"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
