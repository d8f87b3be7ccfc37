"""Probe-agent soak on the GPU: the AGENT LOOP held on the card for many
cycles, not just one-shot probes (the JAX package's ``scripts/probe_soak.py``).

Runs ``ProbeAgent`` (GEMM + HBM read/write + trend; links and multislice off:
they need more than one GPU) at a short cadence for ``--minutes`` on the card,
then writes an artifact recording:

- completed cycle count and how many were healthy,
- trend state per metric: frozen healthy anchor vs recent median,
- trend alerts raised (a healthy card must produce ZERO false alerts),
- per-cycle reading medians and spread (``bands``).

The probe runs at measurement settings, not production's: a 4096 x 128-chain
bf16 GEMM (~17.6 TFLOP per timed call, captured as one CUDA graph) and
128 MiB HBM buffers (256 passes per timed call).

    python -m k8s_watcher_tpu_torch.probe_soak --minutes 10 --out soak.json

It runs on the GPU and raises without CUDA; ``--device cpu`` runs the
kernels' plain versions on the CPU, for tests. Besides the artifact it prints
one ``soak device:`` line: each cycle's kernel launches and GEMM device time,
and the peak device memory the run allocated. Exit code 0 when the soak
passes, 1 when it does not.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import statistics
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from k8s_watcher_tpu_torch.config import TpuConfig
from k8s_watcher_tpu_torch.kernels import build
from k8s_watcher_tpu_torch.probe.agent import ProbeAgent
from k8s_watcher_tpu_torch.probe.device import resolve_device

DEFAULT_OUT = Path(__file__).resolve().parent.parent / "artifacts" / "probe_soak_gpu.json"
#: how often the soak prints its progress
PROGRESS_S = 5.0


def soak_config(interval: float) -> TpuConfig:
    """The soak's probe settings: the JAX package's soak config as it is."""
    return TpuConfig(
        backend="tpu",
        probe_enabled=True,
        probe_interval_seconds=interval,
        probe_payload_bytes=4 * 1024 * 1024,
        # device time per timed call must dwarf the host fence: the
        # 4096 x 128-chain (~17.6 TFLOP per timed call) reads near peak with
        # a small spread, where lighter GEMMs read dispatch noise
        probe_matmul_size=4096,
        probe_matmul_inner_iters=128,
        probe_hbm_bytes=128 * 1024 * 1024,
        probe_links_enabled=False,       # 1 GPU: no links to walk
        probe_multislice_enabled=False,  # 1 slice: no cross-slice walk
        probe_trend_enabled=True,
        probe_trend_window=16,
        probe_trend_recent=3,
        probe_trend_min_history=6,
    )


def band(cycles: List[Dict[str, Any]], key: str) -> Dict[str, float]:
    """Median, min, max and spread of a positive per-cycle reading."""
    vals = [c[key] for c in cycles if isinstance(c.get(key), (int, float)) and c[key] > 0]
    if not vals:
        return {}
    return {
        "median": round(statistics.median(vals), 2),
        "min": round(min(vals), 2),
        "max": round(max(vals), 2),
        "spread_pct": round(100.0 * (max(vals) - min(vals)) / statistics.median(vals), 1),
    }


def run_soak(config: TpuConfig, minutes: float, device=None,
             out: Optional[Path | str] = None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The agent loop at ``config``'s cadence for ``minutes`` on ``device``
    (this rank's GPU by default; raises without CUDA unless ``device`` is
    ``"cpu"``). Writes the artifact to ``out`` when given. Returns the
    artifact and what the ``soak device:`` line prints."""
    device = resolve_device(device)
    reports: list = []
    reports_lock = threading.Lock()

    def sink(notification) -> None:
        # the agent reports through the dispatcher path in production;
        # here the payloads land in-process for the artifact
        with reports_lock:
            reports.append(notification.payload)

    beats: list = []
    agent = ProbeAgent(
        config, environment="soak", sink=sink, device=device,
        # the platform contract is the device's own: a CPU run is asked for
        expected_platform="cuda" if device.type == "cuda" else "cpu",
        heartbeat=lambda: beats.append(time.monotonic()),
    )

    cycles: List[Dict[str, Any]] = []
    per_cycle: List[Dict[str, Any]] = []
    last_counts = [build.launch_counts()]

    def observer(report) -> None:
        # on the agent thread, after the cycle: the launches since the last
        # cycle are this cycle's
        counts = build.launch_counts()
        launches = {k: v - last_counts[0].get(k, 0) for k, v in counts.items()}
        last_counts[0] = counts
        cycles.append({
            "healthy": report.healthy,
            "duration_ms": round(report.duration_ms, 1),
            "mxu_tflops_median": (report.mxu or {}).get("tflops_median"),
            "hbm_read_gbps": (report.hbm or {}).get("read_gbps"),
            "hbm_write_gbps": (report.hbm_write or {}).get("write_gbps"),
            "psum_rtt_ms": report.ici.psum_rtt_ms if report.ici else None,
            "trend_alerts": [
                dataclasses.asdict(a) if dataclasses.is_dataclass(a) else str(a)
                for a in (report.trend_alerts or [])
            ],
        })
        per_cycle.append({"launches": launches, "gemm_ms_median": (report.mxu or {}).get("time_median_ms")})

    agent.report_observer = observer
    # the one-rank group the agent's first cycle starts is the soak's to
    # tear down (a group left to the interpreter's exit aborts it)
    owns_group = not dist.is_initialized()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    t0 = time.monotonic()
    deadline = t0 + 60.0 * minutes
    print(f"soak: {minutes} min at {config.probe_interval_seconds}s cadence on {device}...", flush=True)
    agent.start()
    try:
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            time.sleep(min(PROGRESS_S, left))
            print(f"  {((time.monotonic() - t0) / 60.0):.1f} min, {len(cycles)} cycles", flush=True)
    finally:
        joined = agent.stop()
        if owns_group and joined and dist.is_initialized():
            dist.destroy_process_group()
    wall_minutes = (time.monotonic() - t0) / 60.0

    healthy = [c for c in cycles if c["healthy"]]
    alerts = [a for c in cycles for a in c["trend_alerts"]]
    trend_state = agent.trend.snapshot() if agent.trend is not None else {}
    artifact = {
        "timestamp_utc": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "wall_minutes": round(wall_minutes, 2),
        "cadence_seconds": config.probe_interval_seconds,
        "cycles_completed": len(cycles),
        "cycles_healthy": len(healthy),
        "heartbeats": len(beats),
        "trend_alerts_raised": len(alerts),
        "trend_alerts": alerts[:20],
        "trend_state": trend_state,
        "bands": {
            "mxu_tflops_median": band(cycles, "mxu_tflops_median"),
            "hbm_read_gbps": band(cycles, "hbm_read_gbps"),
            "hbm_write_gbps": band(cycles, "hbm_write_gbps"),
            "cycle_duration_ms": band(cycles, "duration_ms"),
        },
        "reports_sunk": len(reports),
        "ok": (
            len(cycles) >= 10
            and len(healthy) == len(cycles)
            and len(alerts) == 0
            and wall_minutes >= minutes * 0.99
        ),
    }
    if out is not None:
        out = Path(out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(artifact, indent=2) + "\n")
    on_card = device.type == "cuda"
    return artifact, {
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "max_memory_allocated": torch.cuda.max_memory_allocated(device) if on_card else None,
        "cycles": per_cycle,
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--minutes", type=float, default=10.0)
    parser.add_argument("--interval", type=float, default=10.0, help="seconds between cycles (cadence)")
    parser.add_argument("--out", default=str(DEFAULT_OUT))
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="default: this rank's GPU (raises without CUDA); cpu is for tests")
    args = parser.parse_args(argv)

    artifact, on_device = run_soak(soak_config(args.interval), args.minutes, args.device, args.out)
    print("soak device: " + json.dumps(on_device))
    print(json.dumps({k: v for k, v in artifact.items() if k not in ("trend_state", "trend_alerts")}, indent=2))
    print(f"artifact: {args.out}")
    print(f"soak: {'PASS' if artifact['ok'] else 'FAIL'}")
    return 0 if artifact["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
