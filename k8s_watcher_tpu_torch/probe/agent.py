"""Probe agent: the probe cycle on a cadence, reported through a sink.

The JAX package's ``probe/agent.py`` on PyTorch: the same cycle (inventory
and liveness, chained all-reduce and bus bandwidth, chained bf16 GEMM, the
per-link walk and the multislice probe where the config enables them, HBM
read sweep, HBM write with per-block integrity), the same trend gating,
gauges and flight recorder, and the same loop (``start``/``stop``, a
heartbeat per completed cycle, a report observer). Under ``torchrun`` every
rank runs the agent and joins the collectives; rank 0 reports for the
group, any other rank only when its own view is unhealthy.

In a group of several ranks every stage of a cycle is a collective, so no
rank may leave the loop alone: a rank that left would leave its peers
waiting in their next cycle's first collective. The loop's cycles end with a
stop vote instead (:meth:`ProbeAgent._stop_vote`), and every rank leaves
after the same cycle, once any of them has been asked to stop.
"""

from __future__ import annotations

import collections
import datetime
import json
import logging
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np

import torch
import torch.distributed as dist

from k8s_watcher_tpu_torch.config import TpuConfig
from k8s_watcher_tpu_torch.metrics import MetricsRegistry
from k8s_watcher_tpu_torch.pipeline.pipeline import Notification
from k8s_watcher_tpu_torch.probe import spans
from k8s_watcher_tpu_torch.probe.device import (
    all_gather_rows,
    enumerate_devices,
    host_identity,
    host_identity_map,
    node_ranks,
    process_count,
    process_index,
    resolve_device,
)
from k8s_watcher_tpu_torch.probe.hbm import run_hbm_probe, run_hbm_write_probe
from k8s_watcher_tpu_torch.probe.ici import run_ici_probe, run_mxu_probe
from k8s_watcher_tpu_torch.probe.links import run_link_probe
from k8s_watcher_tpu_torch.probe.multislice import run_multislice_probe
from k8s_watcher_tpu_torch.probe.report import ProbeReport
from k8s_watcher_tpu_torch.probe.timing import fetch_scalar
from k8s_watcher_tpu_torch.probe.trend import TrendTracker
from k8s_watcher_tpu_torch.remediate.policy import local_findings

logger = logging.getLogger(__name__)

PROFILE_PREFIX = "probe-"
PROFILE_SUFFIX = ".pt.trace.json"


# each evidence string is clipped so that a rank's findings (at most four:
# liveness, GEMM, HBM read, HBM write) fit one row of the identity wire
_FINDING_BYTES = 120


@spans.traced("probe.gather")
def gather_node_findings(report: ProbeReport, device=None) -> dict:
    """``str(rank) -> local findings`` of every rank on this rank's node that
    has any (remediate/policy.py:local_findings), from one fixed-size gather
    of every rank's own (probe/device.py:all_gather_rows). A collective:
    every rank calls it together."""
    mine = [e.encode("utf-8")[:_FINDING_BYTES].decode("utf-8", errors="ignore") for e in local_findings(report)]
    rows = all_gather_rows(json.dumps(mine, ensure_ascii=False).encode("utf-8"), device)
    hosts = report.hosts or {}
    me = process_index()
    node = node_ranks(hosts, (hosts.get(str(me)) or {}).get("node_name")) or [me]
    out = {}
    for rank in node:
        try:
            findings = json.loads(rows[rank].decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            logger.error("Rank %d's local findings did not decode: %r", rank, rows[rank][:80])
            continue
        if findings:
            out[str(rank)] = findings
    return out


class ProbeAgent:
    def __init__(
        self,
        tpu_config: TpuConfig,
        *,
        environment: str,
        sink: Callable[[Notification], None],
        metrics: Optional[MetricsRegistry] = None,
        mesh=None,
        expected_platform: Optional[str] = "auto",
        device=None,
        heartbeat: Optional[Callable[[], None]] = None,  # stamped per completed cycle
    ):
        self.config = tpu_config
        self.environment = environment
        self.sink = sink
        self.metrics = metrics or MetricsRegistry()
        self.device = resolve_device(device)
        self.mesh = mesh
        # "auto": the port's platform contract is CUDA — a probe finding only
        # the CPU reports unhealthy. Pass a platform (or None) for test runs.
        self.expected_platform = "cuda" if expected_platform == "auto" else expected_platform
        self.heartbeat = heartbeat or (lambda: None)
        self._stop = threading.Event()
        # set once the loop has ended: on this rank's stop, or on its group's
        self.stopped = threading.Event()
        self._stop_agreed = False  # the last cycle's stop vote
        self._thread: Optional[threading.Thread] = None
        # optional per-report observer (remediation): sees every completed
        # report, healthy or not, on the agent thread
        self.report_observer: Optional[Callable[..., Any]] = None
        # flight recorder: last-N cycle summaries
        self._cycles: collections.deque = collections.deque(maxlen=64)
        self._cycles_lock = threading.Lock()
        self.trend: Optional[TrendTracker] = None
        if tpu_config.probe_trend_enabled:
            self.trend = TrendTracker(
                window=tpu_config.probe_trend_window,
                recent=tpu_config.probe_trend_recent,
                drop_factor=tpu_config.probe_trend_drop_factor,
                rise_factor=tpu_config.probe_trend_rise_factor,
                min_history=tpu_config.probe_trend_min_history,
            )

    # traces retained under profile_dir: one file per cycle, so without a cap
    # a 30 s agent fills the disk of the node it is meant to keep healthy
    MAX_PROFILE_RUNS = 20

    def run_once(self, *, vote: bool = False) -> ProbeReport:
        """One probe cycle, a ``probe.cycle`` span (probe/spans.py); traced
        with ``torch.profiler`` into a chrome trace under
        ``tpu.probe.profile_dir`` when that is set, the stages' spans as
        ranges in it. The flight recorder's entry is written once the cycle
        has closed, with its spans' times and counters. With ``vote`` (the
        loop's cycles) the cycle ends with :meth:`_stop_vote`, also when a
        stage raised."""
        with spans.cycle(self.device):
            try:
                report = self._run_profiled()
            finally:
                if vote:
                    self._stop_agreed = self._stop_vote()
        self._record_cycle(report)
        return report

    def _stop_vote(self) -> bool:
        """Whether any rank of the group has been asked to stop: this rank's
        stop as a flag, all-reduced (MAX) over the default group in a
        ``probe.stop_vote`` span. Every rank of a group votes at the end of
        each of the loop's cycles, so every rank learns of a stop at the same
        cycle's end. A group of one rank has no peer to ask: its own stop
        answers, with no collective and no device work. A vote that fails
        (a peer gone) leaves this rank's own stop to answer."""
        asked = self._stop.is_set()
        if process_count() == 1:
            return asked
        with spans.span("probe.stop_vote"):
            try:
                flag = torch.full((1,), int(asked), dtype=torch.int32, device=self.device)
                spans.count("collectives")
                dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                return fetch_scalar(flag) > 0
            except Exception as exc:  # noqa: BLE001 — a broken group cannot agree; this rank decides alone
                logger.error("The probe group's stop vote failed: %s", exc)
                return asked

    def _run_profiled(self) -> ProbeReport:
        if not self.config.probe_profile_dir:
            return self._run_once_inner()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            report = self._run_once_inner()
        out_dir = Path(self.config.probe_profile_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        stamp = datetime.datetime.now(datetime.timezone.utc).strftime("%Y%m%dT%H%M%S.%f")
        prof.export_chrome_trace(str(out_dir / f"{PROFILE_PREFIX}{stamp}{PROFILE_SUFFIX}"))
        self._prune_profiles(out_dir)
        return report

    def _prune_profiles(self, profile_dir: Path) -> None:
        """Keep only the newest MAX_PROFILE_RUNS traces."""
        runs = sorted(p for p in profile_dir.glob(f"{PROFILE_PREFIX}*{PROFILE_SUFFIX}") if p.is_file())
        for stale in runs[: -self.MAX_PROFILE_RUNS]:
            try:
                stale.unlink()
            except OSError as exc:
                logger.warning("Could not prune old probe trace %s: %s", stale, exc)

    def _run_once_inner(self) -> ProbeReport:
        t0 = time.monotonic()
        devices = enumerate_devices(
            self.device,
            expected_per_host=self.config.expected_chips_per_host,
            expected_platform=self.expected_platform,
        )
        ici = run_ici_probe(self.mesh, payload_bytes=self.config.probe_payload_bytes, device=self.device)
        mxu = run_mxu_probe(
            self.config.probe_matmul_size,
            inner_iters=self.config.probe_matmul_inner_iters,
            device=self.device,
        )
        links = None
        if self.config.probe_links_enabled:
            links = run_link_probe(
                self.mesh,
                rtt_factor=self.config.probe_link_rtt_factor,
                rtt_floor_ms=self.config.probe_link_rtt_floor_ms,
                device=self.device,
            )
        multislice = None
        if self.config.probe_multislice_enabled:
            # the (slices, hosts, gpus) grid has its own shape, built from the
            # ranks per node, not from self.mesh
            multislice = run_multislice_probe(
                n_slices=self.config.probe_multislice_slices or None,
                pair_localization=self.config.probe_multislice_pair_localization,
                device=self.device,
            )
        hbm = None
        hbm_write = None
        if self.config.probe_hbm_bytes > 0:
            hbm = run_hbm_probe(self.config.probe_hbm_bytes, device=self.device)
            if self.config.probe_hbm_write_enabled:
                hbm_write = run_hbm_write_probe(self.config.probe_hbm_bytes, device=self.device)
        with spans.span("probe.report"):
            report = ProbeReport(
                environment=self.environment,
                devices=devices,
                ici=ici,
                mxu=mxu,
                hbm=hbm,
                hbm_write=hbm_write,
                links=links,
                multislice=multislice,
                host=host_identity(),
                hosts=host_identity_map(self.device),
                rtt_warn_ms=self.config.probe_rtt_warn_ms,
                duration_ms=1e3 * (time.monotonic() - t0),
            )
            # trend folding sees the PRE-TREND verdict: an unhealthy cycle is
            # judged for drift but must not shape the "healthy" anchor
            report.trend_alerts = self._fold_trends(
                ici, mxu, hbm, hbm_write, links, multislice, cycle_healthy=report.healthy
            )
        if process_count() > 1:
            # every rank, every cycle, armed or not: a collective that only
            # armed ranks joined would hang the group. A stage of its own
            # (probe.gather), between the report's two spans
            try:
                report.node_findings = gather_node_findings(report, self.device)
            except Exception as exc:  # noqa: BLE001 — the cycle's readings stand without it
                logger.error("Gathering the node's local findings failed: %s", exc)
        with spans.span("probe.report"):
            self.metrics.counter("probe_runs").inc()
            if ici.psum_rtt_ms >= 0:
                self.metrics.histogram("probe_psum_rtt").record(ici.psum_rtt_ms / 1e3)
            if not report.healthy:
                self.metrics.counter("probe_unhealthy").inc()
            # a completed cycle, healthy or not, proves the agent alive; a cycle
            # that raised or hangs stamps nothing, so liveness goes stale
            self.heartbeat()
            observer = self.report_observer
            if observer is not None:
                try:
                    with spans.span("probe.observer"):
                        observer(report)
                except Exception as exc:  # noqa: BLE001 — an observer bug must not stop probing
                    logger.error("Probe report observer failed: %s", exc)
                    self.metrics.counter("probe_observer_errors").inc()
            return report

    def _fold_trends(self, ici, mxu, hbm, hbm_write, links, multislice, *, cycle_healthy: bool = True) -> list:
        """Publish each median reading as a gauge (cleared when the sub-probe
        failed, was unreliable or did not run) and fold it into the trend
        tracker; gated on the same ok fields ``ProbeReport.healthy`` uses."""
        ici_ok = ici is not None and ici.error is None and ici.ok and not ici.timing_unreliable
        mxu_ok = mxu is not None and mxu.get("ok", False) and not mxu.get("timing_unreliable", False)
        # CPU (plain-version) bandwidth numbers are meaningless
        hbm_ok = (
            hbm is not None and hbm.get("ok", False) and not hbm.get("interpreted")
            and not hbm.get("bandwidth_unreliable", False)
        )
        hbm_w_ok = (
            hbm_write is not None and hbm_write.get("ok", False)
            and not hbm_write.get("interpreted")
            and not hbm_write.get("bandwidth_unreliable", False)
        )
        # links: an errored walk withdraws the gauges, but a walk that found
        # suspects is a valid reading (probe_link_suspects > 0 is what
        # operators scrape for), so links.ok is not gated on
        links_ok = links is not None and links.error is None and links.n_observed > 0
        # multislice: likewise; the pair median trends the typical route,
        # dcn_overhead_ms the cross-slice cost a fabric event inflates first
        ms_ok = multislice is not None and multislice.error is None and not multislice.timing_unreliable
        pair_valid = [p["rtt_ms"] for p in multislice.pair_rtts if p["rtt_ms"] >= 0] if ms_ok else []
        pair_median = float(np.median(pair_valid)) if pair_valid else None
        # in a group of one rank the all-reduce "RTT" and "bandwidth" measure
        # host dispatch, not any link: gauges publish, trends do not fold
        ici_fabric = ici_ok and ici.n_devices > 1
        # (name, value, higher_is_better, trend_eligible)
        readings = [
            ("psum_rtt_median_ms", ici.psum_rtt_median_ms if ici_ok else None, False, ici_fabric),
            ("allreduce_bus_gbps_median", ici.bandwidth_gbps_median if ici_ok else None, True, ici_fabric),
            ("mxu_tflops_median", mxu.get("tflops_median", 0.0) if mxu_ok else None, True, True),
            ("hbm_read_gbps", hbm.get("read_gbps", 0.0) if hbm_ok else None, True, True),
            ("hbm_write_gbps", hbm_write.get("write_gbps", 0.0) if hbm_w_ok else None, True, True),
            ("link_median_rtt_ms", links.median_rtt_ms if links_ok else None, False, True),
            ("dcn_pair_median_rtt_ms", pair_median, False, True),
            ("dcn_overhead_ms", multislice.dcn_overhead_ms if ms_ok and multislice.n_slices > 1 else None,
             False, True),
        ]
        if links_ok:
            self.metrics.gauge("probe_link_suspects").set(len(links.suspect_links))
        elif links is not None:
            self.metrics.gauge("probe_link_suspects").clear()
        alerts = []
        for name, value, higher_is_better, trend_eligible in readings:
            gauge = self.metrics.gauge(f"probe_{name}")
            if value is not None and value > 0:
                gauge.set(value)
            else:
                gauge.clear()
                continue
            if not trend_eligible or self.trend is None:
                continue
            alert = self.trend.observe(
                name, value, higher_is_better=higher_is_better, contribute_baseline=cycle_healthy
            )
            if alert is not None:
                logger.warning(
                    "Probe trend alert: %s %s to %.4g (baseline %.4g, ratio %.2f)",
                    alert.metric, alert.direction, alert.recent, alert.baseline, alert.ratio,
                )
                alerts.append(alert)
        if alerts:
            self.metrics.counter("probe_trend_alerts").inc(len(alerts))
        return alerts

    def _report(self, report: ProbeReport) -> None:
        # rank 0 reports for the group; another rank only when its own view
        # is unhealthy (a dead GPU on node k is only observed by node k)
        if process_index() == 0 or not report.healthy:
            self.sink(Notification(report.to_payload(), time.monotonic(), kind="probe"))

    def _record_cycle(self, report: ProbeReport) -> None:
        """Fold one completed cycle into the flight-recorder ring, with its
        spans (the one just closed on this thread): each stage's ms and the
        cycle's self time, its readbacks and queued launches, GC ms, device
        allocations (CUDA) and graph captures."""
        cycle = spans.RECORDER.last()
        entry = {
            "ts": datetime.datetime.now(datetime.timezone.utc).isoformat(timespec="seconds"),
            "healthy": report.healthy,
            "duration_ms": round(report.duration_ms, 1),
            "psum_rtt_ms": round(report.ici.psum_rtt_median_ms, 4) if report.ici else None,
            "mxu_tflops": round(report.mxu.get("tflops_median", 0.0), 2) if report.mxu else None,
            "hbm_read_gbps": round(report.hbm.get("read_gbps", 0.0), 1) if report.hbm else None,
            "hbm_write_gbps": round(report.hbm_write.get("write_gbps", 0.0), 1)
            if report.hbm_write else None,
            "link_suspects": len(report.links.suspect_links) if report.links else None,
            "dcn_suspect_slices": list(report.multislice.dcn_suspect_slices) if report.multislice else None,
            "trend_alerts": [
                {"metric": a.metric, "direction": a.direction, "ratio": round(a.ratio, 2)}
                for a in (report.trend_alerts or [])
            ],
            "stages_ms": {name: round(ms, 3) for name, ms in cycle.stages_ms().items()},
            "syncs": cycle.counters["syncs"],
            "queued_launches": cycle.counters["queued_launches"],
            "collectives": cycle.counters["collectives"],
            "gc_ms": round(cycle.gc_ms(), 3),
            "device_allocs": cycle.counters.get("device_allocs"),
            "graph_captures": cycle.counters["graph_captures"],
        }
        with self._cycles_lock:
            self._cycles.append(entry)

    def recent_cycles(self, n: int = 20) -> list:
        """Last-``n`` cycle summaries, newest first."""
        with self._cycles_lock:
            entries = list(self._cycles)
        return entries[::-1][: max(0, n)]

    def _loop(self) -> None:
        """Cycles until the stop: in a group of several ranks, until a
        cycle's vote says that a rank was asked to stop (one asked during
        the interval is heard at the end of the next cycle); in a group of
        one rank, until this rank's own stop."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)  # the current device is per thread
        try:
            while not self._stop.is_set() or process_count() > 1:
                try:
                    self._report(self.run_once(vote=True))
                except Exception as exc:  # noqa: BLE001 — one failed cycle must not end the loop
                    logger.error("Probe iteration failed: %s", exc)
                    self.metrics.counter("probe_errors").inc()
                if self._stop_agreed:
                    if not self._stop.is_set():
                        logger.info("The probe group agreed to stop; this rank stops with it")
                    return
                self._stop.wait(self.config.probe_interval_seconds)
        finally:
            self.stopped.set()

    def start(self) -> None:
        """Run a cycle every ``interval_seconds`` on a daemon thread."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, name="probe-agent", daemon=True)
        self._thread.start()

    def stop(self) -> bool:
        """Stop after the cycle in flight, with the rest of the group when
        there is one (waiting up to 5 s for it); False when the loop thread
        is still running (a cycle stuck in a collective), so the caller must
        not tear the group down."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is None:
            return True
        thread.join(timeout=5.0)
        return not thread.is_alive()
