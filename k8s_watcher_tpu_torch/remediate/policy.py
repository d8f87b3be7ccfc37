"""Remediation policy: when is a probe finding actionable? (the JAX package's
``remediate/policy.py``, on ranks).

One cycle is not grounds to cordon a node: per-cycle readings are noisy, and
one suspect link implicates the link, not a GPU. ``ProbeRemediationPolicy``
asks the actuator to quarantine a node only once it was implicated in
``confirm_cycles`` consecutive reports; one clean cycle resets the count.

Node mapping: a finding names a rank, and the report's ``hosts`` identity
map (``str(rank) -> identity``, probe/device.py) names the rank's node
(``NODE_NAME`` from the downward API). A finding whose rank has no
``node_name`` is counted and logged but never acted on.

Ranks, where the JAX package has devices and processes:

- A link record's ``device_ids`` are the ranks at its two ends
  (probe/links.py), so a triangulated endpoint is looked up in ``hosts``
  directly. The report's ``devices`` inventory lists only this node's GPUs,
  by local CUDA index, and cannot resolve a rank.
- Every rank classifies the merged walk (probe/links.py), so every rank's
  report holds the same triangulations. They are all ``slice`` scope, and
  only rank 0 acts on them; were the suspect's own rank to act too, two
  actuators would confirm one node and double every fence's accounting.
- Multislice ``slice_processes`` are ranks already, and the DCN pair rule
  is slice scope as in the JAX package.
- Liveness, GEMM and HBM findings concern the reporting rank's own GPU:
  ``local`` scope (:func:`local_findings`). The JAX package runs one process
  per host, so a node has one actor; the port runs one rank per GPU. So the
  agent gathers every rank's local findings each cycle
  (``ProbeReport.node_findings``, probe/agent.py), and only the lowest rank
  of each node acts on them, on its node's findings merged into one evidence
  list: one payload, one PATCH and one rate and budget count per node.
"""

from __future__ import annotations

import logging
import threading
from datetime import datetime, timezone
from typing import Any, Callable, Dict, List, Optional

from k8s_watcher_tpu_torch.probe.device import node_ranks, process_count, process_index
from k8s_watcher_tpu_torch.remediate.actuator import ActionRecord, NodeActuator

logger = logging.getLogger(__name__)


def local_findings(report) -> List[str]:
    """The evidence of ``report``'s ``local`` findings, all about the
    reporting rank's own GPU: its liveness, a non-finite GEMM, HBM blocks
    that failed their readback or a failed integrity check."""
    out: List[str] = []
    for entry in (report.devices or {}).get("devices") or []:
        if entry.get("alive") is False:
            # liveness runs on the rank's own GPU only (the node's other
            # GPUs are alive=None, process_index=None)
            out.append(f"device probe: chip {entry.get('id')} failed its liveness computation")
    mxu = report.mxu
    if mxu is not None and mxu.get("error") is None and mxu.get("finite") is False:
        out.append("mxu probe: matmul produced non-finite values")
    for label, probe in (("hbm read", report.hbm), ("hbm write", report.hbm_write)):
        if probe is None or probe.get("error") is not None:
            continue
        bad = probe.get("bad_blocks")
        if bad:
            out.append(f"{label} probe: {len(bad)} HBM block(s) failed pattern readback")
        elif probe.get("integrity_ok") is False:
            out.append(f"{label} probe: checksum integrity failed")
    return out


class ProbeRemediationPolicy:
    def __init__(
        self,
        actuator: NodeActuator,
        *,
        confirm_cycles: int = 3,
        sink: Optional[Callable[[Dict[str, Any]], None]] = None,
        metrics=None,
        environment: str = "",
    ):
        if confirm_cycles < 1:
            raise ValueError("confirm_cycles must be >= 1")
        self.actuator = actuator
        self.confirm_cycles = confirm_cycles
        self.sink = sink
        self.metrics = metrics
        self.environment = environment
        self._lock = threading.Lock()
        self._streaks: Dict[str, int] = {}  # node -> consecutive implicated cycles
        self._reasons: Dict[str, List[str]] = {}  # node -> last cycle's evidence

    # -- evidence extraction ----------------------------------------------

    @staticmethod
    def _implicated(report) -> Dict[str, List]:
        """``node_name -> [(scope, evidence), ...]`` for this report; scope is
        ``"slice"`` (findings every rank's report holds) or ``"local"``
        (findings about the reporting rank's own GPU)."""
        hosts = report.hosts or {}

        def node_of(rank) -> Optional[str]:
            identity = hosts.get(str(rank)) or {}
            return identity.get("node_name")

        out: Dict[str, List] = {}
        unmapped: List[str] = []

        def implicate(rank, evidence: str, scope: str = "slice") -> None:
            node = node_of(rank)
            if node:
                out.setdefault(node, []).append((scope, evidence))
            else:
                unmapped.append(evidence)

        links = report.links
        if links is not None and links.error is None:
            # re-triangulate from MEASURED defects only (slow RTT, corrupt
            # checksum): when one rank fails preparation every link becomes
            # an error suspect, and acting on those would cordon healthy
            # nodes over an agent failure no probe measured
            endpoint_counts: Dict[Any, int] = {}
            for s in links.suspect_links:
                if s.get("reason") in ("slow", "corrupt"):
                    for rank in s.get("device_ids", ()):
                        endpoint_counts[rank] = endpoint_counts.get(rank, 0) + 1
            for rank, count in sorted(endpoint_counts.items()):
                if count >= 2:
                    # the endpoint IS a rank; every rank classified the same
                    # merged walk, so this is slice scope: rank 0 acts
                    implicate(
                        rank,
                        f"link probe: device {rank} is the common endpoint of "
                        f"{count} measured-suspect links",
                        scope="slice",
                    )
        # DCN pair walk: a slice that is the common endpoint of all its
        # n_slices-1 pairs (at least 2) implicates its member ranks' nodes.
        # The pair graph is complete, so a plain >=2 bar would implicate
        # healthy slices beside two degraded ones
        ms = report.multislice
        if ms is not None and getattr(ms, "error", None) is None and not getattr(ms, "timing_unreliable", False):
            pair_counts: Dict[int, int] = {}
            for pair in getattr(ms, "suspect_pairs", None) or []:
                if pair.get("reason") not in ("slow", "corrupt"):
                    continue
                for slice_idx in pair.get("device_ids", ()):  # slice indices on the "dcn" axis
                    pair_counts[slice_idx] = pair_counts.get(slice_idx, 0) + 1
            slice_procs = getattr(ms, "slice_processes", None) or []
            n_sl = int(getattr(ms, "n_slices", 0) or 0)
            for slice_idx, count in sorted(pair_counts.items()):
                if count < max(2, n_sl - 1):
                    continue
                members = slice_procs[slice_idx] if slice_idx < len(slice_procs) else []
                if not members:
                    unmapped.append(
                        f"dcn probe: slice {slice_idx} is the common endpoint of "
                        f"{count} suspect DCN pairs, but the report carries no "
                        "member-process map for it"
                    )
                    continue
                for rank in members:
                    implicate(
                        rank,
                        f"dcn probe: slice {slice_idx} (host process {rank}) is the "
                        f"common endpoint of {count} suspect DCN slice pairs",
                        scope="slice",
                    )
        # the GEMM and HBM probes, like liveness, run on the reporting rank's own GPU
        for evidence in local_findings(report):
            implicate((report.devices or {}).get("process_index"), evidence, scope="local")
        if unmapped:
            logger.warning(
                "Probe implicates hardware on processes with no node_name "
                "(NODE_NAME downward-API env missing?) — cannot remediate: %s",
                unmapped,
            )
        if unmapped and not out:
            out["__unmapped__"] = unmapped  # visible in notifications, never acted on
        return out

    @staticmethod
    def _own_share(report, scoped: Dict[str, List]) -> Dict[str, List]:
        """What this rank acts on among several: rank 0 the ``slice``
        findings (and the unmapped ones, which it only reports); the lowest
        rank of each node the ``local`` findings of its node's ranks; any
        other rank nothing.

        The node's findings come from ``report.node_findings`` (``str(rank)
        -> evidence``, gathered by the agent every cycle), or are this rank's
        own when the report carries none. With findings from several ranks
        each evidence names its rank, so the reason cites every GPU."""
        me = process_index()
        out: Dict[str, List] = {}
        if me == 0:
            for node, evidence in scoped.items():
                kept = evidence if node == "__unmapped__" else [e for e in evidence if e[0] == "slice"]
                if kept:
                    out[node] = kept
        hosts = report.hosts or {}
        own = (hosts.get(str(me)) or {}).get("node_name")
        if own and node_ranks(hosts, own)[:1] == [me]:
            gathered = report.node_findings
            if gathered is None:
                gathered = {str(me): local_findings(report)}
            found = sorted((int(r), evidence) for r, evidence in gathered.items() if evidence)
            several = len(found) > 1
            local = [("local", f"rank {r}: {e}" if several else e) for r, evidence in found for e in evidence]
            if local:
                out.setdefault(own, []).extend(local)
        return out

    # -- the per-cycle fold ------------------------------------------------

    def observe_report(self, report) -> List[ActionRecord]:
        """Fold one probe report; returns the actions taken (possibly [])."""
        scoped = self._implicated(report)
        if process_count() > 1:
            scoped = self._own_share(report, scoped)
        implicated = {n: (ev if n == "__unmapped__" else [e[1] for e in ev]) for n, ev in scoped.items()}
        actionable = {n: ev for n, ev in implicated.items() if n != "__unmapped__"}
        records: List[ActionRecord] = []
        with self._lock:
            for node in list(self._streaks):
                if node not in actionable:
                    # one clean cycle resets
                    del self._streaks[node]
                    self._reasons.pop(node, None)
            confirmed: List[str] = []
            for node, evidence in actionable.items():
                self._streaks[node] = self._streaks.get(node, 0) + 1
                self._reasons[node] = evidence
                if self._streaks[node] >= self.confirm_cycles:
                    confirmed.append(node)
        for node in confirmed:
            reason = (
                f"implicated in {self.confirm_cycles}+ consecutive probe cycles: "
                + "; ".join(self._reasons.get(node, []))[:400]
            )
            records.append(self.actuator.quarantine(node, reason))
            with self._lock:
                # applied or refused, the streak restarts: a refusal must
                # re-earn confirmation rather than hammer the fences
                self._streaks.pop(node, None)
        if self.metrics is not None and implicated.get("__unmapped__"):
            self.metrics.counter("remediation_unmappable").inc()
        if records or implicated:
            self._notify(implicated, records)
        return records

    def _notify(self, implicated: Dict[str, List[str]], records: List[ActionRecord]) -> None:
        if self.sink is None:
            return
        payload = {
            "event_type": "TPU_REMEDIATION",
            "environment": self.environment,
            "dry_run": self.actuator.dry_run,
            "implicated": implicated,
            "streaks": dict(self._streaks),
            "confirm_cycles": self.confirm_cycles,
            "actions": [r.to_dict() for r in records],
            "quarantined_nodes": self.actuator.quarantined_nodes(),
            "event_timestamp": datetime.now(timezone.utc).isoformat(),
        }
        try:
            self.sink(payload)
        except Exception as exc:  # noqa: BLE001 — reporting must not stop the probe loop
            logger.error("Remediation notification failed: %s", exc)

    def snapshot(self) -> Dict[str, Any]:
        """The ``/debug/remediation`` view of the policy's state."""
        with self._lock:
            return {
                "streaks": dict(self._streaks),
                "confirm_cycles": self.confirm_cycles,
                "dry_run": self.actuator.dry_run,
                "quarantined_nodes": self.actuator.quarantined_nodes(),
            }
