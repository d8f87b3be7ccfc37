"""The what-if engine: placement questions as array masks (the JAX package's
``analytics/whatif.py``).

A scenario removes capacity — "drain cluster A", "cordon nodes N" — and
the engine answers which slices lose quorum and what capacity remains,
by masking the worker columns and re-running the slice-rollup kernel
under the mask (batched: S scenarios ride one ``[S, Nw]`` mask through
one kernel launch).

Scenario vocabulary (declared, schema'd at parse time — the HTTP layer
turns ``ScenarioError`` into a 400):

- ``{"kind": "baseline"}`` — no capacity removed (the identity row;
  useful as an in-band control when batching).
- ``{"kind": "drain_cluster", "cluster": "<name>"}`` — every worker of
  every slice belonging to that cluster is lost (``""`` = the local,
  un-federated cluster).
- ``{"kind": "cordon_nodes", "nodes": ["n1", ...]}`` — workers placed
  on those nodes are lost. Node names are matched against the fleet's
  interner; unknown names match nothing (they remove no capacity — the
  verdict reports them so a typo'd rehearsal is visible, not silently
  reassuring).

Quorum semantics (the column the verdict turns on):

- a slice's **need** is ``expected_workers`` when the tracker inferred
  one (GKE topology / indexed-Job metadata), else its current observed
  membership — the best-known full strength;
- a slice **has quorum** when its ready workers (Running & ready &
  node-up) cover the need;
- a scenario's ``slices_losing_quorum`` lists exactly the slices that
  have quorum at baseline and would not under the mask. A slice already
  below quorum cannot "lose" it — drains are judged against what they
  break, not what was already broken.

What a verdict does NOT guarantee: it is a pure function of the *current materialized view* — no
scheduler model (evicted pods might reschedule elsewhere), no k8s PDB /
eviction-order semantics, no cross-slice workload coupling. It answers
"what does the fleet look like the instant this capacity vanishes",
which is the question a drain rehearsal actually needs first.

``python_reference_verdicts`` is the plain dict-walk twin of the array
path: same inputs, same verdict structure, no arrays. It is the oracle the
array path is held to, and the sequential baseline it is timed against —
two independent implementations that must agree exactly.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from k8s_watcher_tpu_torch.analytics.encode import LOCAL_CLUSTER, FleetColumns, worker_up as _worker_up
from k8s_watcher_tpu_torch.analytics.kernels import FleetKernels

#: declared scenario kinds (the vocabulary /serve/analytics advertises)
SCENARIO_KINDS = ("baseline", "drain_cluster", "cordon_nodes")


class ScenarioError(ValueError):
    """A scenario failed vocabulary validation (HTTP layer -> 400)."""


class Scenario(NamedTuple):
    kind: str
    cluster: Optional[str] = None
    nodes: Tuple[str, ...] = ()

    def to_wire(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"kind": self.kind}
        if self.kind == "drain_cluster":
            out["cluster"] = self.cluster
        elif self.kind == "cordon_nodes":
            out["nodes"] = list(self.nodes)
        return out


def parse_scenarios(raw: Any, *, max_scenarios: int) -> List[Scenario]:
    """Validate one wire-shaped scenario list into :class:`Scenario`s."""
    if not isinstance(raw, (list, tuple)):
        raise ScenarioError("scenarios must be a JSON array of scenario objects")
    if not raw:
        raise ScenarioError("scenarios must not be empty")
    if len(raw) > max_scenarios:
        raise ScenarioError(
            f"{len(raw)} scenarios exceed analytics.max_scenarios={max_scenarios}"
        )
    out: List[Scenario] = []
    for i, entry in enumerate(raw):
        path = f"scenarios[{i}]"
        if not isinstance(entry, Mapping):
            raise ScenarioError(f"{path}: must be an object")
        kind = entry.get("kind")
        if kind not in SCENARIO_KINDS:
            raise ScenarioError(
                f"{path}.kind: must be one of {', '.join(SCENARIO_KINDS)}, got {kind!r}"
            )
        # per-KIND field validation: a cross-kind field (drain_cluster
        # with nodes, cordon_nodes with cluster) is almost certainly an
        # operator expecting combined semantics this vocabulary doesn't
        # have — dropping it silently would understate the rehearsal's
        # damage, so it is an error, not noise
        allowed = {
            "baseline": {"kind"},
            "drain_cluster": {"kind", "cluster"},
            "cordon_nodes": {"kind", "nodes"},
        }[kind]
        unknown = set(entry) - allowed
        if unknown:
            raise ScenarioError(
                f"{path}: field(s) {', '.join(sorted(unknown))} not valid for "
                f"kind {kind!r} (allowed: {', '.join(sorted(allowed))})"
            )
        if kind == "baseline":
            out.append(Scenario("baseline"))
        elif kind == "drain_cluster":
            cluster = entry.get("cluster")
            if cluster is None or not isinstance(cluster, str):
                raise ScenarioError(
                    f'{path}.cluster: required string ("" = the local cluster)'
                )
            out.append(Scenario("drain_cluster", cluster=cluster))
        else:  # cordon_nodes
            nodes = entry.get("nodes")
            if (
                not isinstance(nodes, (list, tuple))
                or not nodes
                or not all(isinstance(n, str) and n for n in nodes)
            ):
                raise ScenarioError(
                    f"{path}.nodes: required non-empty array of node names"
                )
            out.append(Scenario("cordon_nodes", nodes=tuple(nodes)))
    return out


def build_masks(cols: FleetColumns, scenarios: Sequence[Scenario]) -> np.ndarray:
    """``[S, Nw]`` bool survive-masks for the batched kernel."""
    n_workers = cols.n_workers
    masks = np.ones((len(scenarios), n_workers), dtype=bool)
    for i, scenario in enumerate(scenarios):
        if scenario.kind == "drain_cluster":
            code = cols.clusters.lookup(scenario.cluster or LOCAL_CLUSTER)
            if code is not None and n_workers:
                masks[i] &= cols.w_cluster != code
        elif scenario.kind == "cordon_nodes":
            codes = [
                c for c in (cols.nodes.lookup(n) for n in scenario.nodes)
                if c is not None
            ]
            if codes and n_workers:
                masks[i] &= ~np.isin(cols.w_node, np.asarray(codes, dtype=np.int32))
    return masks


def _unknown_nodes(cols: FleetColumns, scenario: Scenario) -> List[str]:
    """Scenario nodes the CURRENT fleet doesn't place anything on.
    Judged against the live columns, not the interner — interners only
    grow, and a node that vanished from the fleet must read unknown
    (exactly what the dict-walk reference computes from live objects)."""
    current = set(np.unique(cols.pod_node).tolist()) | set(np.unique(cols.w_node).tolist())
    out = []
    for name in scenario.nodes:
        code = cols.nodes.lookup(name)
        if code is None or code not in current:
            out.append(name)
    return sorted(out)


def _need(expected: int, observed: int) -> int:
    return expected if expected >= 0 else observed


def evaluate_scenarios(
    cols: FleetColumns,
    scenarios: Sequence[Scenario],
    kernels: FleetKernels,
) -> Dict[str, Any]:
    """The array path: one batched kernel launch answers every scenario.

    Returns the canonical verdict document (JSON-able, deterministic
    ordering) — the exact structure ``python_reference_verdicts``
    produces from the same state.
    """
    rollup = kernels.slice_rollup(cols)
    # need falls back to the membership the masks actually act on — the
    # RECOMPUTED worker count (== len(workers[])), never the object's
    # observed_workers counter: a capture whose counter drifted from its
    # workers[] list (the exact state the cross-check exists to catch)
    # must not make this path and the dict-walk oracle disagree about
    # quorum. The incremental counters stay cross-check input only.
    need = np.where(cols.s_expected >= 0, cols.s_expected, rollup.observed).astype(np.int64)
    quorum_before = (need > 0) & (rollup.ready >= need)
    baseline_chips = int(rollup.chips_ready.sum())
    masks = build_masks(cols, scenarios)
    result = kernels.what_if(cols, masks)
    out_scenarios: List[Dict[str, Any]] = []
    for i, scenario in enumerate(scenarios):
        ready_after = result.ready_after[i]
        chips_after_total = int(result.chips_after[i].sum())
        lose = quorum_before & (ready_after < need)
        verdict: Dict[str, Any] = {
            "scenario": scenario.to_wire(),
            "slices_losing_quorum": sorted(
                cols.slice_names[j] for j in np.nonzero(lose)[0]
            ),
            "slices_with_quorum": int(((need > 0) & (ready_after >= need)).sum()),
            "ready_workers": int(ready_after.sum()),
            "lost_ready_workers": int(result.lost_workers[i]),
            "chips_ready": chips_after_total,
            "capacity_ratio": _ratio(chips_after_total, baseline_chips),
        }
        if scenario.kind == "cordon_nodes":
            unknown = _unknown_nodes(cols, scenario)
            if unknown:
                verdict["unknown_nodes"] = unknown
        out_scenarios.append(verdict)
    return {
        "baseline": {
            "pods": int(cols.n_pods),
            "slices": int(cols.n_slices),
            "workers": int(cols.n_workers),
            "slices_with_quorum": int(quorum_before.sum()),
            "ready_workers": int(rollup.ready.sum()),
            "chips_ready": baseline_chips,
        },
        "scenarios": out_scenarios,
    }


def _ratio(after: int, before: int) -> float:
    """Capacity ratio from two ints — identical arithmetic on every
    path (array, reference, any backend), so verdict equality is exact."""
    return round(after / before, 6) if before > 0 else 1.0


# -- the pure-Python twin (oracle + sequential baseline) -------------------


def _slice_rows(tables: Mapping[str, Iterable[Mapping[str, Any]]]):
    for obj in tables.get("slice", ()):
        key = str(obj.get("key") or obj.get("slice") or "")
        if key:
            yield key, obj


def _worker_lost(worker: Mapping[str, Any], cluster: str, scenario: Scenario) -> bool:
    if scenario.kind == "drain_cluster":
        return cluster == (scenario.cluster or LOCAL_CLUSTER)
    if scenario.kind == "cordon_nodes":
        return worker.get("node") in scenario.nodes
    return False


def python_reference_verdicts(
    tables: Mapping[str, Iterable[Mapping[str, Any]]],
    scenarios: Sequence[Scenario],
) -> Dict[str, Any]:
    """The dict-walk reference: O(scenarios x workers) Python loops over
    the raw view objects — no arrays, no interners, no backend. Produces
    the byte-identical verdict document ``evaluate_scenarios`` does;
    divergence between the two is a real bug in one of them.

    It is also the performance baseline: scanning the dicts again, once
    per question.
    """
    slices = sorted(_slice_rows(tables), key=lambda kv: kv[0])
    pods = list(tables.get("pod", ()))
    baseline_ready = 0
    baseline_chips = 0
    baseline_quorum = 0
    known_nodes = {p.get("node") for p in pods if p.get("node")}
    per_slice: List[Tuple[str, Mapping[str, Any], str, int, int]] = []
    n_workers = 0
    for key, obj in slices:
        cluster = str(obj.get("cluster") or LOCAL_CLUSTER)
        chips = int(obj.get("chips_per_worker") or 0)
        expected = obj.get("expected_workers")
        workers = list(obj.get("workers") or ())
        n_workers += len(workers)
        for w in workers:
            if w.get("node"):
                known_nodes.add(w.get("node"))
        ready = sum(1 for w in workers if _worker_up(w))
        baseline_ready += ready
        baseline_chips += ready * chips
        need = _need(-1 if expected is None else int(expected), len(workers))
        if need > 0 and ready >= need:
            baseline_quorum += 1
        per_slice.append((key, obj, cluster, chips, need))
    out_scenarios: List[Dict[str, Any]] = []
    for scenario in scenarios:
        losing: List[str] = []
        quorum_after = 0
        ready_total = 0
        lost_ready = 0
        chips_total = 0
        for key, obj, cluster, chips, need in per_slice:
            workers = obj.get("workers") or ()
            ready_before = 0
            ready_after = 0
            for w in workers:
                if not _worker_up(w):
                    continue
                ready_before += 1
                if _worker_lost(w, cluster, scenario):
                    lost_ready += 1
                else:
                    ready_after += 1
            ready_total += ready_after
            chips_total += ready_after * chips
            had_quorum = need > 0 and ready_before >= need
            if need > 0 and ready_after >= need:
                quorum_after += 1
            if had_quorum and ready_after < need:
                losing.append(key)
        verdict: Dict[str, Any] = {
            "scenario": scenario.to_wire(),
            "slices_losing_quorum": sorted(losing),
            "slices_with_quorum": quorum_after,
            "ready_workers": ready_total,
            "lost_ready_workers": lost_ready,
            "chips_ready": chips_total,
            "capacity_ratio": _ratio(chips_total, baseline_chips),
        }
        if scenario.kind == "cordon_nodes":
            unknown = sorted(n for n in scenario.nodes if n not in known_nodes)
            if unknown:
                verdict["unknown_nodes"] = unknown
        out_scenarios.append(verdict)
    return {
        "baseline": {
            "pods": len(pods),
            "slices": len(slices),
            "workers": n_workers,
            "slices_with_quorum": baseline_quorum,
            "ready_workers": baseline_ready,
            "chips_ready": baseline_chips,
        },
        "scenarios": out_scenarios,
    }
