"""Bulk replay analytics: N what-if scenarios over one WAL replay (the JAX
package's ``analytics/replay.py``).

The capture is replayed once (``history/replay.py``), encoded into columns
once, and all N scenarios ride the batched what-if kernels' scenario axis.
``sequential_replay_verdicts`` is the baseline: N full replays, each folded
by the plain dict walk; the batched path must equal it exactly.

The kernels run where ``device`` says (the rank's GPU by default, as the
analytics plane's; ``device="cpu"`` on the CPU), or on a ``backend`` or
``kernels`` the caller passes.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Sequence

from k8s_watcher_tpu_torch.analytics.backend import ArrayBackend, resolve_backend
from k8s_watcher_tpu_torch.analytics.encode import FleetEncoder, tables_from_objects
from k8s_watcher_tpu_torch.analytics.kernels import FleetKernels, crosscheck
from k8s_watcher_tpu_torch.analytics.whatif import Scenario, evaluate_scenarios, python_reference_verdicts
from k8s_watcher_tpu_torch.history.replay import replay_wal


def verdicts_from_objects(
    objects,
    scenarios: Sequence[Scenario],
    *,
    backend: Optional[ArrayBackend] = None,
    kernels: Optional[FleetKernels] = None,
    device=None,
) -> Dict[str, Any]:
    """Evaluate scenarios over a replayed state (the ``{(kind, key): obj}``
    shape ``replay_wal`` returns): encode once, one batched evaluation."""
    if kernels is None:
        kernels = FleetKernels(backend or resolve_backend("auto", device=device))
    encoder = FleetEncoder()
    encoder.reset(tables_from_objects(objects))
    cols = encoder.columns()
    out = evaluate_scenarios(cols, scenarios, kernels)
    out["crosscheck"] = crosscheck(cols, kernels.slice_rollup(cols))
    return out


def batched_replay_verdicts(
    wal_dir: Path | str,
    scenarios: Sequence[Scenario],
    *,
    at: Optional[int] = None,
    backend: Optional[ArrayBackend] = None,
    kernels: Optional[FleetKernels] = None,
    device=None,
) -> Dict[str, Any]:
    """One deterministic replay, one encode, one batched pass for every
    scenario. ``at`` stops the replay at a historical rv."""
    result = replay_wal(wal_dir, at=at)
    out = verdicts_from_objects(result.objects, scenarios, backend=backend, kernels=kernels, device=device)
    out["rv"] = result.rv
    out["deltas_applied"] = result.deltas_applied
    out["rv_mismatches"] = result.rv_mismatches
    return out


def sequential_replay_verdicts(
    wal_dir: Path | str,
    scenarios: Sequence[Scenario],
    *,
    at: Optional[int] = None,
) -> Dict[str, Any]:
    """The baseline: each scenario pays a full WAL replay and a dict-walk
    fold (no arrays). The same verdict document as the batched path."""
    baseline: Optional[Dict[str, Any]] = None
    out_scenarios = []
    rv = 0
    deltas_applied = 0
    mismatches = 0
    for scenario in scenarios:
        result = replay_wal(wal_dir, at=at)
        rv = result.rv
        deltas_applied = result.deltas_applied
        mismatches = result.rv_mismatches
        verdict = python_reference_verdicts(tables_from_objects(result.objects), [scenario])
        if baseline is None:
            baseline = verdict["baseline"]
        out_scenarios.append(verdict["scenarios"][0])
    return {
        "baseline": baseline or {},
        "scenarios": out_scenarios,
        "rv": rv,
        "deltas_applied": deltas_applied,
        "rv_mismatches": mismatches,
    }


def comparable(verdicts: Dict[str, Any]) -> Dict[str, Any]:
    """The verdicts alone (no backend name, crosscheck detail or replay
    counters), for batched-versus-sequential equality."""
    return {"baseline": verdicts.get("baseline"), "scenarios": verdicts.get("scenarios")}
