"""The port's health chaos drill (``python -m
k8s_watcher_tpu_torch.health_smoke``) held against the JAX package's
``scripts/health_smoke.py`` at the reference's own sizes and deadlines, the
port's apps on the CPU (``test_torch_smoke_pair.run_pair``: both exit 0,
equal check sets, every check true).

Fields compared, besides the checks: the collateral verdicts (none on
either side), and the final dry-run actions' node, action, outcome and
flags, each action's reason naming the same signal (the reasons' measured
values, such as a peer z-score, are left out).

Marked ``slow``: the pair takes 65 s alone on the build host's 8 CPUs, and
under the tier-1 run's six workers the JAX package's own script fails its
timing-bound verdicts (slow-host de-escalation, zero collateral) while every
other drill runs beside it. Run it alone: ``python -m pytest
tests/test_torch_smoke_health.py -m slow``. The twin runs on the card in
``chip_smoke.py`` phase 17.
"""

import pytest

from test_torch_smoke_pair import assert_equal, run_pair

_ACTION = ("node", "action", "ok", "dry_run", "applied", "adopted", "error")


def _actions(artifact: dict) -> list:
    return [{**{k: a[k] for k in _ACTION}, "signal": "link probe" in a["reason"] or "phase_latency" in a["reason"]}
            for a in artifact["final_actions"]]


@pytest.mark.slow
def test_health_smoke_twin_matches_the_reference(tmp_path, monkeypatch):
    reference, port = run_pair("health_smoke", tmp_path, monkeypatch)
    assert reference["collateral"] == port["collateral"] == []
    assert_equal(_actions(reference), _actions(port))
    assert {a["node"] for a in port["final_actions"]} == {"node-a1", "node-a2"}
