"""Synthetic probe reports for drills and tests (the JAX package's
``health/synthetic.py``).

The health plane consumes probe reports through the shape
``remediate/policy.py`` parses (``devices``/``hosts``/``links``...). Real
reports come from ``probe/agent.py`` on each rank's GPU; a drill and the
tests need the same shape without a card: scripted, deterministic, and wrong
in exactly one place. These functions produce that: a slice of N hosts, one
rank per host, a ring of links with healthy RTTs, and optionally one
degraded rank whose links are slow enough to triangulate. Device ids, ranks
and ``process_index`` coincide, so the report reads alike under the JAX
package's device join and the port's rank join.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Sequence


def synthetic_link_report(
    nodes: Sequence[str],
    *,
    degraded_node: Optional[str] = None,
    healthy_rtt_ms: float = 0.2,
    degraded_rtt_ms: float = 6.0,
):
    """A probe-report-shaped object for a slice of ``nodes`` (one device
    per host, devices linked in a ring). ``degraded_node`` makes BOTH of
    that node's device's links measured-suspect ("slow"), which is the
    >=2-links triangulation ``ProbeRemediationPolicy._implicated`` turns
    into a node implication — the "one degraded ICI link pair localizes
    to its common endpoint" scenario, scripted."""
    nodes = list(nodes)
    devices = [
        {"id": i, "process_index": i, "alive": True} for i in range(len(nodes))
    ]
    hosts = {str(i): {"node_name": node} for i, node in enumerate(nodes)}
    degraded_id = nodes.index(degraded_node) if degraded_node else None
    links: List[Dict[str, Any]] = []
    suspect_links: List[Dict[str, Any]] = []
    n = len(nodes)
    for i in range(n if n > 2 else n - 1):  # ring; 2 nodes = one edge
        a, b = i, (i + 1) % n
        rtt = healthy_rtt_ms
        if degraded_id is not None and degraded_id in (a, b):
            rtt = degraded_rtt_ms
        link = {
            "name": f"link-{a}-{b}",
            "device_ids": [a, b],
            "rtt_ms": rtt,
            "axis": "x",
        }
        links.append(link)
        if rtt >= degraded_rtt_ms:
            suspect_links.append({**link, "reason": "slow"})
    return SimpleNamespace(
        devices={"devices": devices, "process_index": 0},
        hosts=hosts,
        links=SimpleNamespace(
            error=None,
            ok=not suspect_links,
            links=links,
            suspect_links=suspect_links,
            suspect_devices=(
                [degraded_id] if degraded_id is not None and suspect_links else []
            ),
        ),
        multislice=None,
        mxu=None,
        hbm=None,
        hbm_write=None,
    )
