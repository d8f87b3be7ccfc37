"""Cross-slice aggregation probe (the JAX package's ``probe/multislice.py``
on ranks).

A slice is one NVLink domain, by default one node; slices are joined by the
network. The probe runs over the ``(slices, hosts, gpus)`` rank grid
(parallel/mesh.py:hybrid_slice_mesh):

- a hierarchical sum (per slice, then across slices) whose per-slice partial
  sums localise a bad contribution to its slice;
- chained all-reduces over ``(hosts, gpus)`` only and over every axis, so
  ``dcn_overhead_ms = t(all) - t(in-slice)`` is the cross-slice fabric's own
  cost;
- a per-pair walk (the slice-level analogue of probe/links.py): for every
  slice pair a chained exchange between the two slices times exactly the
  path between them. A slow slice endpoint stretches every pair it is in
  (the common endpoint of >= 2 suspect pairs is the suspect slice), a
  degraded route only its own pair, and corruption fails the pair's
  checksum. Classification is probe/links.py:classify_links with axis
  ``"dcn"`` and a min baseline.

A single slice degenerates cleanly: no cross-slice hop, ``dcn_overhead_ms``
about 0, no pairs to walk.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from k8s_watcher_tpu_torch.faults.ici import IciFaultSpec
from k8s_watcher_tpu_torch.parallel.collectives import (
    make_hierarchical_probe,
    make_slice_pair_probe,
    make_subaxis_psum_probe,
    psum_probe_input,
    slice_pair_input,
    slice_pair_members,
)
from k8s_watcher_tpu_torch.parallel.mesh import Mesh, hybrid_slice_mesh
from k8s_watcher_tpu_torch.probe.device import resolve_device
from k8s_watcher_tpu_torch.probe.links import LinkResult, classify_links, merge_owned_records
from k8s_watcher_tpu_torch.probe.timing import fence_baseline_ms, fetch_scalar, timed_fenced

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class MultiSliceProbeResult:
    ok: bool
    n_slices: int
    devices_per_slice: int
    per_slice_sums: List[float]
    suspect_slices: List[int]  # slice indices whose partial sum deviates
    ici_rtt_ms: float  # chained all-reduce over (hosts, gpus) only
    total_rtt_ms: float  # chained all-reduce over every axis
    dcn_overhead_ms: float  # total - in-slice, clamped at 0
    compile_ms: float
    error: Optional[str] = None
    # True when fence noise swamps the timed ops (see probe/timing.py)
    timing_unreliable: bool = False
    # per-pair walk: one record per slice pair this rank joined (owner=True
    # on the lowest member rank, so a merge across ranks counts each once)
    pair_rtts: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    suspect_pairs: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    # slice indices implicated by >= 2 suspect pairs
    dcn_suspect_slices: List[int] = dataclasses.field(default_factory=list)
    # slice index -> member ranks (the join slice -> ranks -> identity map -> nodes)
    slice_processes: List[List[int]] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _walk_slice_pairs(
    mesh: Mesh,
    *,
    iters: int,
    inner_iters: int,
    baseline_ms: float,
    fault: Optional[IciFaultSpec],
) -> Tuple[List[LinkResult], List[LinkResult], float, bool]:
    """Time the path between every slice pair; returns ``(records, merged,
    compile_s, any_unreliable)``.

    Every rank walks the same pair order and joins the pairs its slice is
    in, in lockstep with the other members; the lowest member rank owns the
    record. ``records`` are the pairs this rank joined, each flagged
    ``owner`` or not; ``merged`` is every pair's owned record, all-gathered,
    and classification must run over it: a
    rank in the slow slice sees only its own (uniformly slow) pairs, so a
    min baseline of its own view is slow and flags nothing, while a healthy
    slice's rank sees one suspect pair per faulty peer, below the >= 2-pair
    endpoint rule. ``any_unreliable`` is OR-merged across ranks."""
    n_sl = mesh.shape["slices"]
    rank = mesh.rank
    pair_order = [(i, j) for i in range(n_sl) for j in range(i + 1, n_sl)]
    records: List[LinkResult] = []
    compile_s = 0.0
    any_unreliable = False
    for i, j in pair_order:
        name = f"slice{i}-slice{j}"
        owner = None  # resolved once membership is known
        try:
            members = slice_pair_members(mesh, i, j)
            if rank not in members:
                continue
            owner = rank == members[0]
            fn, expected = make_slice_pair_probe(mesh, i, j, inner_iters, fault)
            x = slice_pair_input(mesh, i, j)
            t0 = time.perf_counter()
            out = fetch_scalar(fn(x))  # warm-up and checksum
            compile_s += time.perf_counter() - t0
            correct = abs(out - expected) <= 1e-3 * max(1.0, abs(expected))
            stats = timed_fenced(fn, x, iters, baseline_ms)
            any_unreliable = any_unreliable or stats.unreliable
            records.append(LinkResult(
                axis="dcn", name=name, device_ids=(i, j),
                rtt_ms=1e3 * stats[0] / inner_iters, rtt_mean_ms=1e3 * stats[1] / inner_iters,
                correct=correct, owner=owner,
            ))
        except Exception as exc:  # noqa: BLE001 — per-pair containment
            logger.warning("Slice-pair probe %s failed: %s", name, exc)
            if owner is None:
                # failed before membership was known: every rank is here, so
                # rank 0 records it once
                owner = rank == 0
            records.append(LinkResult(
                axis="dcn", name=name, device_ids=(i, j), rtt_ms=-1.0, rtt_mean_ms=-1.0,
                correct=False, owner=owner, error=str(exc),
            ))

    merged, any_unreliable = merge_owned_records(
        mesh, [("dcn", f"slice{i}-slice{j}", (i, j)) for i, j in pair_order],
        {r.name: r for r in records if r.owner}, any_unreliable,
    )
    return records, merged, compile_s, any_unreliable


def run_multislice_probe(
    mesh: Optional[Mesh] = None,
    *,
    n_slices: Optional[int] = None,
    iters: int = 5,
    inner_iters: int = 8,
    fault: Optional[IciFaultSpec] = None,
    pair_localization: bool = True,
    pair_rtt_factor: float = 3.0,
    pair_rtt_floor_ms: float = 0.2,
    device=None,
) -> MultiSliceProbeResult:
    """Correctness and localisation through the hierarchical sum, in-slice
    against cross-slice latency through the chained all-reduces, and the
    pair walk. ``mesh`` defaults to :func:`hybrid_slice_mesh` (a slice per
    node, or ``n_slices`` groups of nodes). Every rank must call this
    together."""
    try:
        if mesh is None:
            mesh = hybrid_slice_mesh(resolve_device(device), n_slices)
        n_sl = mesh.shape["slices"]
        per_slice_devices = mesh.size // n_sl
        slice_processes = [sorted(int(r) for r in mesh.ranks[i].ravel()) for i in range(n_sl)]

        t0 = time.perf_counter()
        hier = make_hierarchical_probe(mesh, fault)
        per_slice, global_sum = hier(torch.ones((1,), dtype=torch.float32, device=mesh.device))
        ici_fn = make_subaxis_psum_probe(mesh, mesh.axis_names[1:], inner_iters, fault)
        all_fn = make_subaxis_psum_probe(mesh, mesh.axis_names, inner_iters, fault)
        x = psum_probe_input(mesh)
        fetch_scalar(ici_fn(x))
        fetch_scalar(all_fn(x))
        compile_ms = 1e3 * (time.perf_counter() - t0)

        per_slice = [float(v) for v in per_slice.cpu().tolist()]
        expected = float(per_slice_devices)
        suspect = [i for i, v in enumerate(per_slice) if abs(v - expected) > 1e-3 * max(1.0, expected)]
        global_ok = abs(fetch_scalar(global_sum) - mesh.size) <= 1e-3 * mesh.size

        baseline_ms = fence_baseline_ms(mesh.device)
        ici_stats = timed_fenced(ici_fn, x, iters, baseline_ms)
        total_stats = timed_fenced(all_fn, x, iters, baseline_ms)
        ici_s = ici_stats[0] / inner_iters
        total_s = total_stats[0] / inner_iters

        pair_records: List[LinkResult] = []
        suspect_pairs: List[Dict[str, Any]] = []
        dcn_suspect_slices: List[int] = []
        pairs_unreliable = False
        pair_compile_s = 0.0
        if pair_localization and n_sl >= 2:
            pair_records, merged, pair_compile_s, pairs_unreliable = _walk_slice_pairs(
                mesh, iters=iters, inner_iters=inner_iters, baseline_ms=baseline_ms, fault=fault,
            )
            # min baseline: a bad slice endpoint taints 2/n of all pairs (50%
            # at n=4), which drags a median past any factor
            suspect_pairs, dcn_suspect_slices = classify_links(
                merged, pair_rtt_factor, pair_rtt_floor_ms, baseline_stat="min"
            )
            if suspect_pairs:
                logger.warning(
                    "Slice-pair walk: %d/%d suspect pairs: %s; suspect slices: %s",
                    len(suspect_pairs), len(merged), [s["name"] for s in suspect_pairs], dcn_suspect_slices,
                )

        if suspect:
            logger.warning(
                "Multi-slice probe: per-slice sums %s deviate from %.1f in slices %s",
                per_slice, expected, suspect,
            )
        return MultiSliceProbeResult(
            ok=not suspect and global_ok and not suspect_pairs,
            n_slices=n_sl,
            devices_per_slice=per_slice_devices,
            per_slice_sums=per_slice,
            suspect_slices=suspect,
            ici_rtt_ms=1e3 * ici_s,
            total_rtt_ms=1e3 * total_s,
            dcn_overhead_ms=max(0.0, 1e3 * (total_s - ici_s)),
            compile_ms=compile_ms + 1e3 * pair_compile_s,
            timing_unreliable=ici_stats.unreliable or total_stats.unreliable or pairs_unreliable,
            pair_rtts=[dataclasses.asdict(r) for r in pair_records],
            suspect_pairs=suspect_pairs,
            dcn_suspect_slices=dcn_suspect_slices,
            slice_processes=slice_processes,
        )
    except Exception as exc:  # noqa: BLE001 — a failed probe is an unhealthy reading
        logger.error("Multi-slice probe failed: %s", exc)
        return MultiSliceProbeResult(
            ok=False, n_slices=0, devices_per_slice=0, per_slice_sums=[],
            suspect_slices=[], ici_rtt_ms=-1.0, total_rtt_ms=-1.0,
            dcn_overhead_ms=-1.0, compile_ms=0.0, error=str(exc),
        )
