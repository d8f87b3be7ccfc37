"""Per-link probe: localise a degraded link or GPU, not just detect it (the
JAX package's ``probe/links.py`` on ranks).

The aggregate all-reduce (probe/ici.py) answers "is the fabric healthy?";
when it is not, operators need to know which GPU or link to drain. This
prober walks every neighbour pair of the ``(hosts, gpus)`` rank grid, timing
a chained exchange of one scalar per link (parallel/collectives.py:
make_pair_probe) and checksumming the round trip:

- a **slow GPU** stretches every link it is an end of, so the common
  endpoint of the slow links is the suspect;
- a **degraded link** stretches only its own pair;
- a **corrupt GPU** fails the checksum of every link it touches.

Outliers are flagged against the per-axis median link RTT, with an absolute
floor so microsecond jitter cannot trip it.

Process model: one rank per GPU, so every link joins two ranks. Every rank
walks the same global link list and runs the links that touch it, both ends
in lockstep; the lower rank owns the record. A rank sees only the 2-4 links
that touch it, and that view cannot localise: a slow rank's links are all
slow, so its own baseline is slow and it flags nothing, while each of its
neighbours sees one slow link, which implicates no device. So after the
walk every rank all-gathers the owned records (one row per link in the
global order) and classifies the merged set, as the JAX package's
multislice walk does for slice pairs. The verdict is the same on every rank
and is the JAX package's single-process verdict.

Faults for chaos tests are injected with ``IciFaultSpec`` (faults/ici.py),
keyed by rank.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from k8s_watcher_tpu_torch.faults.ici import IciFaultSpec
from k8s_watcher_tpu_torch.parallel.collectives import make_pair_barrier, make_pair_probe, pair_agree, pair_probe_input
from k8s_watcher_tpu_torch.parallel.mesh import Mesh, host_chip_mesh
from k8s_watcher_tpu_torch.probe import spans, timing
from k8s_watcher_tpu_torch.probe.device import resolve_device
from k8s_watcher_tpu_torch.probe.timing import fetch_scalar, read_scalar

logger = logging.getLogger(__name__)

# Test hook: when set, ``_PREP_FAILURE_HOOK(link_name)`` is consulted during
# the preparation phase and a truthy return injects a preparation failure for
# that link: the only way to exercise the agreement protocol below without
# real breakage. Production leaves it None.
_PREP_FAILURE_HOOK: Optional[Callable[[str], bool]] = None

# a row of the merged-record gather held by a rank that does not own the link
_NOT_OWNED = -2.0


def _all_ranks_ready(mesh: Mesh, prep_ok: bool) -> bool:
    """AND over every rank of "my preparations succeeded".

    The agreement round of the prepare / agree / execute protocol: every
    rank always joins this one all-reduce (the only collective whose
    membership does not depend on per-link outcomes), so every rank derives
    the same verdict without a side channel. One rank has nobody to agree
    with."""
    if dist.get_world_size() == 1:
        return prep_ok
    flag = torch.full((1,), 1.0 if prep_ok else 0.0, dtype=torch.float32, device=mesh.device)
    spans.count("collectives")
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return fetch_scalar(flag) >= 1.0


@dataclasses.dataclass
class LinkResult:
    axis: str  # "chips" (within a node) | "hosts" (across nodes)
    name: str  # e.g. "host0/chip1-chip2"
    device_ids: Tuple[int, int]  # the ranks at the two ends
    rtt_ms: float  # min per-hop over iters (-1 when the probe errored)
    rtt_mean_ms: float
    correct: bool
    # this rank is the canonical recorder for the link (the lower rank)
    owner: bool = True
    error: Optional[str] = None


@dataclasses.dataclass
class LinkProbeResult:
    ok: bool
    n_links: int  # links this rank canonically records (owner=True)
    n_observed: int  # links this rank walked, owned or not
    median_rtt_ms: float  # over every link of the merged walk
    links: List[LinkResult]  # owned records only: a merge across ranks is dedup-free
    suspect_links: List[Dict[str, Any]]  # {name, device_ids, reason, rtt_ms} over the merged walk
    suspect_devices: List[int]  # ranks implicated by >1 suspect link
    compile_ms: float  # first exchange of each link (NCCL connects pairs lazily)
    error: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def enumerate_links(mesh: Mesh) -> List[Tuple[str, str, int, int]]:
    """Neighbour pairs along each grid axis: ``(axis, name, rank_a, rank_b)``.

    Rows of the grid are the GPUs of one node; columns cross nodes. Rings
    longer than 2 get the wraparound edge. Axis labels and names are the
    JAX package's (``chips``, ``host0/chip1-chip2``), so a report reads the
    same from either package."""
    grid = np.asarray(mesh.ranks)
    if grid.ndim == 1:
        grid = grid.reshape(1, -1)
    hosts, chips = grid.shape
    links: List[Tuple[str, str, int, int]] = []
    for h in range(hosts):
        for c in range(chips - 1):
            links.append(("chips", f"host{h}/chip{c}-chip{c + 1}", int(grid[h, c]), int(grid[h, c + 1])))
        if chips > 2:
            links.append(("chips", f"host{h}/chip{chips - 1}-chip0", int(grid[h, chips - 1]), int(grid[h, 0])))
    for c in range(chips):
        for h in range(hosts - 1):
            links.append(("hosts", f"chip{c}/host{h}-host{h + 1}", int(grid[h, c]), int(grid[h + 1, c])))
        if hosts > 2:
            links.append(("hosts", f"chip{c}/host{hosts - 1}-host0", int(grid[hosts - 1, c]), int(grid[0, c])))
    return links


def classify_links(
    observed: List[LinkResult],
    rtt_factor: float,
    rtt_floor_ms: float,
    baseline_stat: str = "median",
) -> Tuple[List[Dict[str, Any]], List[int]]:
    """Pure suspect classification: ``(suspect_links, suspect_devices)``.

    A link is suspect when it errored, failed its checksum ("corrupt"), or
    its RTT exceeds ``max(rtt_floor_ms, rtt_factor * per-axis baseline)``
    ("slow"). The baseline of a population of >= 3 is its median (or its
    min with ``baseline_stat="min"``, for walks where one bad endpoint
    taints a large share, as in the slice-pair walk); of 2, the min; of 1,
    there is no reference and only the floor applies. Within-node and
    cross-node links have separate baselines. A device is suspect when it
    is an endpoint of >= 2 suspect links (one bad link implicates the link,
    not a device). The JAX package's rule, unchanged."""
    if baseline_stat not in ("median", "min"):
        raise ValueError(f"baseline_stat must be 'median' or 'min', got {baseline_stat!r}")
    thresholds: Dict[str, float] = {}
    for axis in {r.axis for r in observed}:
        population = [r.rtt_ms for r in observed if r.axis == axis and r.rtt_ms >= 0]
        if not population:
            base = 0.0
        elif len(population) >= 3:
            base = float(np.median(population)) if baseline_stat == "median" else min(population)
        elif len(population) == 2:
            base = min(population)
        else:
            base = population[0]
        thresholds[axis] = max(rtt_floor_ms, rtt_factor * base)
    suspects: List[Dict[str, Any]] = []
    for r in observed:
        if r.error is not None:
            suspects.append({"name": r.name, "device_ids": list(r.device_ids), "reason": "error", "rtt_ms": r.rtt_ms})
        elif not r.correct:
            suspects.append({"name": r.name, "device_ids": list(r.device_ids), "reason": "corrupt", "rtt_ms": r.rtt_ms})
        elif r.rtt_ms > thresholds[r.axis]:
            suspects.append({"name": r.name, "device_ids": list(r.device_ids), "reason": "slow", "rtt_ms": r.rtt_ms})

    endpoint_counts: Dict[int, int] = {}
    for s in suspects:
        for d in s["device_ids"]:
            endpoint_counts[d] = endpoint_counts.get(d, 0) + 1
    suspect_devices = sorted(d for d, c in endpoint_counts.items() if c >= 2)
    return suspects, suspect_devices


def _fenced_pair(fn, x, iters: int) -> Tuple[float, List[Tuple[float, float]]]:
    """The CPU's twin of a kept pair graph: a warm exchange (NCCL connects a
    pair on first use), then ``(warm_s, [(seconds, value), ...])`` of
    ``iters`` fenced calls, on the host's clock: the readback is the
    completion fence. Its cost is deliberately not subtracted: every link
    carries the same fence, so the outlier test (factor x median across
    links) cancels it, whereas subtracting a noisy baseline can clamp fast
    links to ~0 and turn fence variance into false "slow" suspects."""
    with spans.span("probe.links.setup"):
        t0 = time.perf_counter()
        fetch_scalar(fn(x))
        warm_s = time.perf_counter() - t0
    samples = []
    with spans.span("probe.links.timed"):
        for _ in range(iters):
            t0 = time.perf_counter()
            value = read_scalar(fn(x))
            samples.append((time.perf_counter() - t0, value))
    return warm_s, samples


def _pair_stats(samples, expected: float, inner_iters: int) -> Tuple[float, float, bool]:
    """(min_per_hop_s, mean_per_hop_s, correct) of ``[(seconds, value), ...]``."""
    times = [t for t, _ in samples]
    correct = all(abs(value - expected) <= 1e-3 * max(1.0, abs(expected)) for _, value in samples)
    return min(times) / inner_iters, (sum(times) / len(times)) / inner_iters, correct


def merge_owned_records(
    mesh: Mesh,
    order: List[Tuple[str, str, Tuple[int, int]]],
    owned: Dict[str, LinkResult],
    flag: bool = False,
) -> Tuple[List[LinkResult], bool]:
    """Every record of ``order`` (``(axis, name, device_ids)`` in the global
    order), on every rank, and the OR of every rank's ``flag``.

    One all-gather of a ``(len(order) + 1, 3)`` float32 block per rank: the
    owner of a record writes ``[rtt_ms, rtt_mean_ms, correct]`` in its row
    (an error travels as ``rtt_ms = -1``; its text stays with the owner),
    every other rank the ``-2`` sentinel. The last row carries each rank's
    flag: a rank that owns no record must still be heard. Every rank, the
    owner too, reads the numbers back from the gather, so every rank
    classifies the same values."""
    buf = torch.full((len(order) + 1, 3), _NOT_OWNED, dtype=torch.float32)
    for k, (_, name, _) in enumerate(order):
        r = owned.get(name)
        if r is not None:
            buf[k] = torch.tensor([r.rtt_ms, r.rtt_mean_ms, 1.0 if r.correct else 0.0])
    buf[-1, 0] = 1.0 if flag else 0.0
    world = dist.get_world_size()
    gathered = torch.empty((world * buf.shape[0], 3), dtype=torch.float32, device=mesh.device)
    spans.count("collectives")
    dist.all_gather_into_tensor(gathered, buf.to(mesh.device))
    with spans.sync():
        rows = gathered.cpu().view(world, buf.shape[0], 3).numpy()
    merged: List[LinkResult] = []
    for k, (axis, name, ids) in enumerate(order):
        held = rows[:, k, :][rows[:, k, 0] > _NOT_OWNED + 0.5]
        row = held[0] if held.shape[0] else (-1.0, -1.0, 0.0)
        mine = owned.get(name)
        merged.append(LinkResult(
            axis=axis, name=name, device_ids=ids, rtt_ms=float(row[0]), rtt_mean_ms=float(row[1]),
            correct=bool(row[2] > 0.5), owner=mine is not None,
            error=mine.error if mine is not None else (
                None if row[0] >= 0.0 else "probe failed on its owner rank"),
        ))
    return merged, bool(np.any(rows[:, -1, 0] > 0.5))


@spans.traced("probe.links")
def run_link_probe(
    mesh: Optional[Mesh] = None,
    *,
    iters: int = 5,
    inner_iters: int = 8,
    rtt_factor: float = 3.0,
    rtt_floor_ms: float = 0.05,
    fault: Optional[IciFaultSpec] = None,
    device=None,
) -> LinkProbeResult:
    """Probe every grid link; flag outliers and triangulate suspect ranks.

    Every rank must call this together: the agreement all-reduce and the
    record gather are collectives over the default group."""
    try:
        with spans.span("probe.links.setup"):
            if mesh is None:
                mesh = host_chip_mesh(resolve_device(device))
            links = enumerate_links(mesh)
            if not links:
                return LinkProbeResult(
                    ok=True, n_links=0, n_observed=0, median_rtt_ms=0.0, links=[],
                    suspect_links=[], suspect_devices=[], compile_ms=0.0,
                )
            me = mesh.rank
            mine = [link for link in links if me in link[2:]]

            # PREPARATION: everything local happens before any exchange. A local
            # failure is one-sided (the peer would wait forever in an exchange
            # this rank never joins), so it is reconciled across ranks below.
            observed: List[LinkResult] = []
            prepared = []
            prep_ok = True
            for axis, name, a, b in mine:
                owner = me == min(a, b)
                try:
                    if _PREP_FAILURE_HOOK is not None and _PREP_FAILURE_HOOK(name):
                        raise RuntimeError("injected preparation failure (test hook)")
                    fn, expected = make_pair_probe(a, b, inner_iters, fault)
                    x = pair_probe_input(a, b, mesh.device)
                except Exception as exc:  # noqa: BLE001 — containment, see above
                    logger.warning("Link probe %s preparation failed: %s", name, exc)
                    observed.append(LinkResult(
                        axis=axis, name=name, device_ids=(a, b), rtt_ms=-1.0, rtt_mean_ms=-1.0,
                        correct=False, owner=owner, error=f"preparation: {exc}",
                    ))
                    prep_ok = False
                    continue
                prepared.append((axis, name, a, b, owner, fn, x, expected))

            # AGREEMENT: if any rank failed to prepare, every rank skips every
            # exchange this cycle; otherwise the failed rank's peers would hang.
            run_links = _all_ranks_ready(mesh, prep_ok)
            if not run_links:
                logger.warning("Link probe: a rank failed preparation; skipping the walk this cycle")

        # EXECUTION, in the global order on every rank, so overlapping pairs
        # meet deterministically.
        compile_s = 0.0
        on_device = timing.timed_on_device(mesh.device)
        for axis, name, a, b, owner, fn, x, expected in prepared:
            if not run_links:
                observed.append(LinkResult(
                    axis=axis, name=name, device_ids=(a, b), rtt_ms=-1.0, rtt_mean_ms=-1.0,
                    correct=False, owner=owner, error="skipped: a peer rank failed preparation",
                ))
                continue
            try:
                if on_device:  # a capture's first run connects the pair
                    _, warm_s, samples = timing.kept_collective_ms(
                        ("pair", name, inner_iters, fault), fn, x, make_pair_barrier(a, b, mesh.device),
                        lambda ok: pair_agree(ok, a, b, mesh.device), iters, "probe.links")
                    samples = [(ms / 1e3, value) for ms, value in samples]
                else:
                    warm_s, samples = _fenced_pair(fn, x, iters)
                compile_s += warm_s
                rtt_min, rtt_mean, correct = _pair_stats(samples, expected, inner_iters)
            except Exception as exc:  # noqa: BLE001 — a failed exchange errors on both ends
                logger.warning("Link probe %s failed: %s", name, exc)
                observed.append(LinkResult(
                    axis=axis, name=name, device_ids=(a, b), rtt_ms=-1.0, rtt_mean_ms=-1.0,
                    correct=False, owner=owner, error=str(exc),
                ))
                continue
            observed.append(LinkResult(
                axis=axis, name=name, device_ids=(a, b), rtt_ms=1e3 * rtt_min,
                rtt_mean_ms=1e3 * rtt_mean, correct=correct, owner=owner,
            ))

        merged, _ = merge_owned_records(
            mesh, [(axis, name, (a, b)) for axis, name, a, b in links],
            {r.name: r for r in observed if r.owner},
        )
        valid = [r.rtt_ms for r in merged if r.rtt_ms >= 0]
        median = float(np.median(valid)) if valid else -1.0
        suspects, suspect_devices = classify_links(merged, rtt_factor, rtt_floor_ms)
        if suspects:
            logger.warning(
                "Link probe: %d/%d suspect links (median %.3f ms): %s; suspect ranks: %s",
                len(suspects), len(merged), median, [s["name"] for s in suspects], suspect_devices,
            )
        return LinkProbeResult(
            ok=not suspects,
            n_links=sum(1 for r in observed if r.owner),
            n_observed=len(observed),
            median_rtt_ms=median,
            links=[r for r in observed if r.owner],
            suspect_links=suspects,
            suspect_devices=suspect_devices,
            compile_ms=1e3 * compile_s,
        )
    except Exception as exc:  # noqa: BLE001 — a failed probe is an unhealthy reading
        logger.error("Link probe failed: %s", exc)
        return LinkProbeResult(
            ok=False, n_links=0, n_observed=0, median_rtt_ms=-1.0, links=[],
            suspect_links=[], suspect_devices=[], compile_ms=0.0, error=str(exc),
        )
