"""Collective probes over a process group (``torch.distributed``; NCCL on the card).

- ``make_psum_probe``: a chain of tiny all-reduces; its round-trip time is
  the collective *latency* health signal. Each round computes
  ``all_reduce(x) / n``, so the result is ``sum(x) / n`` after any number of
  rounds: with rank ``r`` contributing ``r + 1``, the fixed point
  ``(n + 1) / 2`` doubles as the correctness check.
- ``make_allreduce_bandwidth_probe``: one large bf16 all-reduce; its bus
  bandwidth ``2(n-1)/n * bytes / t`` catches degraded links that still pass
  the latency probe.
- ``make_subaxis_psum_probe``: the chained all-reduce over a subset of the
  grid's axes, on a subgroup of ranks; on a ``(slices, hosts, gpus)`` grid
  the ``(hosts, gpus)`` chain stays inside a slice and the full chain adds
  the cross-slice hop.
- ``make_hierarchical_probe``: per-slice sums, then the cross-slice sum.
- ``make_slice_pair_probe``: the cross-slice hop between two slices only.
- ``make_pair_probe``: a chained exchange of one scalar between two ranks,
  the per-link primitive of the link walk (``probe/links.py``).
- ``make_barrier``, ``make_pair_barrier``: one tiny all-reduce or exchange
  that ends on the device once every member has queued it, ahead of a call
  timed on the device (``probe/timing.py:collective_times_ms``);
  ``all_agree``, ``pair_agree``: whether a flag holds on every member.

Point-to-point exchanges run through ``dist.batch_isend_irecv`` on the
default group, so a link or a slice pair needs no communicator of its own
(NCCL runs a batched send/receive on the group's communicator). The subaxis
and hierarchical probes run on subgroups from ``parallel/mesh.py:subgroups``,
made once per grid: on a ``(slices, hosts, gpus)`` grid, one per slice and
one per ``(host, gpu)`` position.

Each factory takes an optional ``IciFaultSpec`` that injects slow or corrupt
behaviour on one rank. Every collective call, and every batched exchange,
counts one in the open cycle's ``collectives`` counter (probe/spans.py).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from k8s_watcher_tpu_torch import carry
from k8s_watcher_tpu_torch.faults.ici import IciFaultSpec, apply_fault
from k8s_watcher_tpu_torch.parallel.mesh import Mesh, own_subgroup
from k8s_watcher_tpu_torch.probe import spans

Probe = Callable[[torch.Tensor], torch.Tensor]


def psum_probe_input(mesh: Mesh) -> torch.Tensor:
    """This rank's share of ``1 .. n``: a (1,) float32 tensor."""
    return carry.rank_share(carry.psum_input(mesh.size), mesh.rank, mesh.device)


def make_psum_probe(mesh: Mesh, inner_iters: int = 1, fault: Optional[IciFaultSpec] = None) -> Probe:
    """``inner_iters`` chained ``all_reduce(SUM) / n`` rounds of this rank's
    share; each round waits on the previous one, so per-round latency is
    call time / inner_iters. The all-axes case of :func:`make_subaxis_psum_probe`."""
    return make_subaxis_psum_probe(mesh, mesh.axis_names, inner_iters, fault)


def make_subaxis_psum_probe(
    mesh: Mesh,
    reduce_axes: Sequence[str],
    inner_iters: int = 1,
    fault: Optional[IciFaultSpec] = None,
) -> Probe:
    """Chained ``all_reduce(SUM) / k`` over the ranks that share this rank's
    coordinates on the axes not in ``reduce_axes`` (``k`` of them).

    The output is this rank's group mean: with rank ``r`` contributing
    ``r + 1``, the mean of its group's shares after any number of rounds.
    The group is a communicator made once per grid (``mesh.subgroups``);
    every rank must build the probe, in the same order."""
    if inner_iters < 1:
        raise ValueError("inner_iters must be >= 1")
    rank = mesh.rank
    group, members = own_subgroup(mesh.partition(tuple(reduce_axes)), rank)
    k = len(members)

    def probe(x: torch.Tensor) -> torch.Tensor:
        y = apply_fault(x, fault, rank).clone()
        for _ in range(inner_iters):
            if group is not None:
                spans.count("collectives")
                dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
            y.div_(k)
        return y

    return probe


def bandwidth_probe_input(mesh: Mesh, payload_bytes: int) -> torch.Tensor:
    """A bf16 payload of ~``payload_bytes`` for this rank."""
    chunk = max(128, payload_bytes // 2)  # bf16 = 2 bytes
    return torch.ones((1, chunk), dtype=torch.bfloat16, device=mesh.device)


def make_allreduce_bandwidth_probe(
    mesh: Mesh, payload_bytes: int, fault: Optional[IciFaultSpec] = None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """One all-reduce of the payload, out of place (the input is reused by
    every timed call)."""
    rank = mesh.rank

    def probe(x: torch.Tensor) -> torch.Tensor:
        y = apply_fault(x, fault, rank).clone()
        spans.count("collectives")
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.group)
        return y

    return probe


def _exchange(send: torch.Tensor, recv: torch.Tensor, peer: int) -> None:
    """Send ``send`` to ``peer`` and receive its tensor into ``recv``, both
    posted together so two ranks exchanging with each other cannot block."""
    ops = [dist.P2POp(dist.isend, send, peer), dist.P2POp(dist.irecv, recv, peer)]
    spans.count("collectives")
    for request in dist.batch_isend_irecv(ops):
        request.wait()


def _require_slices(mesh: Mesh, what: str) -> None:
    if mesh.axis_names[0] != "slices":
        raise ValueError(f"{what} wants a ('slices', 'hosts', 'gpus') grid, got {mesh.axis_names}")


def _grid_position(mesh: Mesh, rank: int) -> Tuple[int, ...]:
    where = np.argwhere(mesh.ranks == rank)
    if where.shape[0] == 0:
        raise ValueError(f"rank {rank} is not in the grid")
    return tuple(int(c) for c in where[0])


def make_hierarchical_probe(
    mesh: Mesh, fault: Optional[IciFaultSpec] = None
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Per-slice sum over ``(hosts, gpus)``, then the cross-slice hop.

    Returns ``(per_slice_sums, global_sum)`` of the ranks' inputs, both
    replicated on every rank: each rank scatters its slice's sum into a
    one-hot vector of length ``slices`` and the vectors are summed over the
    ``slices`` axis (one member of every slice per group), so every rank
    can classify every slice. The global sum is a local sum of that vector."""
    _require_slices(mesh, "hierarchical probe")
    rank = mesh.rank
    ici_group, _ = own_subgroup(mesh.partition(("hosts", "gpus")), rank)
    dcn_group, _ = own_subgroup(mesh.partition(("slices",)), rank)
    n_slices = mesh.shape["slices"]
    my_slice = _grid_position(mesh, rank)[0]

    def probe(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        y = apply_fault(x, fault, rank).clone()
        if ici_group is not None:
            spans.count("collectives")
            dist.all_reduce(y, op=dist.ReduceOp.SUM, group=ici_group)
        vec = torch.zeros((n_slices,), dtype=y.dtype, device=y.device)
        vec[my_slice] = y[0]
        if dcn_group is not None:
            spans.count("collectives")
            dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=dcn_group)
        return vec, vec.sum()

    return probe


def _pair_submesh(mesh: Mesh, i: int, j: int) -> np.ndarray:
    """The ``(2, hosts, gpus)`` ranks of slices ``i`` and ``j``, ``i`` first."""
    return np.stack([mesh.ranks[i], mesh.ranks[j]], axis=0)


def slice_pair_members(mesh: Mesh, i: int, j: int) -> List[int]:
    return sorted(int(r) for r in _pair_submesh(mesh, i, j).ravel())


def slice_pair_input(mesh: Mesh, i: int, j: int) -> torch.Tensor:
    """This rank's share of ``1 .. n`` over the ``(2, hosts, gpus)`` submesh of
    slices ``i`` and ``j`` (slice ``i``'s ranks first)."""
    sub = _pair_submesh(mesh, i, j).ravel()
    index = int(np.flatnonzero(sub == mesh.rank)[0])
    return carry.rank_share(carry.psum_input(sub.size), index, mesh.device)


def make_slice_pair_probe(
    mesh: Mesh, i: int, j: int, inner_iters: int = 1, fault: Optional[IciFaultSpec] = None
) -> Tuple[Probe, float]:
    """Chained cross-slice hop between slices ``i`` and ``j``, closed so every
    member holds the checksum.

    Each of the ``inner_iters`` rounds exchanges this rank's value with its
    counterpart (same host and GPU position) in the other slice and keeps
    the mean: pure cross-slice traffic. The close sums the means over this
    rank's slice (its ``(hosts, gpus)`` group) and adds the counterpart's
    slice sum from one more exchange. That is the sum over the ``n`` ranks
    of both slices, as the JAX package's closing psum over the pair submesh
    computes it, but on communicators the grid already has: a slice pair
    gets no group of its own. With input :func:`slice_pair_input` every
    member holds ``n(n+1)/2``; any other value means a member corrupted the
    payload. Returns ``(fn, expected)``; only members of the two slices may
    call it, all of them together."""
    _require_slices(mesh, "slice-pair probe")
    if inner_iters < 1:
        raise ValueError("inner_iters must be >= 1")
    i, j = sorted((i, j))
    if i == j or not 0 <= i < j < mesh.shape["slices"]:
        raise ValueError(f"slice pair ({i}, {j}) out of range for {mesh.shape['slices']} slices")
    rank = mesh.rank
    sub = _pair_submesh(mesh, i, j)
    where = np.argwhere(sub == rank)
    if where.shape[0] == 0:
        raise ValueError(f"rank {rank} is in neither slice {i} nor slice {j}")
    s, h, g = (int(c) for c in where[0])
    peer = int(sub[1 - s, h, g])
    ici_group, _ = own_subgroup(mesh.partition(("hosts", "gpus")), rank)
    n = sub.size

    def probe(x: torch.Tensor) -> torch.Tensor:
        y = apply_fault(x, fault, rank).clone()
        peer_value = torch.empty_like(y)
        for _ in range(inner_iters):
            _exchange(y, peer_value, peer)
            y.add_(peer_value).div_(2.0)
        if ici_group is not None:
            spans.count("collectives")
            dist.all_reduce(y, op=dist.ReduceOp.SUM, group=ici_group)
        _exchange(y, peer_value, peer)
        return y + peer_value

    return probe, n * (n + 1) / 2.0


def make_pair_probe(
    rank_a: int, rank_b: int, inner_iters: int = 8, fault: Optional[IciFaultSpec] = None
) -> Tuple[Probe, float]:
    """A chained exchange of one float32 scalar between ranks ``a`` and ``b``.

    ``inner_iters`` serialized exchanges (each sends what the last one
    received) bring every value back home after an even count; one more
    exchange and an add then leave ``1.0 + 2.0 = 3.0`` on both ends with the
    input of :func:`pair_probe_input`. Any other value means a member
    corrupted the payload. Per-hop latency is call time / inner_iters. The
    exchanges ride the default group: a link gets no communicator of its
    own. Returns ``(fn, expected)``; only ``a`` and ``b`` may call it."""
    if inner_iters < 2 or inner_iters % 2:
        raise ValueError("inner_iters must be an even integer >= 2")
    if rank_a == rank_b:
        raise ValueError(f"a pair needs two ranks, got {rank_a} twice")

    def probe(x: torch.Tensor) -> torch.Tensor:
        me = dist.get_rank()
        if me not in (rank_a, rank_b):
            raise ValueError(f"rank {me} is not an end of the pair ({rank_a}, {rank_b})")
        peer = rank_b if me == rank_a else rank_a
        value = apply_fault(x, fault, me).clone()
        received = torch.empty_like(value)
        for _ in range(inner_iters):
            _exchange(value, received, peer)
            value, received = received, value
        _exchange(value, received, peer)
        return value + received

    return probe, 3.0


def pair_probe_input(rank_a: int, rank_b: int, device) -> torch.Tensor:
    """This end's scalar of the pair: 1.0 on ``a``, 2.0 on ``b``, as (1,) float32."""
    me = dist.get_rank()
    if me not in (rank_a, rank_b):
        raise ValueError(f"rank {me} is not an end of the pair ({rank_a}, {rank_b})")
    return carry.rank_share(carry.psum_input(2), 0 if me == rank_a else 1, device)


def make_barrier(group, device) -> Callable[[], None]:
    """One all-reduce of a one-element int32 tensor over ``group``: on the
    device it ends once every member has queued it."""
    token = torch.zeros((1,), dtype=torch.int32, device=device)

    def barrier() -> None:
        spans.count("collectives")
        dist.all_reduce(token, op=dist.ReduceOp.SUM, group=group)

    return barrier


def make_pair_barrier(rank_a: int, rank_b: int, device) -> Callable[[], None]:
    """One exchange of a one-element int32 tensor between ranks ``a`` and
    ``b``: on the device it ends once both have queued it. Only ``a`` and
    ``b`` may call it."""
    send = torch.zeros((1,), dtype=torch.int32, device=device)
    recv = torch.zeros_like(send)

    def barrier() -> None:
        _exchange(send, recv, rank_b if dist.get_rank() == rank_a else rank_a)

    return barrier


def all_agree(ok: bool, device, group=None) -> bool:
    """Whether ``ok`` holds on every member of ``group``: the MIN of a
    one-element flag, all-reduced; every member must call it."""
    flag = torch.full((1,), int(ok), dtype=torch.int32, device=device)
    spans.count("collectives")
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    with spans.sync():
        return bool(flag.item())


def pair_agree(ok: bool, rank_a: int, rank_b: int, device) -> bool:
    """Whether ``ok`` holds on both ends of the pair ``(a, b)``, from one
    exchange of a flag; only ``a`` and ``b`` may call it."""
    mine = torch.full((1,), int(ok), dtype=torch.int32, device=device)
    theirs = torch.zeros_like(mine)
    _exchange(mine, theirs, rank_b if dist.get_rank() == rank_a else rank_a)
    with spans.sync():
        return bool(torch.minimum(mine, theirs).item())


def allreduce_bus_bandwidth_gbps(payload_bytes: int, n_devices: int, seconds: float) -> float:
    """Standard all-reduce bus-bandwidth formula: 2·(n-1)/n · S / t."""
    if seconds <= 0 or n_devices <= 0:
        return 0.0
    moved = 2.0 * (n_devices - 1) / n_devices * payload_bytes
    return moved / seconds / 1e9
