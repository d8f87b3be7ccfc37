"""Process groups, the ``(hosts, gpus)`` grid of ranks and the
``(slices, hosts, gpus)`` grid of a multi-slice deployment.

One rank drives one GPU. Under ``torchrun`` the group comes from its
environment (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``);
without it, the probe runs in a group of one rank: NCCL on the card, gloo on
the CPU. There is no mode without a group, so the probe always goes through
the collective library it measures.

A collective scoped to some axes of a grid runs on a subgroup of ranks.
Subgroups are communicators (NCCL splits one per group), so they are made
once per grid and default group by :func:`subgroups`, never once per cycle.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

HOST_AXES = ("hosts", "gpus")
SLICE_AXES = ("slices", "hosts", "gpus")


def initialize_process_group(device: torch.device) -> None:
    """Join the ``torchrun`` group, or start a group of one rank; no-op when
    a default group already exists."""
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {"device_id": device} if device.type == "cuda" else {}
    if device.type == "cuda":
        # NCCL's batched send/receive runs on the calling thread's current device
        torch.cuda.set_device(device)
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kwargs)
    else:
        # an in-process store: a one-rank group needs no address or port
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kwargs)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The probe's process group, its ranks as a ``(hosts, gpus)`` or
    ``(slices, hosts, gpus)`` grid, and the device this rank drives. The
    grid holds global ranks; the group is the default one."""

    group: dist.ProcessGroup
    ranks: np.ndarray
    device: torch.device

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return SLICE_AXES if self.ranks.ndim == 3 else HOST_AXES

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    def partition(self, reduce_axes: Sequence[str]) -> List[List[int]]:
        """The ranks grouped over ``reduce_axes``: one list per coordinate of
        the other axes, in row-major order of those coordinates."""
        names = self.axis_names
        if not reduce_axes or any(a not in names for a in reduce_axes):
            raise ValueError(f"reduce_axes {tuple(reduce_axes)} not a subset of {names}")
        keep = [i for i, a in enumerate(names) if a not in reduce_axes]
        reduce = [names.index(a) for a in reduce_axes]
        k = int(np.prod([self.ranks.shape[i] for i in reduce]))
        moved = np.transpose(self.ranks, keep + reduce).reshape(-1, k)
        return [[int(r) for r in row] for row in moved]


# communicators made by this process, keyed by the default group they were
# made under and the member lists (tuple(members)) they were made for
_GROUPS: Dict[Tuple[Any, Tuple[Tuple[int, ...], ...]], List[Optional[dist.ProcessGroup]]] = {}


def subgroups(members: Sequence[Sequence[int]]) -> List[Optional[dist.ProcessGroup]]:
    """One process group per member list, made once per default group.

    Every rank must call this with the same lists in the same order, also
    for lists it is not in: ``dist.new_group`` is collective over the
    default group. A list of every rank maps to the default group and a
    one-rank list to None (a collective over one rank is the identity);
    neither makes a communicator."""
    world = dist.group.WORLD
    key = (world, tuple(tuple(int(r) for r in m) for m in members))
    if key not in _GROUPS:
        n = dist.get_world_size()
        made: List[Optional[dist.ProcessGroup]] = []
        for m in key[1]:
            if len(m) == n:
                made.append(world)
            elif len(m) == 1:
                made.append(None)
            else:
                made.append(dist.new_group(list(m)))
        _GROUPS[key] = made
    return _GROUPS[key]


def own_subgroup(members: Sequence[Sequence[int]], rank: int) -> Tuple[Optional[dist.ProcessGroup], List[int]]:
    """This rank's group of :func:`subgroups` (made for every list) and its members."""
    groups = subgroups(members)
    for group, m in zip(groups, members):
        if rank in m:
            return group, list(m)
    raise ValueError(f"rank {rank} is in none of the groups {members}")


def rank_grid(world_size: int, local_world_size: int) -> np.ndarray:
    """Ranks grouped by node: ``torchrun`` numbers the ranks of a node
    consecutively, ``local_world_size`` to a node. Ragged sizes fall back to
    one row so the probe can still run and report the asymmetry."""
    ranks = np.arange(world_size)
    if local_world_size < 1 or world_size % local_world_size:
        logger.warning("Ragged ranks-per-node (%d of %d); using a flat grid", local_world_size, world_size)
        return ranks.reshape(1, world_size)
    return ranks.reshape(world_size // local_world_size, local_world_size)


def host_chip_mesh(device: torch.device) -> Mesh:
    """The default group over every rank, as a ``(hosts, gpus)`` grid."""
    initialize_process_group(device)
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return Mesh(dist.group.WORLD, rank_grid(world, local), device)


def slice_grid(world_size: int, local_world_size: int, n_slices: Optional[int] = None) -> np.ndarray:
    """Ranks as a ``(slices, hosts, gpus)`` grid.

    A slice is one NVLink domain: by default one node (``local_world_size``
    consecutive ranks), so the ``slices`` axis crosses the network and
    ``hosts``/``gpus`` stay inside a slice. ``n_slices`` groups consecutive
    nodes into that many slices and must divide the node count: carving
    one node into fake slices would report network numbers measured over
    NVLink. Ragged nodes raise."""
    if local_world_size < 1 or world_size % local_world_size:
        raise ValueError(f"ragged ranks-per-node: {world_size} ranks, {local_world_size} per node")
    nodes = world_size // local_world_size
    n_slices = n_slices or nodes
    if nodes % n_slices:
        raise ValueError(f"{nodes} nodes do not split into {n_slices} slices")
    return np.arange(world_size).reshape(n_slices, nodes // n_slices, local_world_size)


def hybrid_slice_mesh(device: torch.device, n_slices: Optional[int] = None) -> Mesh:
    """The default group over every rank, as a ``(slices, hosts, gpus)`` grid
    (:func:`slice_grid`, nodes of ``LOCAL_WORLD_SIZE`` ranks)."""
    initialize_process_group(device)
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return Mesh(dist.group.WORLD, slice_grid(world, local, n_slices), device)
