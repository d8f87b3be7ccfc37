"""Process groups and the ``(hosts, gpus)`` grid of ranks.

One rank drives one GPU. Under ``torchrun`` the group comes from its
environment (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``);
without it, the probe runs in a group of one rank: NCCL on the card, gloo on
the CPU. There is no mode without a group, so the probe always goes through
the collective library it measures.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def initialize_process_group(device: torch.device) -> None:
    """Join the ``torchrun`` group, or start a group of one rank; no-op when
    a default group already exists."""
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {"device_id": device} if device.type == "cuda" else {}
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kwargs)
    else:
        # an in-process store: a one-rank group needs no address or port
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kwargs)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The probe's process group, its ranks as a ``(hosts, gpus)`` grid, and
    the device this rank drives."""

    group: dist.ProcessGroup
    ranks: np.ndarray
    device: torch.device

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)


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
