"""Collective probes over a process group (``torch.distributed``; NCCL on the card).

- ``make_psum_probe``: a chain of tiny all-reduces; its round-trip time is
  the collective *latency* health signal. Each round computes
  ``all_reduce(x) / n``, so the result is ``sum(x) / n`` after any number of
  rounds: with rank ``r`` contributing ``r + 1``, the fixed point
  ``(n + 1) / 2`` doubles as the correctness check.
- ``make_allreduce_bandwidth_probe``: one large bf16 all-reduce; its bus
  bandwidth ``2(n-1)/n * bytes / t`` catches degraded links that still pass
  the latency probe.

Each factory takes an optional ``IciFaultSpec`` that injects slow or corrupt
behaviour on one rank. The subaxis, hierarchical, slice-pair and pair probes
of the JAX package come with the links and multislice slices.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from k8s_watcher_tpu_torch import carry
from k8s_watcher_tpu_torch.faults.ici import IciFaultSpec, apply_fault
from k8s_watcher_tpu_torch.parallel.mesh import Mesh


def psum_probe_input(mesh: Mesh) -> torch.Tensor:
    """This rank's share of ``1 .. n``: a (1,) float32 tensor."""
    return carry.rank_share(carry.psum_input(mesh.size), mesh.rank, mesh.device)


def make_psum_probe(
    mesh: Mesh, inner_iters: int = 1, fault: Optional[IciFaultSpec] = None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``inner_iters`` chained ``all_reduce(SUM) / n`` rounds of this rank's
    share; each round waits on the previous one, so per-round latency is
    call time / inner_iters."""
    if inner_iters < 1:
        raise ValueError("inner_iters must be >= 1")
    n, rank = mesh.size, mesh.rank

    def probe(x: torch.Tensor) -> torch.Tensor:
        y = apply_fault(x, fault, rank).clone()
        for _ in range(inner_iters):
            dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.group)
            y.div_(n)
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
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.group)
        return y

    return probe


def allreduce_bus_bandwidth_gbps(payload_bytes: int, n_devices: int, seconds: float) -> float:
    """Standard all-reduce bus-bandwidth formula: 2·(n-1)/n · S / t."""
    if seconds <= 0 or n_devices <= 0:
        return 0.0
    moved = 2.0 * (n_devices - 1) / n_devices * payload_bytes
    return moved / seconds / 1e9
