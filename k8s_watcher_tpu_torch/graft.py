"""The graft entry points on the port (the JAX package's ``__graft_entry__.py``).

The system's flagship computation is the probe step every GPU runs: a bf16
tensor-core product with an f32 result, folded into one integrity checksum.

- :func:`entry` returns that step and its example inputs, on the card unless
  the caller asks for the CPU.
- :func:`dryrun_multichip` runs one full probe step over ``n`` gloo ranks in
  CPU processes (parallel/cpu_ranks.py), the JAX package's virtual CPU mesh:
  the tensor-parallel product reduced over each host's ranks, the latency
  token over every rank, the checksum over hosts, the hierarchical and
  multislice probes and the per-link walk. It never touches the card.

``python __graft_entry_gpu__.py [n]`` runs the dryrun (default 8 ranks).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from k8s_watcher_tpu_torch.probe.device import resolve_device

DIM = 128  # the dryrun's per-rank block
ENTRY_SHAPE = (256, 256)


def gemm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 matrices with an f32 result: exact bf16 products
    summed in f32. On the card one cuBLAS call that reads bf16 into the
    tensor cores and writes f32; a CPU tensor, for which that call has no
    kernel, gets the same arithmetic as an f32 product of the widened inputs."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def probe_step(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product's sum when every element is finite, else NaN (filled on
    the device: a NaN made from a Python float is a copy from the host)."""
    out = gemm_f32(a, b)
    total = out.sum()
    return torch.where(torch.isfinite(out).all(), total, torch.full_like(total, float("nan")))


def entry(device=None) -> Tuple[Callable[..., torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """``(probe_step, (a, b))``: two ``(256, 256)`` bf16 matrices drawn from a
    seeded generator, on ``device`` (this rank's GPU by default)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(ENTRY_SHAPE, generator=gen).to(torch.bfloat16)
    b = torch.randn(ENTRY_SHAPE, generator=gen).to(torch.bfloat16)
    return probe_step, (a.to(device), b.to(device))


def factor_mesh(n_devices: int) -> Tuple[int, int]:
    """``n_devices`` as a balanced ``(hosts, chips)`` grid: ``chips`` is the
    smallest divisor with ``chips**2 >= n_devices`` (8 -> (2, 4), 128 ->
    (8, 16)), so the cross-host axis is real whenever ``n_devices`` is
    composite."""
    chips = n_devices
    for c in range(1, n_devices + 1):
        if n_devices % c == 0 and c * c >= n_devices:
            chips = c
            break
    return n_devices // chips, chips


def expected_links(hosts: int, chips: int) -> int:
    """The link walk's edge count on a ``(hosts, chips)`` grid (rings longer
    than 2 close)."""
    return hosts * ((chips - 1) + (chips > 2)) + chips * ((hosts - 1) + (hosts > 2))


def _dryrun_rank(rank: int, world: int) -> Dict[str, Any]:
    """One rank's share of the dryrun (parallel/cpu_ranks.py calls it on
    every rank); raises on a wrong result."""
    import torch.distributed as dist

    from k8s_watcher_tpu_torch.parallel.collectives import make_hierarchical_probe
    from k8s_watcher_tpu_torch.parallel.mesh import Mesh, own_subgroup, rank_grid, slice_grid
    from k8s_watcher_tpu_torch.probe.links import run_link_probe
    from k8s_watcher_tpu_torch.probe.multislice import run_multislice_probe

    cpu = torch.device("cpu")
    hosts, chips = factor_mesh(world)
    mesh = Mesh(dist.group.WORLD, rank_grid(world, chips), cpu)
    # tensor-parallel product: this rank holds block (host, chip) of x, of
    # shape (hosts*DIM, chips*DIM), and block chip of w, of shape
    # (chips*DIM, DIM); the partial products are summed over the host's chips
    x = torch.ones((DIM, DIM), dtype=torch.bfloat16)
    w = torch.ones((DIM, DIM), dtype=torch.bfloat16)
    full = gemm_f32(x, w)
    host_group, _ = own_subgroup(mesh.partition(("gpus",)), rank)
    if host_group is not None:
        dist.all_reduce(full, group=host_group)
    token = torch.ones((1,), dtype=torch.float32)
    dist.all_reduce(token)
    checksum = full.sum().reshape(1)
    column_group, _ = own_subgroup(mesh.partition(("hosts",)), rank)
    if column_group is not None:
        dist.all_reduce(checksum, group=column_group)
    if full.shape != (DIM, DIM) or float(token) != world:
        raise RuntimeError(f"the product's block is {tuple(full.shape)}, the token {float(token)} of {world} ranks")
    expected = hosts * DIM * DIM * (chips * DIM)
    if abs(float(checksum) / expected - 1.0) >= 1e-2:
        raise RuntimeError(f"checksum {float(checksum)} != {expected}")

    out: Dict[str, Any] = {"checksum": float(checksum), "hosts": hosts, "chips": chips, "pairs": []}
    if world % 2 == 0:
        # hierarchical sums over 2 slices, then the pair walk over 4 slices
        # when they fit (real triangulation geometry), else 2
        halves = Mesh(dist.group.WORLD, slice_grid(world, world // 2, 2), cpu)
        per_slice, total = make_hierarchical_probe(halves)(torch.ones((1,), dtype=torch.float32))
        if per_slice.tolist() != [world / 2] * 2 or float(total) != world:
            raise RuntimeError(f"hierarchical sums {per_slice.tolist()} (total {float(total)}) over {world} ranks")
        n_sl = 4 if world % 4 == 0 and world >= 8 else 2
        # iters=3 where the JAX package's one process takes 2: a pair's time
        # is the min over iterations, and each pair here is a group of up to
        # world/2 processes; at 128 ranks on 8 CPUs a healthy pair was
        # stalled past the 50 ms floor in both of 2 iterations
        ms = run_multislice_probe(Mesh(dist.group.WORLD, slice_grid(world, world // n_sl, n_sl), cpu),
                                  iters=3, inner_iters=2, pair_rtt_floor_ms=50.0)
        if ms.error is not None or not ms.ok:
            raise RuntimeError(f"multislice probe: {ms.error or ms.suspect_pairs or ms.suspect_slices}")
        out["pairs"] = [p["name"] for p in ms.pair_rtts if p["owner"]]
        out["n_slices"] = n_sl
    # iters=2: a pair's time is the min over iterations, so one stall on a
    # loaded host cannot flag a link
    link = run_link_probe(mesh, iters=2, inner_iters=2, rtt_floor_ms=50.0)
    if link.error is not None or not link.ok:
        raise RuntimeError(f"link probe: {link.error or link.suspect_links}")
    out["links"] = link.n_links  # the links this rank records; the walk's are the sum
    return out


def dryrun_multichip(n_devices: int) -> Dict[str, Any]:
    """One full probe step over ``n_devices`` gloo ranks in CPU processes;
    prints the JAX package's line and returns its numbers. Raises when a
    rank fails or a count is wrong."""
    from k8s_watcher_tpu_torch.parallel.cpu_ranks import run_cpu_ranks

    ranks = run_cpu_ranks("k8s_watcher_tpu_torch.graft:_dryrun_rank", n_devices)
    hosts, chips = factor_mesh(n_devices)
    links = sum(r["links"] for r in ranks)
    pairs = sorted(name for r in ranks for name in r["pairs"])
    n_sl = ranks[0].get("n_slices", 0)
    dcn_pairs = n_sl * (n_sl - 1) // 2
    if links != expected_links(hosts, chips):
        raise RuntimeError(f"the link walk recorded {links} links, not {expected_links(hosts, chips)}")
    if len(pairs) != dcn_pairs or len(set(pairs)) != dcn_pairs:
        raise RuntimeError(f"the pair walk recorded {pairs}, not {dcn_pairs} pairs")
    if any(r["checksum"] != ranks[0]["checksum"] for r in ranks):
        raise RuntimeError(f"the ranks disagree on the checksum: {[r['checksum'] for r in ranks]}")
    result = {"hosts": hosts, "chips": chips, "devices": n_devices, "platform": "cpu",
              "checksum": ranks[0]["checksum"], "links": links, "dcn_pairs": dcn_pairs}
    print(
        f"dryrun_multichip OK: mesh=({hosts}x{chips}) devices={n_devices} "
        f"platform=cpu checksum={result['checksum']:.3e} links={links} dcn_pairs={dcn_pairs}",
        flush=True,
    )
    return result
