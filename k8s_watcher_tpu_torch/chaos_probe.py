"""Chaos drill: inject a fault into the collectives and check that the probes
localise it (the JAX package's ``scripts/chaos_probe.py`` on ranks).

Pick a rank to make slow or corrupt (``faults/ici.py``), run the aggregate,
per-link and (with ``--slices``) multislice probes with the fault injected,
and report whether each probe (a) detected it and (b) named the right rank
or slice. Device ids are ranks. Run it on the card to check the detection
thresholds of a topology before trusting them in production:

    torchrun --nproc-per-node=gpu -m k8s_watcher_tpu_torch.chaos_probe --corrupt-device 5
    python -m k8s_watcher_tpu_torch.chaos_probe --cpu-ranks 8 --corrupt-device 5 --slices 2

``--cpu-ranks N`` runs N gloo ranks in CPU processes instead of the card
(the JAX package's ``--cpu-mesh N``): one node of N ranks, or with
``--slices S`` S nodes of N/S ranks, one per slice, since a slice is a node
(parallel/mesh.py:slice_grid) and one node cannot be carved into fake slices.
Under ``torchrun`` every rank runs the drill; rank 0 prints. The exit code is
1 when the fault was missed or misplaced, 2 when no fault was asked for.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any, Dict, List, Optional

# the per-link floor: microsecond jitter on NVLink must not trip it, and on
# CPU ranks, where a loaded host stalls a rank for tens of milliseconds,
# nothing below the JAX package's CPU dryrun floor is a fault (a --slow-device
# fault on CPU ranks needs --slow-iters well above the default to clear it:
# some 3,000 128x128 bf16 matmuls)
RTT_FLOOR_MS = {"cuda": 0.05, "cpu": 50.0}


def drill(rank: int, world: int, *, slow_device: Optional[int], corrupt_device: Optional[int], slow_iters: int,
          slices: int, device: Optional[str] = None) -> Dict[str, Any]:
    """The drill on this rank; every rank of the group calls it together and
    gets the same verdict (the walks classify merged records)."""
    from k8s_watcher_tpu_torch.faults.ici import IciFaultSpec
    from k8s_watcher_tpu_torch.parallel.mesh import host_chip_mesh
    from k8s_watcher_tpu_torch.probe.device import resolve_device
    from k8s_watcher_tpu_torch.probe.ici import run_ici_probe
    from k8s_watcher_tpu_torch.probe.links import run_link_probe
    from k8s_watcher_tpu_torch.probe.multislice import run_multislice_probe

    dev = resolve_device("cpu" if device is None else device)
    mesh = host_chip_mesh(dev)
    fault = IciFaultSpec(slow_rank=slow_device, slow_iters=slow_iters, corrupt_rank=corrupt_device)
    injected = [d for d in (slow_device, corrupt_device) if d is not None]
    result: Dict[str, Any] = {"injected": dataclasses.asdict(fault), "n_devices": mesh.size}

    baseline = run_ici_probe(mesh, payload_bytes=0, iters=3, inner_iters=4)
    faulted = run_ici_probe(mesh, payload_bytes=0, iters=3, inner_iters=4, fault=fault)
    result["aggregate"] = {
        "detected": (not faulted.ok) or faulted.psum_rtt_ms > 3 * max(baseline.psum_rtt_ms, 1e-6),
        "baseline_rtt_ms": round(baseline.psum_rtt_ms, 4),
        "faulted_rtt_ms": round(faulted.psum_rtt_ms, 4),
        "checksum_ok": faulted.psum_correct,
    }

    links = run_link_probe(mesh, iters=3, inner_iters=4, rtt_floor_ms=RTT_FLOOR_MS[dev.type], fault=fault)
    result["links"] = {
        "suspect_devices": links.suspect_devices,
        "suspect_links": [s["name"] for s in links.suspect_links],
        "localized_correctly": sorted(links.suspect_devices) == sorted(set(injected)),
    }
    ok = result["aggregate"]["detected"] and result["links"]["localized_correctly"]

    if slices > 1:
        ms = run_multislice_probe(n_slices=slices, iters=3, inner_iters=4, fault=fault, device=dev)
        result["multislice"] = {
            "suspect_slices": ms.suspect_slices,
            "per_slice_sums": ms.per_slice_sums,
            "dcn_overhead_ms": round(ms.dcn_overhead_ms, 4),
            "suspect_pairs": [s["name"] for s in ms.suspect_pairs],
            "dcn_suspect_slices": ms.dcn_suspect_slices,
        }

        def slices_of(r: int) -> List[int]:
            return [s for s, members in enumerate(ms.slice_processes) if r in members]

        if corrupt_device is not None:
            # corruption perturbs checksums: the hierarchical sums name the
            # slice; the pair walk corroborates, naming the slice when >= 3
            # slices can triangulate, or at least flagging every pair that
            # touches it when 2 slices leave one pair
            expected = slices_of(corrupt_device)
            localized = ms.suspect_slices == expected
            if slices >= 3:
                localized = localized and ms.dcn_suspect_slices == expected
            else:
                touching = {s["name"] for s in ms.suspect_pairs if s["reason"] == "corrupt"}
                expected_pairs = {f"slice{min(i, s)}-slice{max(i, s)}"
                                  for s in expected for i in range(slices) if i != s}
                localized = localized and touching == expected_pairs
            result["multislice"]["localized_correctly"] = localized
            ok = ok and localized
        if slow_device is not None and slices >= 3:
            # a slow rank passes every checksum: only the pair walk can turn
            # it into a slice verdict, and triangulation needs >= 3 slices
            localized = ms.dcn_suspect_slices == slices_of(slow_device)
            result["multislice"]["slow_localized_correctly"] = localized
            ok = ok and localized
    result["ok"] = bool(ok)
    return result


def _report(result: Dict[str, Any]) -> int:
    ok = result.pop("ok")
    print(json.dumps(result, indent=2))
    verdict = "PASS — fault detected and localized" if ok else "FAIL — fault missed or mislocalized"
    print(f"\nchaos drill: {verdict}")
    return 0 if ok else 1


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--slow-device", type=int, default=None, help="rank to make slow")
    parser.add_argument("--corrupt-device", type=int, default=None, help="rank to corrupt")
    parser.add_argument("--slow-iters", type=int, default=200, help="injected delay (chained matmuls)")
    parser.add_argument("--slices", type=int, default=0, help="also run the multislice probe with N slices")
    parser.add_argument("--cpu-ranks", type=int, default=0, metavar="N",
                        help="run on N gloo ranks in CPU processes instead of the card")
    args = parser.parse_args(argv)
    if args.slow_device is None and args.corrupt_device is None:
        print("no fault requested; pass --slow-device and/or --corrupt-device", file=sys.stderr)
        return 2
    kwargs = dict(slow_device=args.slow_device, corrupt_device=args.corrupt_device, slow_iters=args.slow_iters,
                  slices=args.slices)
    if args.cpu_ranks:
        from k8s_watcher_tpu_torch.parallel.cpu_ranks import run_cpu_ranks

        nodes = args.slices if args.slices > 1 else 1
        if args.cpu_ranks % nodes:
            print(f"--cpu-ranks {args.cpu_ranks} does not split into {nodes} slices", file=sys.stderr)
            return 2
        results = run_cpu_ranks("k8s_watcher_tpu_torch.chaos_probe:drill", args.cpu_ranks, dict(kwargs, device="cpu"),
                                local_world_size=args.cpu_ranks // nodes)
        return _report(results[0])

    import torch.distributed as dist

    from k8s_watcher_tpu_torch.parallel.mesh import initialize_process_group
    from k8s_watcher_tpu_torch.probe.device import process_count, process_index, resolve_device

    initialize_process_group(resolve_device(None))
    result = drill(process_index(), process_count(), device="cuda", **kwargs)
    if process_count() > 1:
        dist.barrier()
    dist.destroy_process_group()
    if process_index() == 0:
        return _report(result)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
