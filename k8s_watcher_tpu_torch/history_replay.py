"""Offline, deterministic replay of a captured history WAL (the JAX package's
``scripts/history_replay.py``).

Feeds the WAL in ``--wal DIR`` back through a fresh FleetView (the real
delta-apply machinery) and prints the terminal snapshot's digest — the
sha256 of its canonical bytes. Run it twice on the same capture and the
digests MUST match; ``--verify`` does both passes in one invocation.
``--at RV`` stops the replay at a historical rv (the offline twin of
``GET /serve/fleet?at=``) and ``--out FILE`` writes the canonical snapshot
for diffing two captures or pinning a regression fixture.

``--analytics`` appends a terminal slice/quorum/capacity report computed by
the analytics kernels (the same columnar path behind ``/serve/analytics``)
from the replayed state; ``--scenarios`` adds what-if rows to it (JSON
array, the /serve/analytics vocabulary — ``baseline`` / ``drain_cluster`` /
``cordon_nodes``). The kernels run on the GPU (the torch backend's segment
sums) and raise without CUDA; ``--device cpu`` runs them on the CPU. They
never fall back to numpy.

    python -m k8s_watcher_tpu_torch.history_replay --wal /var/lib/k8s-watcher-tpu/history
    python -m k8s_watcher_tpu_torch.history_replay --wal ./capture --at 48211 --out snap.json
    python -m k8s_watcher_tpu_torch.history_replay --wal ./capture --verify
    python -m k8s_watcher_tpu_torch.history_replay --wal ./capture --analytics \\
        --scenarios '[{"kind": "drain_cluster", "cluster": "us-east1-gpu"}]'

Exit code 2 for a missing directory, ``--scenarios`` without
``--analytics`` or bad scenarios; 1 for rv mismatches, a nondeterministic
replay or a failed analytics cross-check.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from k8s_watcher_tpu_torch.history.replay import canonical_snapshot, replay_digest, replay_wal

MAX_SCENARIOS = 64


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--wal", required=True, help="WAL directory (wal-*.seg segments)")
    parser.add_argument("--at", type=int, default=None, help="stop the replay at this rv (time travel)")
    parser.add_argument("--out", default=None, help="write the canonical terminal snapshot here")
    parser.add_argument("--verify", action="store_true",
                        help="replay twice and fail unless the terminal snapshots are byte-identical")
    parser.add_argument("--analytics", action="store_true",
                        help="append a terminal slice/quorum/capacity report (analytics kernels)")
    parser.add_argument("--scenarios", default=None,
                        help="JSON array of what-if scenarios for --analytics (the /serve/analytics vocabulary)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="where --analytics runs its kernels (default: this rank's GPU; raises without CUDA)")
    args = parser.parse_args(argv)
    if args.scenarios is not None and not args.analytics:
        print("ERROR: --scenarios requires --analytics", file=sys.stderr)
        return 2
    wal_dir = Path(args.wal)
    if not wal_dir.is_dir():
        print(f"ERROR: {wal_dir} is not a directory", file=sys.stderr)
        return 2
    kernels = None
    if args.analytics:
        # the backend first: a run asked for on a missing GPU fails before
        # any replay, and never degrades to numpy
        from k8s_watcher_tpu_torch.analytics import FleetKernels, resolve_backend

        kernels = FleetKernels(resolve_backend("auto", device=args.device))

    digest = replay_digest(wal_dir, at=args.at)
    if digest["rv_mismatches"]:
        print(
            f"ERROR: {digest['rv_mismatches']} rv mismatch(es) — the WAL and the "
            "view disagree about the delta algebra (corrupt capture or a real bug)",
            file=sys.stderr,
        )
        print(json.dumps(digest, indent=2))
        return 1
    if args.verify:
        second = replay_digest(wal_dir, at=args.at)
        if second != digest:
            print("ERROR: replay is nondeterministic:", file=sys.stderr)
            print(json.dumps({"first": digest, "second": second}, indent=2))
            return 1
        digest["verified_deterministic"] = True
    # --out and --analytics both need the terminal objects: ONE shared
    # replay (a multi-GB capture's replay is the dominant cost here)
    terminal = None
    if args.out or args.analytics:
        terminal = replay_wal(wal_dir, at=args.at)
    if args.out:
        Path(args.out).write_bytes(canonical_snapshot(terminal.rv, terminal.objects) + b"\n")
        digest["out"] = args.out
    if args.analytics:
        from k8s_watcher_tpu_torch.analytics import Scenario, ScenarioError, parse_scenarios, verdicts_from_objects

        scenarios = [Scenario("baseline")]
        if args.scenarios:
            try:
                scenarios = parse_scenarios(json.loads(args.scenarios), max_scenarios=MAX_SCENARIOS)
            except (ValueError, ScenarioError) as exc:
                print(f"ERROR: bad --scenarios: {exc}", file=sys.stderr)
                return 2
        report = verdicts_from_objects(terminal.objects, scenarios, kernels=kernels)
        digest["analytics"] = report
        if not report["crosscheck"]["ok"]:
            print(
                "ERROR: analytics cross-check failed — the vectorized slice "
                "aggregates diverge from the capture's incremental counters "
                f"on {report['crosscheck']['mismatched'][:8]}",
                file=sys.stderr,
            )
            print(json.dumps(digest, indent=2))
            return 1
    print(json.dumps(digest, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
