"""The port's multislice probe held against the JAX package's, on the CPU.

The JAX side uses the suite's virtual 8-device mesh carved by
``hybrid_slice_mesh(n_slices=2)`` and ``(n_slices=4)``. The port runs 8 gloo
ranks (tests/test_torch_ranks.py): 4 ranks to a node for the 2-slice grid, 2 to a
node for the 4-slice grid (a slice is a whole number of nodes), all
scenarios in one group (pattern: tests/test_multislice.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from k8s_watcher_tpu.faults.ici import IciFaultSpec as RefFaultSpec
from k8s_watcher_tpu.parallel import collectives as ref_coll
from k8s_watcher_tpu.parallel.mesh import hybrid_slice_mesh as ref_hybrid_slice_mesh
from k8s_watcher_tpu.probe.multislice import run_multislice_probe as ref_run_multislice_probe
from k8s_watcher_tpu_torch.parallel import collectives
from k8s_watcher_tpu_torch.parallel.mesh import Mesh, slice_grid
from k8s_watcher_tpu_torch.probe.multislice import run_multislice_probe
from test_torch_ranks import run_ranks

# Pair RTTs on a loaded CPU vary several-fold between healthy pairs, so the
# walk's latency verdicts get floors far above them: 250 ms where a test
# asserts coverage and checksums only (as tests/test_multislice.py does), 10
# ms where a slow slice must stand out. The slow fault (2000 bf16 128x128
# matmuls on one CPU thread) adds ~150 ms to each call of its rank, ~37 ms
# per hop at inner_iters=4.
COVERAGE_FLOOR_MS = 250.0
SLOW_FLOOR_MS = 10.0
SLOW_ITERS = 2000
# The JAX mesh's slow device gets a fault of the same size (5000 matmuls on
# its device thread: ~37 ms a hop) and the same floor: at the walk's default
# 0.2 ms floor the verdict sits inside the healthy pairs' 0.1-0.3 ms spread,
# and a loaded host flagged a healthy pair (slice0-slice3) beside slice 1's.
REF_SLOW_ITERS = 5000

_WORKER = """
new_group = dist.new_group
made = []
def counting_new_group(*args, **kwargs):
    made.append(1)
    return new_group(*args, **kwargs)
dist.new_group = counting_new_group
from k8s_watcher_tpu_torch.faults.ici import IciFaultSpec
from k8s_watcher_tpu_torch.parallel import collectives as c
from k8s_watcher_tpu_torch.parallel.mesh import SLICE_AXES, hybrid_slice_mesh
from k8s_watcher_tpu_torch.probe.multislice import run_multislice_probe
cpu = torch.device("cpu")
coverage, slow_floor, slow_iters = %(coverage)r, %(slow)r, %(slow_iters)r
out = {}

mesh = hybrid_slice_mesh(cpu, 2)
per_slice, total = c.make_hierarchical_probe(mesh)(torch.ones(1))
x = c.psum_probe_input(mesh)
out["two"] = {
    "grid": mesh.ranks.tolist(),
    "hier": [per_slice.tolist(), total.item()],
    "ici_mean": c.make_subaxis_psum_probe(mesh, ("hosts", "gpus"), 4)(x).item(),
    "all_mean": c.make_subaxis_psum_probe(mesh, SLICE_AXES, 4)(x).item(),
    "healthy": run_multislice_probe(mesh, iters=3, inner_iters=4, pair_rtt_floor_ms=coverage).to_dict(),
    "corrupt6": run_multislice_probe(mesh, iters=2, inner_iters=4, pair_rtt_floor_ms=coverage,
                                     fault=IciFaultSpec(corrupt_rank=6)).to_dict(),
    "corrupt1": run_multislice_probe(mesh, iters=2, inner_iters=4, pair_rtt_floor_ms=coverage,
                                     fault=IciFaultSpec(corrupt_rank=1)).to_dict(),
    "slow0": run_multislice_probe(mesh, iters=3, inner_iters=4,
                                  fault=IciFaultSpec(slow_rank=0, slow_iters=slow_iters)).to_dict(),
    "no_pairs": run_multislice_probe(mesh, iters=2, inner_iters=4, pair_rtt_floor_ms=coverage,
                                     pair_localization=False).to_dict(),
    "new_groups": len(made),
}

os.environ["LOCAL_WORLD_SIZE"] = "2"
made.clear()
mesh = hybrid_slice_mesh(cpu, 4)
out["four"] = {
    "grid": mesh.ranks.tolist(),
    "healthy": run_multislice_probe(mesh, iters=3, inner_iters=4, pair_rtt_floor_ms=coverage).to_dict(),
    "slow3": run_multislice_probe(mesh, iters=3, inner_iters=4, pair_rtt_floor_ms=slow_floor,
                                  fault=IciFaultSpec(slow_rank=3, slow_iters=slow_iters)).to_dict(),
    "corrupt5": run_multislice_probe(mesh, iters=2, inner_iters=4, pair_rtt_floor_ms=coverage,
                                     fault=IciFaultSpec(corrupt_rank=5)).to_dict(),
    "new_groups": len(made),
}

made.clear()
mesh = hybrid_slice_mesh(cpu, 1)
out["one"] = {
    "grid_shape": list(mesh.ranks.shape),
    "probe": run_multislice_probe(mesh, iters=2, inner_iters=2).to_dict(),
    "new_groups": len(made),
}
try:
    hybrid_slice_mesh(cpu, 3)
    out["three"] = "built"
except ValueError as exc:
    out["three"] = str(exc)
with open(out_path, "w") as fh:
    json.dump(out, fh)
""" % {"coverage": COVERAGE_FLOOR_MS, "slow": SLOW_FLOOR_MS, "slow_iters": SLOW_ITERS}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_WORKER, 8, tmp_path_factory.mktemp("multislice"), local_world_size=4)


@pytest.fixture(scope="module")
def ref_two():
    return ref_hybrid_slice_mesh(n_slices=2)


@pytest.fixture(scope="module")
def ref_four():
    return ref_hybrid_slice_mesh(n_slices=4)


class TestSliceGrid:
    def test_grids_match_reference_shapes(self, ranks, ref_two, ref_four):
        for r in ranks:
            assert r["two"]["grid"] == [[[0, 1, 2, 3]], [[4, 5, 6, 7]]]
            assert r["four"]["grid"] == [[[0, 1]], [[2, 3]], [[4, 5]], [[6, 7]]]
        assert ref_two.devices.shape == (2, 1, 4) and ref_four.devices.shape == (4, 1, 2)
        for grid, mesh in ((np.array(ranks[0]["two"]["grid"]), ref_two), (np.array(ranks[0]["four"]["grid"]), ref_four)):
            assert [[d.id for d in s.ravel()] for s in mesh.devices] == [list(s.ravel()) for s in grid]

    def test_slices_must_split_the_nodes(self, ranks):
        assert all("do not split into 3 slices" in r["three"] for r in ranks)
        with pytest.raises(ValueError):
            ref_hybrid_slice_mesh(n_slices=3)

    @pytest.mark.parametrize("world, local, n_slices, shape", [
        (8, 4, None, (2, 1, 4)), (8, 2, 2, (2, 2, 2)), (16, 8, 1, (1, 2, 8)), (1, 1, None, (1, 1, 1)),
    ])
    def test_slice_grid(self, world, local, n_slices, shape):
        grid = slice_grid(world, local, n_slices)
        assert grid.shape == shape and grid.ravel().tolist() == list(range(world))

    @pytest.mark.parametrize("world, local, n_slices", [(8, 3, None), (8, 4, 3), (8, 0, None)])
    def test_ragged_grids_raise(self, world, local, n_slices):
        with pytest.raises(ValueError):
            slice_grid(world, local, n_slices)

    def test_communicators_made_once_per_grid(self, ranks):
        # S slices of H*G ranks: one group per slice, one per (host, gpu)
        # position; the pair walk and the link walk add none
        for r in ranks:
            assert r["two"]["new_groups"] == 2 + 4
            assert r["four"]["new_groups"] == 4 + 2
            assert r["one"]["new_groups"] == 0


class TestHierarchicalAndSubaxis:
    def test_sums_match_reference(self, ranks, ref_two):
        hier = ref_coll.make_hierarchical_probe(ref_two)
        ones = jax.device_put(jnp.ones((8,), dtype=jnp.float32), NamedSharding(ref_two, P(("slices", "hosts", "chips"))))
        want_slices, want_total = jax.block_until_ready(hier(ones))
        for r in ranks:
            assert r["two"]["hier"] == [np.asarray(want_slices).tolist(), float(np.asarray(want_total).ravel()[0])]
        assert ranks[0]["two"]["hier"] == [[4.0, 4.0], 8.0]

    def test_subaxis_means_match_reference(self, ranks, ref_two):
        x = ref_coll.psum_probe_input(ref_two)
        ici = np.asarray(ref_coll.make_subaxis_psum_probe(ref_two, ("hosts", "chips"), inner_iters=4)(x))
        full = np.asarray(ref_coll.make_subaxis_psum_probe(ref_two, ("slices", "hosts", "chips"), inner_iters=4)(x))
        assert ici.tolist() == [2.5, 6.5]
        for rank, r in enumerate(ranks):
            assert r["two"]["ici_mean"] == ici[rank // 4]
            assert r["two"]["all_mean"] == float(full.ravel()[0]) == 4.5

    def test_hierarchical_wants_a_slices_axis(self):
        with pytest.raises(ValueError):
            collectives.make_hierarchical_probe(Mesh(None, np.arange(8).reshape(2, 4), torch.device("cpu")))
        with pytest.raises(ValueError):
            collectives.make_slice_pair_probe(Mesh(None, np.arange(8).reshape(2, 4), torch.device("cpu")), 0, 1)


class TestTwoSlices:
    def test_healthy_matches_reference(self, ranks, ref_two):
        want = ref_run_multislice_probe(ref_two, iters=3, inner_iters=4, pair_rtt_floor_ms=COVERAGE_FLOOR_MS)
        for r in ranks:
            got = r["two"]["healthy"]
            assert got["ok"] and got["error"] is None
            for key in ("n_slices", "devices_per_slice", "per_slice_sums", "suspect_slices"):
                assert got[key] == getattr(want, key), key
            assert got["ici_rtt_ms"] > 0 and got["total_rtt_ms"] > 0 and got["dcn_overhead_ms"] >= 0
            assert set(got) == set(want.to_dict())
        # slice -> member ranks (the JAX package's one process holds every device)
        assert ranks[0]["two"]["healthy"]["slice_processes"] == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert want.slice_processes == [[0], [0]]
        # every member records the pair it joined; the lowest member owns it
        assert [[p["owner"] for p in r["two"]["healthy"]["pair_rtts"]] for r in ranks] == [[True]] + [[False]] * 7

    @pytest.mark.parametrize("bad, slice_index", [(6, 1), (1, 0)])
    def test_corrupt_rank_localized_to_its_slice(self, ranks, ref_two, bad, slice_index):
        want = ref_run_multislice_probe(ref_two, iters=2, inner_iters=4, fault=RefFaultSpec(corrupt_device_id=bad))
        assert want.suspect_slices == [slice_index]
        for r in ranks:
            got = r["two"][f"corrupt{bad}"]
            assert not got["ok"] and got["suspect_slices"] == [slice_index]
            assert got["per_slice_sums"] == want.per_slice_sums

    def test_single_pair_has_no_relative_verdict(self, ranks):
        # one pair is a population of one: only the floor applies, so a slow
        # two-slice route is the trend tracker's to catch, not one walk's
        owned = [p for r in ranks for p in r["two"]["slow0"]["pair_rtts"] if p["owner"]]
        assert len(owned) == 1 and owned[0]["rtt_ms"] > 0
        assert all(r["two"]["slow0"]["suspect_pairs"] == [] for r in ranks)
        assert all(r["two"]["slow0"]["dcn_suspect_slices"] == [] for r in ranks)

    def test_pair_walk_disabled(self, ranks):
        for r in ranks:
            got = r["two"]["no_pairs"]
            assert got["ok"] and got["pair_rtts"] == [] and got["dcn_suspect_slices"] == []


class TestFourSlicePairWalk:
    PAIRS = ["slice0-slice1", "slice0-slice2", "slice0-slice3", "slice1-slice2", "slice1-slice3", "slice2-slice3"]

    def test_healthy_walks_every_pair_once(self, ranks, ref_four):
        want = ref_run_multislice_probe(ref_four, iters=3, inner_iters=4, pair_rtt_floor_ms=COVERAGE_FLOOR_MS)
        assert [p["name"] for p in want.pair_rtts] == self.PAIRS
        owned = [p for r in ranks for p in r["four"]["healthy"]["pair_rtts"] if p["owner"]]
        assert sorted(p["name"] for p in owned) == self.PAIRS
        assert all(p["correct"] and p["rtt_ms"] > 0 for p in owned)
        for r in ranks:
            got = r["four"]["healthy"]
            assert got["ok"] and not got["suspect_pairs"] and not got["dcn_suspect_slices"]
            assert got["n_slices"] == want.n_slices == 4 and got["per_slice_sums"] == want.per_slice_sums

    def test_slow_rank_implicates_its_slice_on_every_rank(self, ranks, ref_four):
        # rank 3 lives in slice 1 of the 4-slice grid, as device 3 does in
        # the JAX mesh: every pair touching slice 1 stretches
        want = ref_run_multislice_probe(
            ref_four, iters=3, inner_iters=4, pair_rtt_floor_ms=SLOW_FLOOR_MS,
            fault=RefFaultSpec(slow_device_id=3, slow_iters=REF_SLOW_ITERS))
        assert want.dcn_suspect_slices == [1]
        want_names = {s["name"] for s in want.suspect_pairs}
        assert want_names == {"slice0-slice1", "slice1-slice2", "slice1-slice3"}
        for r in ranks:
            got = r["four"]["slow3"]
            assert not got["ok"] and not got["suspect_slices"]  # checksums all pass
            assert got["dcn_suspect_slices"] == want.dcn_suspect_slices
            assert {s["name"] for s in got["suspect_pairs"]} == want_names

    def test_corrupt_rank_fails_its_pairs_checksums(self, ranks, ref_four):
        # the coverage floor on both sides, as the port's walk has it: at the
        # default 0.2 ms a healthy pair that host load stretches is flagged
        # "slow" beside the corrupt ones
        want = ref_run_multislice_probe(ref_four, iters=2, inner_iters=4, pair_rtt_floor_ms=COVERAGE_FLOOR_MS,
                                        fault=RefFaultSpec(corrupt_device_id=5))
        assert want.suspect_slices == want.dcn_suspect_slices == [2]
        for r in ranks:
            got = r["four"]["corrupt5"]
            assert got["suspect_slices"] == [2] and got["dcn_suspect_slices"] == [2]
            assert all(s["reason"] == "corrupt" for s in got["suspect_pairs"])
            assert {s["name"] for s in got["suspect_pairs"]} == {s["name"] for s in want.suspect_pairs}


class TestSingleSlice:
    def test_spawned_single_slice_has_no_pairs(self, ranks):
        for r in ranks:
            got = r["one"]["probe"]
            assert r["one"]["grid_shape"] == [1, 4, 2]
            assert got["ok"] and got["n_slices"] == 1 and got["pair_rtts"] == []
            assert got["per_slice_sums"] == [8.0]

    def test_one_rank_matches_reference_single_slice(self):
        want = ref_run_multislice_probe(iters=2, inner_iters=2)
        got = run_multislice_probe(iters=2, inner_iters=2, device="cpu")
        assert want.ok and got.ok and got.error is None
        assert got.n_slices == want.n_slices == 1 and got.pair_rtts == want.pair_rtts == []
        assert set(got.to_dict()) == set(want.to_dict())
        json.dumps(got.to_dict())
