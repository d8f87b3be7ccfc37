"""The port's per-link walk held against the JAX package's, on the CPU.

The JAX side walks the suite's virtual 8-device ``(2, 4)`` mesh in one
process. The port runs 8 gloo ranks (tests/test_torch_ranks.py), 4 to a
node, so each rank walks only the links that touch it and the verdict comes
from the merged records. All scenarios of the grid run in one group.
"""

import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh

from k8s_watcher_tpu.faults.ici import IciFaultSpec as RefFaultSpec
from k8s_watcher_tpu.probe import links as ref_links
from k8s_watcher_tpu.probe.report import ProbeReport as RefReport
from k8s_watcher_tpu_torch.parallel import collectives
from k8s_watcher_tpu_torch.parallel.mesh import Mesh, rank_grid
from k8s_watcher_tpu_torch.probe import links
from k8s_watcher_tpu_torch.probe.report import ProbeReport
from test_torch_ranks import run_ranks

# Healthy gloo hops on a loaded CPU run from ~0.1 ms to a few ms. Scenarios
# that assert coverage and checksums get a floor far above any of them (as
# tests/test_multislice.py does); the slow scenario gets one well above
# them, under the slow fault: 2000 bf16 128x128 matmuls on one CPU thread
# add ~150 ms to each call of rank 3, ~37 ms per hop at inner_iters=4. The
# JAX side keeps its own calibration (tests/test_links.py).
COVERAGE_FLOOR_MS = 250.0
SLOW_FLOOR_MS = 10.0
SLOW_ITERS = 2000
REF_FLOOR_MS = 1.0
WALK = dict(iters=3, inner_iters=4)
PREP_FAILURE_LINK = "host0/chip1-chip2"

_WORKER = """
from k8s_watcher_tpu_torch.faults.ici import IciFaultSpec
from k8s_watcher_tpu_torch.parallel import collectives as c
from k8s_watcher_tpu_torch.parallel.mesh import host_chip_mesh
from k8s_watcher_tpu_torch.probe import links
cpu = torch.device("cpu")
mesh = host_chip_mesh(cpu)
walk = dict(iters=3, inner_iters=4, rtt_floor_ms=%(coverage)r)
out = {"grid": mesh.ranks.tolist()}
for pair, key in (((0, 1), "pair"), ((2, 7), "pair_far")):
    if rank in pair:
        fn, expected = c.make_pair_probe(*pair, inner_iters=4)
        bad, _ = c.make_pair_probe(*pair, inner_iters=4, fault=IciFaultSpec(corrupt_rank=pair[1]))
        x = c.pair_probe_input(*pair, cpu)
        out[key] = {"expected": expected, "clean": fn(x).item(), "corrupt": bad(x).item()}
out["healthy"] = links.run_link_probe(mesh, **walk).to_dict()
out["slow"] = links.run_link_probe(
    mesh, fault=IciFaultSpec(slow_rank=3, slow_iters=%(slow_iters)r), **dict(walk, rtt_floor_ms=%(slow)r)).to_dict()
out["corrupt"] = links.run_link_probe(mesh, fault=IciFaultSpec(corrupt_rank=5), **walk).to_dict()
if rank == 2:
    links._PREP_FAILURE_HOOK = lambda name: name == %(prep)r
out["prep_failure"] = links.run_link_probe(mesh, **walk).to_dict()
links._PREP_FAILURE_HOOK = None
out["after"] = links.run_link_probe(mesh, **walk).to_dict()
with open(out_path, "w") as fh:
    json.dump(out, fh)
""" % {"coverage": COVERAGE_FLOOR_MS, "slow": SLOW_FLOOR_MS, "slow_iters": SLOW_ITERS, "prep": PREP_FAILURE_LINK}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_WORKER, 8, tmp_path_factory.mktemp("links"), local_world_size=4)


@pytest.fixture(scope="module")
def ref_mesh():
    return RefMesh(np.array(jax.devices()).reshape(2, 4), ("hosts", "chips"))


@pytest.fixture(scope="module")
def ref(ref_mesh):
    args = dict(WALK, rtt_floor_ms=REF_FLOOR_MS)
    return {
        "healthy": ref_links.run_link_probe(ref_mesh, **args),
        "slow": ref_links.run_link_probe(
            ref_mesh, fault=RefFaultSpec(slow_device_id=3, slow_matmul_size=128, slow_iters=800), **args),
        "corrupt": ref_links.run_link_probe(ref_mesh, fault=RefFaultSpec(corrupt_device_id=5), **args),
    }


def port_mesh():
    return Mesh(None, rank_grid(8, 4), torch.device("cpu"))


class TestEnumerateLinks:
    def test_2x4_grid_matches_reference(self, ref_mesh):
        got = links.enumerate_links(port_mesh())
        want = ref_links.enumerate_links(ref_mesh)
        assert len(got) == len(want) == 12
        assert [(axis, name) for axis, name, _, _ in got] == [(axis, name) for axis, name, _, _ in want]
        devices = jax.devices()
        for (_, _, a, b), (_, _, da, db) in zip(got, want):
            assert (devices[a].id, devices[b].id) == (da.id, db.id)

    @pytest.mark.parametrize("world, local", [(1, 1), (2, 2), (4, 2), (12, 4), (3, 3)])
    def test_shapes_match_reference(self, world, local):
        grid = rank_grid(world, local)
        # the reference reads only the mesh's device grid: ranks stand in for devices
        want = ref_links.enumerate_links(SimpleNamespace(devices=grid))
        got = links.enumerate_links(Mesh(None, grid, torch.device("cpu")))
        assert got == [(axis, name, int(a), int(b)) for axis, name, a, b in want]


def _link(pkg, name, rtt_ms, axis="chips", ids=(0, 1), correct=True, error=None):
    return pkg.LinkResult(axis=axis, name=name, device_ids=ids, rtt_ms=rtt_ms,
                          rtt_mean_ms=rtt_ms, correct=correct, error=error)


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return ref_links if request.param == "jax" else links


class TestClassifySensitivity:
    """tests/test_links.py::TestClassifySensitivity, run through both packages."""

    def _ring(self, pkg, slow_factor, n=8, base_ms=0.05):
        ring = [_link(pkg, f"l{i}", base_ms, ids=(i, (i + 1) % n)) for i in range(n - 1)]
        ring.append(_link(pkg, "slow", base_ms * slow_factor, ids=(n - 1, 0)))
        return ring

    def test_2x_slowed_link_below_default_floor(self, pkg):
        assert pkg.classify_links(self._ring(pkg, 2.0), 3.0, 0.001) == ([], [])

    def test_2x_slowed_link_flagged_at_tightened_factor(self, pkg):
        suspects, _ = pkg.classify_links(self._ring(pkg, 2.0), 1.8, 0.001)
        assert [s["name"] for s in suspects] == ["slow"] and suspects[0]["reason"] == "slow"

    def test_just_above_default_factor_flagged(self, pkg):
        suspects, _ = pkg.classify_links(self._ring(pkg, 3.1), 3.0, 0.001)
        assert [s["name"] for s in suspects] == ["slow"]

    def test_just_below_default_factor_not_flagged(self, pkg):
        assert pkg.classify_links(self._ring(pkg, 2.9), 3.0, 0.001)[0] == []

    def test_absolute_floor_suppresses_microsecond_jitter(self, pkg):
        assert pkg.classify_links(self._ring(pkg, 10.0, base_ms=0.001), 3.0, 0.05)[0] == []

    def test_corruption_has_no_floor(self, pkg):
        ring = self._ring(pkg, 1.0)
        ring[3] = _link(pkg, "l3", 0.05, ids=(3, 4), correct=False)
        suspects, _ = pkg.classify_links(ring, 3.0, 5.0)
        assert [s["name"] for s in suspects] == ["l3"] and suspects[0]["reason"] == "corrupt"

    def test_per_axis_thresholds_are_independent(self, pkg):
        mixed = [_link(pkg, f"c{i}", 0.05, ids=(i, i + 1)) for i in range(4)]
        mixed += [_link(pkg, f"h{i}", 1.0, axis="hosts", ids=(i, i + 4)) for i in range(4)]
        mixed.append(_link(pkg, "c-bad", 0.25, ids=(6, 7)))
        suspects, _ = pkg.classify_links(mixed, 3.0, 0.001)
        assert [s["name"] for s in suspects] == ["c-bad"]

    def test_device_triangulation_needs_two_links(self, pkg):
        ring = self._ring(pkg, 1.0)
        ring[0] = _link(pkg, "l0", 1.0, ids=(0, 1))
        suspects, devices = pkg.classify_links(ring, 3.0, 0.001)
        assert [s["name"] for s in suspects] == ["l0"] and devices == []

    def test_min_baseline_and_errors(self, pkg):
        pairs = [_link(pkg, f"p{i}", 1.0 + (i in (0, 3, 4)) * 9.0, axis="dcn", ids=ids)
                 for i, ids in enumerate([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)])]
        pairs.append(_link(pkg, "e", -1.0, axis="dcn", ids=(2, 3), correct=False, error="boom"))
        got = pkg.classify_links(pairs, 3.0, 0.2, baseline_stat="min")
        want = ref_links.classify_links(
            [ref_links.LinkResult(**vars(p)) for p in pairs], 3.0, 0.2, baseline_stat="min")
        assert got == want
        with pytest.raises(ValueError):
            pkg.classify_links(pairs, 3.0, 0.2, baseline_stat="mean")


class TestPairProbe:
    def test_round_trip_to_three(self, ranks):
        for key, pair in (("pair", (0, 1)), ("pair_far", (2, 7))):
            for r in pair:
                got = ranks[r][key]
                assert got["expected"] == 3.0 and got["clean"] == 3.0

    def test_corrupt_member_breaks_checksum(self, ranks):
        for key, pair in (("pair", (0, 1)), ("pair_far", (2, 7))):
            for r in pair:
                assert abs(ranks[r][key]["corrupt"] - 3.0) > 1.0

    @pytest.mark.parametrize("inner_iters", [3, 1, 0])
    def test_odd_or_short_chain_rejected(self, inner_iters):
        with pytest.raises(ValueError):
            collectives.make_pair_probe(0, 1, inner_iters=inner_iters)
        with pytest.raises(ValueError):
            ref_links.make_pair_probe(*jax.devices()[:2], inner_iters=inner_iters)


def _union_owned(ranks, scenario):
    return sorted(link["name"] for r in ranks for link in r[scenario]["links"])


class TestLinkWalk:
    def test_grid_is_two_nodes_of_four(self, ranks):
        assert all(r["grid"] == [[0, 1, 2, 3], [4, 5, 6, 7]] for r in ranks)

    def test_healthy_union_of_owned_links_is_the_reference_walk(self, ranks, ref):
        want = ref["healthy"]
        assert want.ok and want.n_links == 12
        assert _union_owned(ranks, "healthy") == sorted(r.name for r in want.links)
        for rank, r in enumerate(ranks):
            got = r["healthy"]
            assert got["ok"] and got["error"] is None
            assert got["suspect_links"] == [] and got["suspect_devices"] == []
            assert got["n_observed"] == 3  # every rank of a 2x4 grid ends 3 links
            assert all(min(link["device_ids"]) == rank for link in got["links"])
            assert got["median_rtt_ms"] > 0
        assert sum(r["healthy"]["n_links"] for r in ranks) == 12
        # the merged median is one number on every rank
        assert len({r["healthy"]["median_rtt_ms"] for r in ranks}) == 1

    def test_slow_rank_named_on_every_rank(self, ranks, ref):
        want = ref["slow"]
        assert want.suspect_devices == [3]
        want_names = sorted(s["name"] for s in want.suspect_links)
        for r in ranks:
            got = r["slow"]
            assert not got["ok"]
            assert got["suspect_devices"] == want.suspect_devices
            assert sorted(s["name"] for s in got["suspect_links"]) == want_names
            assert all(s["reason"] == "slow" for s in got["suspect_links"])

    def test_corrupt_rank_named_on_every_rank(self, ranks, ref):
        want = ref["corrupt"]
        assert want.suspect_devices == [5]
        for r in ranks:
            got = r["corrupt"]
            assert not got["ok"] and got["suspect_devices"] == [5]
            assert sorted(s["name"] for s in got["suspect_links"]) == sorted(s["name"] for s in want.suspect_links)
            assert all(s["reason"] == "corrupt" for s in got["suspect_links"])

    def test_prep_failure_on_one_rank_skips_every_link(self, ranks):
        # every link joins two ranks, so one failed preparation (rank 2's,
        # for a link rank 1 owns) stops the whole walk on every rank instead
        # of leaving a peer blocked in an exchange
        for r in ranks:
            got = r["prep_failure"]
            assert not got["ok"] and got["error"] is None and got["n_observed"] == 3
            assert len(got["suspect_links"]) == 12
            assert all(s["reason"] == "error" for s in got["suspect_links"])
            assert all(link["error"].startswith("skipped") for link in got["links"])
        assert _union_owned(ranks, "prep_failure") == _union_owned(ranks, "healthy")

    def test_walk_recovers_after_a_failed_cycle(self, ranks):
        assert all(r["after"]["ok"] and r["after"]["suspect_links"] == [] for r in ranks)

    def test_serializable_and_same_keys_as_reference(self, ranks, ref):
        json.dumps(ranks[0]["healthy"])
        assert set(ranks[0]["healthy"]) == set(ref["healthy"].to_dict())
        assert set(ranks[0]["healthy"]["links"][0]) == set(ref["healthy"].to_dict()["links"][0])


class TestReport:
    DEVICES_OK = {"platform_mismatch": 0, "missing_local_devices": 0, "healthy_devices": 8, "visible_devices": 8}

    @pytest.mark.parametrize("scenario, healthy", [("healthy", True), ("corrupt", False)])
    def test_links_decide_health_as_in_reference(self, ranks, ref, scenario, healthy):
        got = links.LinkProbeResult(**{
            **ranks[0][scenario], "links": [links.LinkResult(**link) for link in ranks[0][scenario]["links"]]})
        port = ProbeReport(environment="test", devices=self.DEVICES_OK, links=got)
        want = RefReport(environment="test", devices=self.DEVICES_OK, links=ref[scenario])
        assert port.healthy is want.healthy is healthy
        assert port.to_payload()["links"]["suspect_devices"] == want.to_payload()["links"]["suspect_devices"]

    def test_one_rank_walk_is_empty_and_ok(self):
        got = links.run_link_probe(device="cpu")
        assert got.ok and got.n_links == 0 and got.n_observed == 0 and got.error is None
