"""The port's HBM kernels and probes held against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages (through
``k8s_watcher_tpu_torch.carry`` on the port's side). The JAX side runs its
Pallas kernels in interpret mode, as its own CPU tests do; the port's
wrappers run their plain versions because the tensors lie on the CPU. All
the data are integer-valued floats whose every partial sum stays below 2^24,
so both sides are exact and compared exactly. The CUDA kernels themselves are
held against the plain versions on a GPU in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_watcher_tpu.probe import hbm as ref
from k8s_watcher_tpu_torch import carry
from k8s_watcher_tpu_torch.kernels import build
from k8s_watcher_tpu_torch.kernels import hbm as K
from k8s_watcher_tpu_torch.probe import hbm as port

CPU = torch.device("cpu")


def test_geometry_matches_reference():
    assert (K.BLOCK_ROWS, K.WIDTH, K.BYTES_PER_BLOCK) == (ref.BLOCK_ROWS, ref.WIDTH, ref.BYTES_PER_BLOCK)
    assert (K.WRITE_BLOCK_ROWS, K.WRITE_WIDTH, K.WRITE_BYTES_PER_BLOCK) == (
        ref.WRITE_BLOCK_ROWS, ref.WRITE_WIDTH, ref.WRITE_BYTES_PER_BLOCK)
    for total in (1 << 20, 256 << 20, 3 << 30):
        assert port._pick_repeats(total) == ref._pick_repeats(total)


@pytest.mark.parametrize("num_blocks", [1, 2])
@pytest.mark.parametrize("repeats", [1, 3])
def test_read_sweep_matches_pallas(num_blocks, repeats):
    rng = np.random.default_rng(10 * num_blocks + repeats)
    x = rng.integers(0, 4, size=(num_blocks * ref.BLOCK_ROWS, ref.WIDTH)).astype(np.float32)
    probe, rows, _ = ref.make_hbm_read_probe(
        num_blocks * ref.BYTES_PER_BLOCK, repeats=repeats, interpret=True)
    assert rows == x.shape[0]
    want = np.asarray(probe(jnp.asarray(x)))
    got = carry.from_port(K.read_sweep(carry.to_port(x, CPU), repeats))
    assert got.shape == want.shape == (1, ref.WIDTH)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_blocks", [1, 2])
@pytest.mark.parametrize("seed", [0.0, 3.0, 0.375])
def test_fill_bitwise_matches_pallas(num_blocks, seed):
    write, _, rows, _ = ref.make_hbm_write_probe(
        num_blocks * ref.WRITE_BYTES_PER_BLOCK, repeats=2, interpret=True)
    want = np.asarray(write(jnp.full((1, 1), seed, jnp.float32)))
    got = carry.from_port(K.fill(carry.seed(seed, CPU), num_blocks, 2))
    assert got.shape == want.shape == (rows, ref.WRITE_WIDTH)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("num_blocks", [1, 2])
def test_blocksums_match_pallas_on_corrupted_buffer(num_blocks):
    rng = np.random.default_rng(7 + num_blocks)
    _, blocksums, rows, _ = ref.make_hbm_write_probe(
        num_blocks * ref.WRITE_BYTES_PER_BLOCK, repeats=1, interpret=True)
    y = np.repeat(np.arange(1, num_blocks + 1, dtype=np.float32), ref.WRITE_BLOCK_ROWS)
    y = np.repeat(y[:, None], ref.WRITE_WIDTH, axis=1)
    # integer corruption in the last block only: an earlier block stays clean
    last = (num_blocks - 1) * ref.WRITE_BLOCK_ROWS
    for _ in range(5):
        r = int(rng.integers(last, rows))
        y[r, int(rng.integers(0, ref.WRITE_WIDTH))] += float(rng.integers(1, 1000))
    want = np.asarray(blocksums(jnp.asarray(y)))
    got = carry.from_port(K.blocksums(carry.to_port(y, CPU)))
    np.testing.assert_array_equal(got, want)
    expected = np.arange(1, num_blocks + 1) * ref.WRITE_BLOCK_ROWS * ref.WRITE_WIDTH
    assert np.nonzero(got[0] != expected)[0].tolist() == [num_blocks - 1]
    assert np.nonzero(want[0] != expected)[0].tolist() == [num_blocks - 1]


def _delta(rows, hit):
    delta = np.zeros((rows, ref.WRITE_WIDTH), dtype=np.float32)
    if hit:
        # tests/test_observability.py: one element inside block 1
        delta[ref.WRITE_BLOCK_ROWS + 7, 3] = 1e6
    return delta


@pytest.mark.parametrize("total_bytes", [1 << 22, 1 << 23])
@pytest.mark.parametrize("corrupt", [False, True])
def test_write_probe_verdicts_match(total_bytes, corrupt):
    # both packages cap the CPU buffer at two write blocks
    delta = _delta(2 * ref.WRITE_BLOCK_ROWS, corrupt)
    want = ref.run_hbm_write_probe(total_bytes, iters=1, corrupt_hook=lambda y: y + jnp.asarray(delta))
    got = port.run_hbm_write_probe(total_bytes, iters=1, device="cpu",
                                   corrupt_hook=carry.additive_hook(delta))
    assert "error" not in got and "error" not in want
    assert set(got) == set(want)
    for key in ("ok", "integrity_ok", "bad_block_count", "bad_blocks", "bytes", "repeats", "interpreted"):
        assert got[key] == want[key], key
    assert got["ok"] is (not corrupt)
    if corrupt:
        assert got["bad_blocks"][0]["block"] == 1
        assert got["bad_blocks"][0]["byte_offset"] == ref.WRITE_BYTES_PER_BLOCK


@pytest.mark.parametrize("total_bytes", [1 << 22, 1 << 23])
def test_read_probe_verdicts_match(total_bytes):
    want = ref.run_hbm_probe(total_bytes, iters=1)
    got = port.run_hbm_probe(total_bytes, iters=1, device="cpu")
    assert set(got) == set(want)
    for key in ("ok", "integrity_ok", "bytes", "repeats", "interpreted", "device_id"):
        assert got[key] == want[key], key
    assert got["ok"] and got["interpreted"] is True and got["read_gbps"] > 0


def test_probe_errors_are_unhealthy_readings():
    # a probe that cannot run reports ok=False with the error, as the reference does
    out = port.run_hbm_probe(1 << 22, iters=1, device="meta")
    assert out["ok"] is False and "unsupported probe device" in out["error"]


class TestWrappers:
    def test_cpu_tensors_take_the_plain_version_without_counting(self):
        before = build.launch_counts()
        x = torch.ones((K.BLOCK_ROWS, K.WIDTH))
        assert torch.equal(K.read_sweep(x, 2), K.read_sweep_plain(x, 2))
        s = carry.seed(1.0, CPU)
        y = K.fill(s, 1, 1)
        assert torch.equal(y, K.fill_plain(s, 1, 1))
        assert torch.equal(K.blocksums(y), K.blocksums_plain(y))
        assert build.launch_counts() == before  # plain versions launch nothing

    @pytest.mark.parametrize("bad", [
        lambda: K.read_sweep(torch.ones((4, K.WIDTH), dtype=torch.float64), 1),
        lambda: K.read_sweep(torch.ones((4, K.WIDTH + 1)), 1),
        lambda: K.read_sweep(torch.ones((K.WIDTH, 4)).t(), 1),
        lambda: K.read_sweep(torch.ones((4, K.WIDTH)), 0),
        lambda: K.fill(torch.ones((1, 2)), 1, 1),
        lambda: K.fill(torch.ones((1, 1)), 0, 1),
        lambda: K.blocksums(torch.ones((K.WRITE_BLOCK_ROWS + 1, K.WRITE_WIDTH))),
        lambda: K.read_sweep(torch.ones((4, K.WIDTH), device="meta"), 1),
    ])
    def test_wrappers_reject_what_the_kernels_do_not_take(self, bad):
        with pytest.raises(ValueError):
            bad()

    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setenv("PATH", str(tmp_path))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build._nvcc()

    def test_library_name_tracks_the_source(self):
        path = build.library_path()
        assert path.parent == build.BUILD_DIR and path.suffix == ".so"
        assert path == build.library_path()
