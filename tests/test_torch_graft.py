"""The port's graft entry (``k8s_watcher_tpu_torch/graft.py``,
``__graft_entry_gpu__.py``) held against the JAX package's ``__graft_entry__.py``.

``entry()``'s probe step and the JAX ``probe_step`` get the same bf16
inputs (numpy, made from a seed): both take exact bf16 products and sum them
in f32, so only the order of the sums differs. Tolerances: the products
within 1e-4 x max|out|, the checksums within 1e-5 x sum|out|; an ``inf``
input gives NaN in both. ``dryrun_multichip(n)`` runs n gloo ranks in CPU
processes; its mesh, checksum, link count and pair count equal the JAX
dryrun's, run in a subprocess on its virtual CPU mesh.
"""

import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ref_graft
from k8s_watcher_tpu_torch import graft

REPO = Path(__file__).resolve().parent.parent
LINE = re.compile(r"dryrun_multichip OK: mesh=\((\d+)x(\d+)\) devices=(\d+) platform=(\w+) "
                  r"checksum=(\S+) links=(\d+) dcn_pairs=(\d+)")


def _ref_probe_step():
    step, _ = ref_graft.entry()
    return step


def _inputs(seed, shape=graft.ENTRY_SHAPE):
    rng = np.random.default_rng(seed)
    return tuple(np.array(jnp.asarray(rng.standard_normal(shape, dtype=np.float32), dtype=jnp.bfloat16))
                 for _ in range(2))


def _torch(x):
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probe_step_matches_the_reference(seed):
    a, b = _inputs(seed)
    want = np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(b), preferred_element_type=jnp.float32))
    got = graft.gemm_f32(_torch(a), _torch(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    ref_sum = float(_ref_probe_step()(jnp.asarray(a), jnp.asarray(b)))
    port_sum = float(graft.probe_step(_torch(a), _torch(b)))
    assert abs(port_sum - ref_sum) <= 1e-5 * np.abs(want).sum()


def test_a_non_finite_input_gives_nan_in_both():
    a, b = _inputs(3)
    a[7, 11] = np.inf
    assert math.isnan(float(_ref_probe_step()(jnp.asarray(a), jnp.asarray(b))))
    assert math.isnan(float(graft.probe_step(_torch(a), _torch(b))))


def test_entry_gives_the_seeded_step_and_inputs():
    step, (a, b) = graft.entry(device="cpu")
    again = graft.entry(device="cpu")[1]
    assert step is graft.probe_step
    for x, y in zip((a, b), again):
        assert x.dtype == torch.bfloat16 and tuple(x.shape) == (256, 256) and x.device.type == "cpu"
        assert torch.equal(x, y)
    assert not torch.equal(a, b) and math.isfinite(float(step(a, b)))
    ref_step, (ref_a, ref_b) = ref_graft.entry()
    assert (ref_a.shape, ref_a.dtype) == ((256, 256), jnp.bfloat16)
    # the reference's own step on the port's inputs, within the tolerance
    want = float(ref_step(jnp.asarray(a.float().numpy(), dtype=jnp.bfloat16),
                          jnp.asarray(b.float().numpy(), dtype=jnp.bfloat16)))
    assert abs(float(step(a, b)) - want) <= 1e-5 * float(graft.gemm_f32(a, b).abs().sum())


def test_entry_defaults_to_the_card_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        graft.entry()


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 128])
def test_factor_mesh_matches_the_reference(n):
    assert graft.factor_mesh(n) == ref_graft.factor_mesh(n)


def _ref_dryrun(n):
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    # nice: a JAX import yields to the suite's other workers
    proc = subprocess.run(["nice", "-n", "10", sys.executable, str(REPO / "__graft_entry__.py"), str(n)],
                          cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return LINE.search(proc.stdout).groups()


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_matches_the_reference(n, capsys):
    got = graft.dryrun_multichip(n)
    (line,) = [m.groups() for m in map(LINE.search, capsys.readouterr().out.splitlines()) if m]
    want = _ref_dryrun(n)
    assert line == want
    hosts, chips = graft.factor_mesh(n)
    assert (got["hosts"], got["chips"], got["devices"], got["platform"]) == (hosts, chips, n, "cpu")
    assert got["checksum"] == float(want[4]) or f"{got['checksum']:.3e}" == want[4]
    assert got["checksum"] == hosts * graft.DIM * graft.DIM * chips * graft.DIM
    assert (got["links"], got["dcn_pairs"]) == (int(want[5]), int(want[6]))
    if n == 8:
        assert line == ("2", "4", "8", "cpu", "1.678e+07", "12", "6")


def test_graft_entry_script_runs_the_dryrun():
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "MASTER_ADDR", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=str(REPO))
    proc = subprocess.run(["nice", "-n", "10", sys.executable, str(REPO / "__graft_entry_gpu__.py"), "6"],
                          cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert LINE.search(proc.stdout).groups() == ("2", "3", "6", "cpu", "1.258e+07", "9", "1")
