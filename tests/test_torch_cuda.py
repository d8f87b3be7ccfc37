"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

They skip where ``torch.cuda.is_available()`` is False, deciding inside a
fixture. This file imports nothing of JAX, so it also runs on a machine with
PyTorch for CUDA and no JAX, without the suite's ``conftest.py``:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import pytest
import torch

from k8s_watcher_tpu_torch import carry
from k8s_watcher_tpu_torch.config import TpuConfig
from k8s_watcher_tpu_torch.kernels import build
from k8s_watcher_tpu_torch.kernels import hbm as K
from k8s_watcher_tpu_torch.probe import hbm as port
from k8s_watcher_tpu_torch.probe.agent import ProbeAgent

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda", 0)


def test_kernels_match_plain_versions(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randint(0, 4, (4 * K.BLOCK_ROWS, K.WIDTH), generator=gen, device=cuda_device).float()
    assert torch.equal(K.read_sweep(x, 3), K.read_sweep_plain(x, 3))
    seed = carry.seed(3.0, cuda_device)
    y = K.fill(seed, 8, 2)
    assert torch.equal(y.view(torch.int32), K.fill_plain(seed, 8, 2).view(torch.int32))
    y.view(8, -1)[[2, 5], 11] += 1e6
    # the kernel's tree and PyTorch's reduction add in other orders
    assert torch.allclose(K.blocksums(y), K.blocksums_plain(y), rtol=1e-5, atol=0.0)


def test_probes_launch_the_kernels(cuda_device):
    build.reset_launch_counts()
    assert port.run_hbm_probe(16 << 20, iters=2, device=cuda_device)["interpreted"] is False
    out = port.run_hbm_write_probe(16 << 20, iters=2, device=cuda_device)
    assert out["ok"] and out["interpreted"] is False
    assert build.launch_counts() == {"read_sweep": 3, "fill": 3, "blocksums": 1}


def test_write_probe_localizes_corruption_on_card(cuda_device):
    def corrupt(y):
        y = y.clone()
        y[K.WRITE_BLOCK_ROWS * 3 + 7, 3] += 1e6
        return y

    out = port.run_hbm_write_probe(8 << 20, iters=1, device=cuda_device, corrupt_hook=corrupt)
    assert not out["ok"]
    assert [b["block"] for b in out["bad_blocks"]] == [3]


def test_one_cycle_on_card_is_healthy(cuda_device):
    config = TpuConfig(probe_payload_bytes=1 << 20, probe_hbm_bytes=32 << 20)
    report = ProbeAgent(config, environment="development", sink=lambda n: None, device=cuda_device).run_once()
    assert report.healthy, report.to_payload()
    assert report.hbm["interpreted"] is False and report.hbm_write["interpreted"] is False


def test_device_timing_ignores_threads_holding_the_interpreter(cuda_device):
    """The watcher runs the probe beside ingest threads busy in Python. The
    GEMM chain's and the HBM sweeps' readings must be the card's: timed by
    the C side around one launch, threads hogging the interpreter lock
    cannot slow them down (timed from Python, the chain read tens of times
    slower)."""
    import threading

    from k8s_watcher_tpu_torch.probe.ici import run_mxu_probe

    def readings():
        return (run_mxu_probe(1024, inner_iters=8, device=cuda_device),
                port.run_hbm_probe(64 << 20, device=cuda_device),
                port.run_hbm_write_probe(64 << 20, device=cuda_device))

    quiet = readings()
    stop = threading.Event()

    def hog():
        n = 0
        while not stop.is_set():
            n = (n * 31 + 7) % 1000003  # pure Python: holds the lock between switches

    threads = [threading.Thread(target=hog, daemon=True) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        busy = readings()
    finally:
        stop.set()
        for t in threads:
            t.join(5)
    assert all(r["ok"] for r in quiet + busy), (quiet, busy)
    assert busy[0]["tflops_median"] > 0.7 * quiet[0]["tflops_median"], (quiet[0], busy[0])
    assert busy[1]["read_gbps"] > 0.8 * quiet[1]["read_gbps"], (quiet[1], busy[1])
    assert busy[2]["write_gbps"] > 0.8 * quiet[2]["write_gbps"], (quiet[2], busy[2])


def test_kernels_time_themselves(cuda_device):
    import ctypes

    x = torch.ones((64 * K.BLOCK_ROWS, K.WIDTH), device=cuda_device)
    timer = ctypes.c_float()
    out = K.read_sweep(x, 4, timer=timer)
    assert torch.equal(out, K.read_sweep_plain(x, 4)) and timer.value > 0
    fill_timer = ctypes.c_float()
    K.fill(carry.seed(1.0, cuda_device), 64, 4, timer=fill_timer)
    assert fill_timer.value > 0
