"""The HBM probe kernels: wrappers over ``csrc/hbm.cu`` and their plain versions.

Each function computes what one Pallas kernel of the JAX package computes,
with the JAX package's buffer layouts:

- :func:`read_sweep` (``_reduce_kernel``): ``repeats`` passes over a
  ``(rows, WIDTH)`` f32 buffer, the column sums of every pass added into one
  ``(1, WIDTH)`` vector;
- :func:`fill` (``_fill_kernel``): ``repeats`` passes writing every element of
  write block ``i`` (``WRITE_BLOCK_ROWS x WRITE_WIDTH`` f32) as ``i + 1 + seed``;
- :func:`blocksums` (``_blocksum_kernel``): slot ``i`` of a ``(1, num_blocks)``
  vector gets the sum of write block ``i``.

A wrapper given a CPU tensor runs the plain PyTorch version beside it; given a
CUDA tensor it launches the kernel or raises. It never falls back.

:func:`read_sweep` and :func:`fill` take an optional ``timer`` (a
``ctypes.c_float``, CUDA tensors only): the C entry point then brackets its
launches with CUDA events itself, waits for them, and stores the device time
in ms.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from k8s_watcher_tpu_torch.kernels import build

LANES = 128
BLOCK_ROWS = 1024
WIDTH = 4 * LANES
BYTES_PER_BLOCK = BLOCK_ROWS * WIDTH * 4

WRITE_BLOCK_ROWS = 512
WRITE_WIDTH = 2 * LANES
WRITE_BLOCK_ELEMS = WRITE_BLOCK_ROWS * WRITE_WIDTH
WRITE_BYTES_PER_BLOCK = WRITE_BLOCK_ELEMS * 4

# CTAs per SM for the grid-stride kernels: enough 16-byte accesses in flight
# to cover HBM latency at full rate (csrc/hbm.cu)
_CTAS_PER_SM = 4


def read_sweep_plain(x: torch.Tensor, repeats: int) -> torch.Tensor:
    out = torch.zeros((1, WIDTH), dtype=torch.float32, device=x.device)
    for _ in range(repeats):
        out += x.sum(0, keepdim=True)
    return out


def fill_plain(seed: torch.Tensor, num_blocks: int, repeats: int) -> torch.Tensor:
    values = torch.arange(1, num_blocks + 1, dtype=torch.float32, device=seed.device)
    values = values + seed.reshape(())
    out = torch.empty((num_blocks * WRITE_BLOCK_ROWS, WRITE_WIDTH), dtype=torch.float32,
                      device=seed.device)
    blocks = out.view(num_blocks, WRITE_BLOCK_ELEMS)
    for _ in range(repeats):
        blocks.copy_(values[:, None].expand(num_blocks, WRITE_BLOCK_ELEMS))
    return out


def blocksums_plain(x: torch.Tensor) -> torch.Tensor:
    num_blocks = x.shape[0] // WRITE_BLOCK_ROWS
    return x.reshape(num_blocks, WRITE_BLOCK_ELEMS).sum(1).reshape(1, num_blocks)


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(message)


def _check_f32(t: torch.Tensor, name: str) -> None:
    _require(t.dtype == torch.float32, f"{name}: expected float32, got {t.dtype}")
    _require(t.is_contiguous(), f"{name}: expected a contiguous tensor")
    _require(t.device.type in ("cpu", "cuda"), f"{name}: unsupported device {t.device}")
    # the kernels move 16-byte vectors
    _require(t.device.type == "cpu" or t.data_ptr() % 16 == 0, f"{name}: not 16-byte aligned")


def _launch_ctas(device: torch.device) -> int:
    return _CTAS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _timer_ref(timer: Optional[ctypes.c_float], device: torch.device):
    _require(timer is None or device.type == "cuda", "timer: the kernels time themselves on CUDA tensors only")
    return ctypes.byref(timer) if timer is not None else None


def read_sweep(x: torch.Tensor, repeats: int, *, timer: Optional[ctypes.c_float] = None) -> torch.Tensor:
    """``repeats`` passes of column sums over ``x`` (rows, WIDTH) -> (1, WIDTH)."""
    timer_ref = _timer_ref(timer, x.device)
    _check_f32(x, "read_sweep x")
    _require(x.dim() == 2 and x.shape[1] == WIDTH and x.shape[0] > 0,
             f"read_sweep x: expected (rows, {WIDTH}), got {tuple(x.shape)}")
    _require(repeats >= 1, f"read_sweep: repeats must be >= 1, got {repeats}")
    if x.device.type == "cpu":
        return read_sweep_plain(x, repeats)
    lib = build.load()
    num_ctas = _launch_ctas(x.device)
    partials = torch.empty((num_ctas, WIDTH), dtype=torch.float32, device=x.device)
    out = torch.empty((1, WIDTH), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.k8w_hbm_read_sweep(
            x.data_ptr(), x.shape[0], repeats, partials.data_ptr(), num_ctas,
            out.data_ptr(), _stream(x.device), timer_ref,
        )
    build.check(lib, code, "read_sweep")
    build.count("read_sweep")
    return out


def fill(seed: torch.Tensor, num_blocks: int, repeats: int, *,
         timer: Optional[ctypes.c_float] = None) -> torch.Tensor:
    """``repeats`` passes stamping write block ``i`` with ``i + 1 + seed``.

    ``seed`` is a one-element f32 tensor on the target device, read by the
    kernel at run time. Returns the ``(num_blocks * WRITE_BLOCK_ROWS,
    WRITE_WIDTH)`` buffer."""
    timer_ref = _timer_ref(timer, seed.device)
    _check_f32(seed, "fill seed")
    _require(seed.numel() == 1, f"fill seed: expected one element, got {seed.numel()}")
    _require(num_blocks >= 1, f"fill: num_blocks must be >= 1, got {num_blocks}")
    _require(repeats >= 1, f"fill: repeats must be >= 1, got {repeats}")
    if seed.device.type == "cpu":
        return fill_plain(seed, num_blocks, repeats)
    lib = build.load()
    out = torch.empty((num_blocks * WRITE_BLOCK_ROWS, WRITE_WIDTH), dtype=torch.float32,
                      device=seed.device)
    with torch.cuda.device(seed.device):
        code = lib.k8w_hbm_fill(
            seed.data_ptr(), out.data_ptr(), out.numel(), repeats,
            _launch_ctas(seed.device), _stream(seed.device), timer_ref,
        )
    build.check(lib, code, "fill")
    build.count("fill")
    return out


def blocksums(x: torch.Tensor) -> torch.Tensor:
    """Per-write-block sums of ``x`` (num_blocks * WRITE_BLOCK_ROWS, WRITE_WIDTH)
    -> (1, num_blocks)."""
    _check_f32(x, "blocksums x")
    _require(
        x.dim() == 2 and x.shape[1] == WRITE_WIDTH and x.shape[0] > 0
        and x.shape[0] % WRITE_BLOCK_ROWS == 0,
        f"blocksums x: expected (k * {WRITE_BLOCK_ROWS}, {WRITE_WIDTH}), got {tuple(x.shape)}",
    )
    if x.device.type == "cpu":
        return blocksums_plain(x)
    lib = build.load()
    num_blocks = x.shape[0] // WRITE_BLOCK_ROWS
    out = torch.empty((1, num_blocks), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.k8w_hbm_blocksums(x.data_ptr(), num_blocks, out.data_ptr(), _stream(x.device))
    build.check(lib, code, "blocksums")
    build.count("blocksums")
    return out
