"""What one probe cycle is defined to do, and what its outputs must be,
worked out from the configuration's settings and the stages' definitions (the
port's ``probe/agent.py``, ``probe/hbm.py``, ``probe/ici.py`` and
``kernels/hbm.py``, as the JAX package's ``probe/`` defines them). Nothing here
imports the port or reads what it made.

A cycle, for a buffer of ``hbm_bytes`` and a GEMM of ``matmul_size``:

- the read stage: one integrity sweep and ``TIMED_ITERS`` timed sweeps, each
  of ``repeats`` passes of column sums over a ``(rows, 512)`` float32 buffer
  of ones, so every column totals ``rows * repeats``;
- the write stage: one kept fill and ``TIMED_ITERS`` timed fills, each of
  ``repeats`` passes over ``blocks`` write blocks (512 x 256 float32), then
  one block-sum vector of the kept fill: block ``i`` holds ``i + 1``
  everywhere (seed 0), so its sum is ``(i + 1) * 131072``;
- the GEMM stage: ``MXU_ITERS`` launches of one CUDA graph, each a chain of
  ``inner_iters`` bf16 GEMMs ``carry @ b`` rescaled by ``1 / sqrt(n)``, on
  operands drawn from a ``torch.Generator`` seeded 0.

On the card ``repeats`` moves about 32 GiB a launch; off the card the stages
cap the buffer at two blocks and make one pass, and time the GEMM chain
without a graph. The HBM totals are integers exact in float32, so those
comparisons are exact. ``dtype`` names the precision the reference computes
in: as stated, or one step lower for the control, on ``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

WIDTH = 512
READ_BLOCK_BYTES = 1024 * WIDTH * 4
WRITE_BLOCK_ROWS, WRITE_WIDTH = 512, 256
WRITE_BLOCK_ELEMS = WRITE_BLOCK_ROWS * WRITE_WIDTH
WRITE_BLOCK_BYTES = WRITE_BLOCK_ELEMS * 4
TIMED_ITERS = 4  # timed launches of each HBM stage, after its first
MXU_ITERS = 5  # timed graph launches of the GEMM stage
TRAFFIC_PER_LAUNCH = 32 << 30
MAX_REPEATS = 256


def _repeats(actual_bytes: int, on_card: bool) -> int:
    return max(1, min(MAX_REPEATS, TRAFFIC_PER_LAUNCH // actual_bytes)) if on_card else 1


@dataclasses.dataclass(frozen=True)
class Plan:
    """One cycle's work as its stages define it."""

    read_rows: int
    read_repeats: int
    write_blocks: int
    write_repeats: int
    gemm_size: int
    gemm_inner_iters: int
    on_card: bool

    @property
    def calls(self) -> dict:
        """How often each entry runs in a cycle, with these arguments."""
        return {"read_sweep": 1 + TIMED_ITERS, "fill": 1 + TIMED_ITERS, "blocksums": 1,
                "graph_launch": MXU_ITERS if self.on_card else 0}

    @property
    def read_bytes(self) -> int:
        """The buffer of ones written once; every sweep reads it ``repeats``
        times and writes its 512 totals."""
        buffer = self.read_rows * WIDTH * 4
        return buffer + self.calls["read_sweep"] * (self.read_repeats * buffer + 4 * WIDTH)

    @property
    def write_bytes(self) -> int:
        """Every fill writes the buffer ``repeats`` times; the block sums read
        the kept one and write one float a block."""
        buffer = self.write_blocks * WRITE_BLOCK_BYTES
        return self.calls["fill"] * self.write_repeats * buffer + buffer + 4 * self.write_blocks

    @property
    def gemm_flops(self) -> int:
        return self.calls["graph_launch"] * self.gemm_inner_iters * 2 * self.gemm_size ** 3


def cycle_plan(settings: dict, on_card: bool) -> Plan:
    """The plan for ``settings`` (``hbm_bytes``, ``matmul_size``,
    ``matmul_inner_iters``, as ``tpu.probe`` names them)."""
    read_bytes = settings["hbm_bytes"] if on_card else min(settings["hbm_bytes"], 2 * READ_BLOCK_BYTES)
    read_blocks = max(1, read_bytes // READ_BLOCK_BYTES)
    write_bytes = settings["hbm_bytes"] if on_card else min(settings["hbm_bytes"], 2 * WRITE_BLOCK_BYTES)
    write_blocks = max(1, write_bytes // WRITE_BLOCK_BYTES)
    return Plan(read_rows=read_blocks * 1024, read_repeats=_repeats(read_blocks * READ_BLOCK_BYTES, on_card),
                write_blocks=write_blocks, write_repeats=_repeats(write_blocks * WRITE_BLOCK_BYTES, on_card),
                gemm_size=settings["matmul_size"], gemm_inner_iters=settings["matmul_inner_iters"],
                on_card=on_card)


def read_totals(rows: int, repeats: int) -> np.ndarray:
    """The read sweep's ``(512,)`` column totals."""
    return np.full(WIDTH, float(rows) * repeats)


def read_sweep_in(x, repeats: int, dtype):
    """``repeats`` passes of column sums over ``x``, summed and added in
    ``dtype``: ``(1, 512)`` float32."""
    import torch

    part = x.to(dtype).sum(0, keepdim=True, dtype=dtype)
    out = torch.zeros_like(part)
    for _ in range(repeats):
        out = out + part
    return out.float()


def block_sums(num_blocks: int) -> np.ndarray:
    """The write probe's ``(num_blocks,)`` block sums."""
    return np.arange(1, num_blocks + 1, dtype=np.float64) * WRITE_BLOCK_ELEMS


def block_sums_in(x, dtype):
    """The block sums of the written buffer ``x`` in ``dtype``: ``(1, blocks)``
    float32."""
    blocks = x.shape[0] // WRITE_BLOCK_ROWS
    return x.reshape(blocks, WRITE_BLOCK_ELEMS).to(dtype).sum(1, dtype=dtype).float().reshape(1, blocks)


def gemm_operands(size: int, device):
    """The GEMM stage's operands, drawn as the stage draws them."""
    import torch

    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((size, size), generator=gen, device=device).to(torch.bfloat16)
    b = torch.randn((size, size), generator=gen, device=device).to(torch.bfloat16)
    return a, b


def gemm_chain(a, b, inner_iters: int, *, fp8: bool = False):
    """The chain ``carry @ b`` rescaled by ``1 / sqrt(n)``: in float64, or,
    for the control, with operands and every product rounded to float8
    (e4m3). The result is float64, or bfloat16 for the control."""
    import torch

    scale = 1.0 / a.shape[0] ** 0.5
    if not fp8:
        carry, bb = a.double(), b.double()
        for _ in range(inner_iters):
            carry = carry @ bb * scale
        return carry

    def q(t):
        return t.float().to(torch.float8_e4m3fn).float()

    carry, bb = a, q(b)
    for _ in range(inner_iters):
        carry = q(q(carry) @ bb * scale)
    return carry.to(torch.bfloat16)


def relative_norm_gap(got, want) -> float:
    """``||got - want|| / ||want||`` (Frobenius); 1.0 where the shapes differ."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        return 1.0
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def worst_relative_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The largest ``|got - want| / want``; 1.0 where the shapes differ."""
    got, want = np.asarray(got, dtype=np.float64).reshape(-1), np.asarray(want, dtype=np.float64).reshape(-1)
    if got.shape != want.shape:
        return 1.0
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0))) if want.size else 0.0
