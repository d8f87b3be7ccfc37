"""Graft entry points of the PyTorch/CUDA port (``k8s_watcher_tpu_torch``),
the counterpart of ``__graft_entry__.py``.

- ``entry(device=None)`` -> ``(probe_step, (a, b))``: the per-GPU probe step,
  a bf16 tensor-core product with an f32 result folded into one checksum (NaN
  when any element is not finite), and its two seeded ``(256, 256)`` bf16
  inputs, on the card unless ``device="cpu"``.
- ``dryrun_multichip(n)``: one full probe step over ``n`` gloo ranks in CPU
  processes; prints ``dryrun_multichip OK: mesh=(HxC) devices=n platform=cpu
  checksum=... links=... dcn_pairs=...``.

Usage: ``python __graft_entry_gpu__.py [n]`` (default 8). Imports only the port.
"""

from __future__ import annotations

from k8s_watcher_tpu_torch.graft import dryrun_multichip, entry, factor_mesh  # noqa: F401

if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
