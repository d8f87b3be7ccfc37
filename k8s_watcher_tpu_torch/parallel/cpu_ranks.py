"""Gloo ranks in CPU processes on this host: the port's counterpart of the
JAX package's virtual CPU mesh, for the graft dryrun (``graft.py``) and the
chaos drill's ``--cpu-ranks`` (``chaos_probe.py``).

:func:`run_cpu_ranks` starts one fresh interpreter, which imports torch and
the target once and then forks the other ranks: a group costs one import of
torch, not one per rank. The launcher forks before it has started any thread
or touched a device, the one state in which ``fork`` is safe. Each rank joins
a gloo group over a ``FileStore``, calls ``target(rank, world, **kwargs)``
and writes what it returns as JSON; the group ends once every rank's target
has returned, unless a target has ended it. The launcher leads its own
process group, so a hung rank is killed with the others at the time limit.

Usage of the launcher (what :func:`run_cpu_ranks` runs):
``python -m k8s_watcher_tpu_torch.parallel.cpu_ranks <module:function> <world> <directory>``
"""

from __future__ import annotations

import datetime
import importlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

# what torchrun sets; a launcher started from a torchrun rank must not
# inherit its group
_GROUP_ENV = ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")
_PACKAGE_ROOT = str(Path(__file__).resolve().parent.parent.parent)
# a group's whole run, the launcher's imports included (128 ranks: ~45 s on 8 cores)
TIMEOUT_S = 600.0


def run_cpu_ranks(
    target: str,
    world: int,
    kwargs: Optional[Dict[str, Any]] = None,
    *,
    local_world_size: Optional[int] = None,
) -> List[Any]:
    """Run ``target`` (``"module:function"``) on ``world`` gloo ranks in CPU
    processes; what each rank returned, by rank.

    ``local_world_size`` ranks count as one node (``LOCAL_WORLD_SIZE``, which
    parallel/mesh.py reads; default: all of them). Raises ``RuntimeError``
    with the ranks' output when a rank fails or the group outlives
    ``TIMEOUT_S``."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    with tempfile.TemporaryDirectory(prefix="cpu-ranks-") as tmp:
        with open(os.path.join(tmp, "kwargs.json"), "w") as fh:
            json.dump(kwargs or {}, fh)
        env = {k: v for k, v in os.environ.items() if k not in _GROUP_ENV}
        env["LOCAL_WORLD_SIZE"] = str(local_world_size or world)
        # no BLAS or OpenMP worker threads exist when the launcher forks
        env.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
        env["PYTHONPATH"] = os.pathsep.join(p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
        proc = subprocess.Popen(
            [sys.executable, "-m", __name__, target, str(world), tmp],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, start_new_session=True,
        )
        try:
            out, _ = proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, _ = proc.communicate()
            raise RuntimeError(f"{world} CPU ranks did not finish in {TIMEOUT_S} s:\n"
                               + out.decode(errors="replace")[-3000:]) from None
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        if proc.returncode != 0:
            raise RuntimeError(f"{world} CPU ranks failed ({proc.returncode}):\n"
                               + out.decode(errors="replace")[-3000:])
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"{rank}.json")) as fh:
                results.append(json.load(fh))
        return results


def _launch(target: str, world: int, directory: str) -> int:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # the ranks share the host's cores
    module, _, name = target.partition(":")
    fn = getattr(importlib.import_module(module), name)
    with open(os.path.join(directory, "kwargs.json")) as fh:
        kwargs = json.load(fh)
    rank, children = 0, []
    for r in range(1, world):
        sys.stdout.flush()
        sys.stderr.flush()
        pid = os.fork()
        if pid == 0:
            rank, children = r, []
            break
        children.append(pid)
    code = 0
    try:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(directory, "store"), world), rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=300))
        result = fn(rank, world, **kwargs)
        with open(os.path.join(directory, f"{rank}.json"), "w") as fh:
            json.dump(result, fh, default=str)
        if dist.is_initialized():  # a target may end the group itself (probe_agent.run_loop does)
            dist.barrier()  # no rank tears the group down while a peer still talks to it
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — a forked rank must reach os._exit, never unwind into the launcher
        print(f"rank {rank} failed:", flush=True)
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    if rank:
        os._exit(code)
    for pid in children:
        _, status = os.waitpid(pid, 0)
        code = code or int(status != 0)
    return code


if __name__ == "__main__":
    sys.exit(_launch(sys.argv[1], int(sys.argv[2]), sys.argv[3]))
