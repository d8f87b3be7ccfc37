"""Gloo ranks on the CPU for the port's multi-rank tests, and tests of them.

:func:`run_ranks` runs a script on ``world`` gloo ranks forked from one
process: the process imports torch and the port once, then forks the other
ranks, so a group costs one import instead of one per rank (the suite runs
beside other tests with several workers, and their timing must not suffer).
Each rank gets ``rank``, ``world``, ``store`` (a ``FileStore`` path) and
``out_path`` (where it writes its JSON result) as globals; the launcher
exits non-zero when any rank raised. The whole group runs in its own
session, so a hung rank is killed with the others at the timeout.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
RANK_ENV = ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")

_LAUNCHER = r"""
import os, sys, traceback
import torch
torch.set_num_threads(1)  # the ranks share the host's cores
import torch.distributed
import k8s_watcher_tpu_torch.probe.agent  # noqa: F401 (imported once, shared by every rank)
world, store, out_dir, script_path = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
with open(script_path) as fh:
    script = fh.read()
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
    exec(compile(script, f"<rank {rank}>", "exec"), {
        "__name__": "__rank__", "rank": rank, "world": world, "store": store,
        "out_path": os.path.join(out_dir, f"{rank}.json"),
    })
except BaseException:
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
sys.exit(code)
"""

# Every worker script starts so: a gloo group over the FileStore, with a
# timeout that turns a hang into a failure well inside the suite's limit.
PREAMBLE = """
import datetime, json, os
import torch
import torch.distributed as dist
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=45))
"""

# ... and ends so, after writing its result
POSTAMBLE = """
dist.barrier()  # no rank tears down while a peer still talks to it
dist.destroy_process_group()
"""


def run_ranks(body, world, tmp_path, local_world_size=None, timeout=100):
    """Run ``PREAMBLE + body + POSTAMBLE`` on ``world`` forked gloo ranks;
    each rank's JSON result, by rank."""
    script = tmp_path / "worker.py"
    script.write_text(PREAMBLE + body + POSTAMBLE)
    env = {k: v for k, v in os.environ.items() if k not in RANK_ENV}
    # no BLAS or OpenMP worker threads exist when the launcher forks
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    if local_world_size is not None:
        env["LOCAL_WORLD_SIZE"] = str(local_world_size)
    proc = subprocess.Popen(
        [sys.executable, "-c", _LAUNCHER, str(world), str(tmp_path / "store"), str(tmp_path), str(script)],
        env=env, cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, start_new_session=True,
    )
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"{world} ranks did not finish in {timeout} s:\n" + out.decode(errors="replace")[-3000:])
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, out.decode(errors="replace")[-3000:]
    return [json.loads((tmp_path / f"{r}.json").read_text()) for r in range(world)]


_ECHO = """
t = torch.tensor([float(rank)])
dist.all_reduce(t)
with open(out_path, "w") as fh:
    json.dump({"rank": rank, "world": dist.get_world_size(), "sum": t.item(), "pid": os.getpid(),
               "local": os.environ.get("LOCAL_WORLD_SIZE")}, fh)
"""


def test_every_rank_runs_in_its_own_process(tmp_path):
    got = run_ranks(_ECHO, 4, tmp_path, local_world_size=2)
    assert [r["rank"] for r in got] == [0, 1, 2, 3]
    assert all(r["world"] == 4 and r["sum"] == 6.0 and r["local"] == "2" for r in got)
    assert len({r["pid"] for r in got}) == 4


def test_a_failing_rank_fails_the_group(tmp_path):
    body = "if rank == 1:\n    raise RuntimeError('rank 1 broke')\n" + _ECHO.replace("dist.all_reduce(t)\n", "")
    with pytest.raises(AssertionError, match="rank 1 broke"):
        run_ranks(body, 2, tmp_path)
