"""Device inventory, liveness and host identity (the JAX package's ``probe/device.py``).

Each GPU of the node is listed with its identity. Only this rank's own GPU
is touched: its memory use is read and a one-element computation
(``2 * 2 == 4``) isolates a GPU that enumerates but cannot execute. The
node's other GPUs belong to other ranks, are counted without a CUDA context
and listed with ``alive: None``, as the JAX package lists remote chips: a
rank that touched every GPU would put a context (and its memory) on each.
"""

from __future__ import annotations

import json
import logging
import os
import socket
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from k8s_watcher_tpu_torch.probe import spans

logger = logging.getLogger(__name__)


def resolve_device(device=None) -> torch.device:
    """The device a probe runs on: CUDA unless the caller asks for the CPU.

    Asking for CUDA where there is none raises; nothing falls back to the
    CPU. A bare ``"cuda"`` means this rank's GPU (``LOCAL_RANK`` under
    ``torchrun``, else the current one)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was asked for, but torch.cuda.is_available() is False")
        if device.index is None:
            local = os.environ.get("LOCAL_RANK")
            device = torch.device("cuda", int(local) if local is not None else torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported probe device {device}: expected cuda or cpu")
    return device


def device_id(device: torch.device) -> int:
    return device.index if device.index is not None else 0


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_devices(device_type: str) -> List[torch.device]:
    """Every device of this node of the given type (each GPU, or the CPU).
    Counting GPUs creates no context on them."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA inventory was asked for, but torch.cuda.is_available() is False")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def host_identity() -> Dict[str, Any]:
    """This rank's host identity: the join key that turns a suspect GPU's
    rank into a drainable k8s node (``NODE_NAME`` from the downward API)."""
    out: Dict[str, Any] = {"hostname": socket.gethostname(), "process_index": process_index()}
    for env in ("NODE_NAME", "RANK", "LOCAL_RANK"):
        value = os.environ.get(env)
        if value:
            out[env.lower()] = value
    return out


_IDENTITY_WIRE_BYTES = 512


def _encode_identity_wire(identity: Dict[str, Any]) -> bytes:
    """JSON-encode an identity to at most ``_IDENTITY_WIRE_BYTES - 1`` bytes
    of always-decodable utf-8 (``ensure_ascii=False`` so the encoded length
    is the real byte cost; clipping never cuts a multibyte sequence)."""

    def clip(s: str, max_bytes: int) -> str:
        return s.encode("utf-8")[:max_bytes].decode("utf-8", errors="ignore")

    raw = json.dumps(identity, ensure_ascii=False).encode("utf-8")
    if len(raw) < _IDENTITY_WIRE_BYTES:
        return raw
    logger.warning(
        "Host identity JSON (%d bytes) exceeds the %d-byte wire buffer; "
        "gathering a minimal identity instead", len(raw), _IDENTITY_WIRE_BYTES
    )
    minimal: Dict[str, Any] = {
        "hostname": clip(str(identity.get("hostname", "")), 180),
        "process_index": identity["process_index"],
    }
    if "node_name" in identity:
        minimal["node_name"] = clip(str(identity["node_name"]), 180)
    raw = json.dumps(minimal, ensure_ascii=False).encode("utf-8")
    if len(raw) < _IDENTITY_WIRE_BYTES:
        return raw
    return json.dumps({"process_index": identity["process_index"]}).encode("utf-8")


def all_gather_rows(raw: bytes, device: Optional[torch.device] = None) -> List[bytes]:
    """Every rank's ``raw`` (fewer than ``_IDENTITY_WIRE_BYTES`` bytes), by rank.

    One ``all_gather_into_tensor`` of a fixed-size zero-padded row per rank,
    on ``device`` under NCCL and on the CPU under gloo. Every rank must call
    it together."""
    width = _IDENTITY_WIRE_BYTES
    if len(raw) >= width:
        raise ValueError(f"{len(raw)} bytes do not fit a {width}-byte row")
    if dist.get_backend() == "nccl":
        device = device if device is not None and device.type == "cuda" else torch.device(
            "cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    buf = torch.zeros(width, dtype=torch.uint8)
    if raw:
        buf[: len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    n = process_count()
    gathered = torch.empty(n * width, dtype=torch.uint8, device=device)
    spans.count("collectives")
    dist.all_gather_into_tensor(gathered, buf.to(device))
    with spans.sync():
        rows = gathered.cpu().view(n, width).numpy()
    return [rows[idx].tobytes().rstrip(b"\x00") for idx in range(n)]


# str(rank) -> identity, gathered once per default group: identities are
# stable, and the gather is a collective not worth repeating every cycle
_IDENTITY_MAPS: Dict[Any, Dict[str, Dict[str, Any]]] = {}


def host_identity_map(device: Optional[torch.device] = None) -> Dict[str, Dict[str, Any]]:
    """``str(rank) -> host_identity()`` for every rank.

    A suspect GPU found by the link walk lives on another rank, but rank 0
    reports: this map names the node to drain. Several ranks gather one
    fixed-size utf-8 row each (:func:`all_gather_rows`) once per default
    group; a row that does not decode keeps its index with an ``error``."""
    if process_count() == 1:
        mine = host_identity()
        return {str(mine["process_index"]): mine}
    world = dist.group.WORLD
    cached = _IDENTITY_MAPS.get(world)
    if cached is not None:
        return cached
    out: Dict[str, Dict[str, Any]] = {}
    for idx, row in enumerate(all_gather_rows(_encode_identity_wire(host_identity()), device)):
        try:
            out[str(idx)] = json.loads(row.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            # keep the index mapped: the operator still sees WHICH rank is unidentifiable
            out[str(idx)] = {"process_index": idx, "error": "identity decode failed"}
    _IDENTITY_MAPS[world] = out
    return out


def node_ranks(hosts: Dict[str, Dict[str, Any]], node_name: Optional[str]) -> List[int]:
    """The ranks of ``hosts`` (an identity map) on node ``node_name``, in
    order; none when the node is unnamed."""
    if not node_name:
        return []
    return sorted(int(r) for r, identity in hosts.items() if (identity or {}).get("node_name") == node_name)


def local_rank() -> int:
    """This rank's index on its node: ``LOCAL_RANK`` under ``torchrun``, else 0."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def _device_entry(device: torch.device, own: bool) -> Dict[str, Any]:
    """Identity of ``device``; rank and memory use only for this rank's own
    (querying memory makes a CUDA context)."""
    entry: Dict[str, Any] = {
        "id": device_id(device),
        "platform": device.type,
        "device_kind": torch.cuda.get_device_properties(device).name if device.type == "cuda" else device.type,
        "process_index": process_index() if own else None,
    }
    if own and device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        entry["memory"] = {"bytes_in_use": total - free, "bytes_limit": total}
    return entry


def _device_alive(device: torch.device) -> bool:
    """Run a one-element computation on ``device``."""
    try:
        x = torch.tensor(2.0, dtype=torch.float32, device=device)
        with spans.sync():
            return float((x * x).item()) == 4.0
    except Exception as exc:  # noqa: BLE001 — a dead device must read as dead, not raise
        logger.error("Device %s failed liveness computation: %s", device, exc)
        return False


@spans.traced("probe.inventory")
def enumerate_devices(
    own: Optional[torch.device] = None,
    *,
    expected_per_host: int = 0,
    check_liveness: bool = True,
    expected_platform: Optional[str] = None,
) -> Dict[str, Any]:
    """Inventory of this node's devices of ``own``'s type + liveness verdicts.

    ``own`` is this rank's device (default: :func:`resolve_device`); only it
    is checked for liveness and memory, the node's other GPUs are listed
    with ``alive: None``. ``expected_per_host > 0`` flags a node that
    enumerates fewer GPUs than the deployment demands; ``expected_platform``
    (``"cuda"``) flags devices on the wrong backend, so a probe measuring
    the CPU never reports healthy."""
    own = resolve_device(own)
    devices = local_devices(own.type)
    entries: List[Dict[str, Any]] = []
    healthy = 0
    for device in devices:
        mine = device == own
        entry = _device_entry(device, mine)
        entry["alive"] = _device_alive(device) if check_liveness and mine else None
        if entry["alive"] is not False:
            healthy += 1
        entries.append(entry)

    result: Dict[str, Any] = {
        "process_index": process_index(),
        "process_count": process_count(),
        "visible_devices": len(devices),
        "local_devices": len(devices),
        "healthy_devices": healthy,
        "devices": entries,
    }
    if expected_per_host > 0:
        result["expected_local_devices"] = expected_per_host
        result["missing_local_devices"] = max(0, expected_per_host - len(devices))
    if expected_platform:
        mismatched = sum(1 for d in devices if d.type != expected_platform)
        result["expected_platform"] = expected_platform
        result["platform_mismatch"] = mismatched
        if mismatched:
            logger.warning(
                "%d/%d devices are not %s (found: %s)",
                mismatched, len(devices), expected_platform, sorted({d.type for d in devices}),
            )
    return result
