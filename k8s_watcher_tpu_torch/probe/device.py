"""Device inventory, liveness and host identity (the JAX package's ``probe/device.py``).

Each local GPU is reported with identity, rank and memory use, and a
one-element computation (``2 * 2 == 4``) isolates a GPU that enumerates but
cannot execute.
"""

from __future__ import annotations

import json
import logging
import os
import socket
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

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
    """Every device of this node of the given type (each GPU, or the CPU)."""
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


def host_identity_map() -> Dict[str, Dict[str, Any]]:
    """``str(rank) -> host_identity()`` for every rank."""
    if process_count() == 1:
        mine = host_identity()
        return {str(mine["process_index"]): mine}
    raise NotImplementedError(
        "the multi-rank identity gather (a 512-byte all_gather per rank) is "
        "ported with the links slice; this slice runs one rank per probe"
    )


def _device_entry(device: torch.device) -> Dict[str, Any]:
    entry: Dict[str, Any] = {
        "id": device_id(device),
        "platform": device.type,
        "device_kind": torch.cuda.get_device_properties(device).name if device.type == "cuda" else device.type,
        "process_index": process_index(),
    }
    if device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        entry["memory"] = {"bytes_in_use": total - free, "bytes_limit": total}
    return entry


def _device_alive(device: torch.device) -> bool:
    """Run a one-element computation on ``device``."""
    try:
        x = torch.tensor(2.0, dtype=torch.float32, device=device)
        return float((x * x).item()) == 4.0
    except Exception as exc:  # noqa: BLE001 — a dead device must read as dead, not raise
        logger.error("Device %s failed liveness computation: %s", device, exc)
        return False


def enumerate_devices(
    devices: Optional[Sequence[torch.device]] = None,
    *,
    expected_per_host: int = 0,
    check_liveness: bool = True,
    expected_platform: Optional[str] = None,
) -> Dict[str, Any]:
    """Inventory of this node's devices (default: every GPU) + liveness verdicts.

    ``expected_per_host > 0`` flags a node that enumerates fewer GPUs than
    the deployment demands; ``expected_platform`` (``"cuda"``) flags devices
    on the wrong backend, so a probe measuring the CPU never reports healthy."""
    devices = list(devices if devices is not None else local_devices("cuda"))
    entries: List[Dict[str, Any]] = []
    healthy = 0
    for device in devices:
        entry = _device_entry(device)
        entry["alive"] = _device_alive(device) if check_liveness else None
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
