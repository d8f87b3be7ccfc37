"""Lazy native build: compile fastscan.cpp into a cached shared object (the
JAX package's ``native/build.py``).

The extension is a plain C ABI loaded via ctypes. The build is a single g++
invocation (``$CXX``, else ``g++``) at first use, cached by source hash in
the port's git-ignored ``k8s_watcher_tpu_torch/_build/`` (override with
``K8S_WATCHER_TPU_NATIVE_CACHE``; ``K8S_WATCHER_TPU_DISABLE_NATIVE`` turns
the build off); any failure
— no compiler, read-only filesystem, broken cache dir, exotic platform —
degrades to the pure-Python scanner, never to an import error and never to
a raise at app start. The operator-facing downgrade log is owned by the
caller (``scanner.make_scanner``: one INFO line on ``auto``, WARNING when
``ingest.prefilter`` pins ``native``); this module records WHY in
``last_build_error()`` and keeps its own logging at DEBUG.
"""

from __future__ import annotations

import hashlib
import logging
import os
import subprocess
import sysconfig
import tempfile
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "fastscan.cpp"
_last_error: Optional[str] = None


def last_build_error() -> Optional[str]:
    """Why the most recent ``build_fastscan`` returned None (or None after
    a success) — surfaced in the caller's single downgrade log line."""
    return _last_error


def _cache_dir() -> Path:
    override = os.environ.get("K8S_WATCHER_TPU_NATIVE_CACHE")
    return Path(override) if override else _SRC.parent.parent / "_build"


def _ext_suffix() -> str:
    return sysconfig.get_config_var("SHLIB_SUFFIX") or ".so"


def _fail(reason: str) -> None:
    global _last_error
    _last_error = reason
    logger.debug("fastscan build unavailable: %s", reason)


def build_fastscan(force: bool = False) -> Optional[Path]:
    """Path to the compiled shared object, building it if needed.

    Returns None when the library cannot be produced (caller falls back to
    the pure-Python scanner). Never raises on build/filesystem failure.
    """
    global _last_error
    if os.environ.get("K8S_WATCHER_TPU_DISABLE_NATIVE"):
        _last_error = "disabled via K8S_WATCHER_TPU_DISABLE_NATIVE"
        return None
    try:
        source = _SRC.read_bytes()
    except OSError as exc:
        _fail(f"source unreadable: {exc}")
        return None
    digest = hashlib.sha256(source).hexdigest()[:16]
    cache = _cache_dir()
    out = cache / f"fastscan-{digest}{_ext_suffix()}"
    if out.exists() and not force:
        _last_error = None
        return out
    compiler = os.environ.get("CXX", "g++")
    try:
        cache.mkdir(parents=True, exist_ok=True)
        # compile to a temp name then os.replace: concurrent builds
        # (several watcher processes starting at once) each win atomically
        with tempfile.NamedTemporaryFile(
            dir=cache, suffix=_ext_suffix(), delete=False
        ) as tmp:
            tmp_path = Path(tmp.name)
        cmd = [
            compiler, "-O3", "-shared", "-fPIC", "-std=c++17",
            "-fno-exceptions", "-fno-rtti",
            str(_SRC), "-o", str(tmp_path),
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            _fail(f"{compiler} failed: {proc.stderr[:500]}")
            tmp_path.unlink(missing_ok=True)
            return None
        os.replace(tmp_path, out)
        logger.info("Built native fastscan: %s", out)
        _last_error = None
        return out
    except (OSError, subprocess.SubprocessError) as exc:
        _fail(str(exc))
        return None
