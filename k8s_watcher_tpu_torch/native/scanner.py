"""Watch-frame scanner: native (ctypes → fastscan.cpp) with Python fallback
(the JAX package's ``native/scanner.py``).

``FrameScanner.scan(raw)`` answers, per raw watch frame, without a JSON
parse: the event type, the object's resourceVersion, and whether the
accelerator resource key can possibly be present. The client's watch loop
(k8s/client.py) uses the verdict to skip ``json.loads`` entirely for frames
the TpuResourceFilter would discard anyway — the dominant case in a real
cluster, where most pods request no accelerator.

Correctness contract (both implementations):

- a frame is only skippable when the quoted resource key is ABSENT — key
  presence anywhere (even in a label) just routes to the full-parse path,
  so false positives cost time, never correctness;
- the reported resourceVersion is the first ``"resourceVersion"`` value in
  the frame, which for serialized k8s objects is metadata's own (Go emits
  struct fields in declaration order; managedFields sits later);
- any structural doubt (escapes, missing fields, non-object frame) yields
  ``type=None``/``rv=None`` and the caller full-parses.
"""

from __future__ import annotations

import ctypes
import dataclasses
import logging
import re
from typing import Optional

logger = logging.getLogger(__name__)

_TYPE_RE = re.compile(rb'"type"\s*:\s*"([^"\\]*)"')
_RV_RE = re.compile(rb'"resourceVersion"\s*:\s*"([^"\\]*)"')
# first "uid" value: for serialized k8s objects that is metadata's own
# (same declaration-order argument as resourceVersion above). Consumed by
# the sharded-ingest client-side ownership skip (k8s/client.py): a frame
# whose uid hashes to another shard is dropped pre-parse.
_UID_RE = re.compile(rb'"uid"\s*:\s*"([^"\\]*)"')


@dataclasses.dataclass(frozen=True)
class FrameScan:
    type: Optional[str]  # None = could not tell — full-parse
    resource_version: Optional[str]
    has_key: bool  # True also when in doubt — full-parse
    uid: Optional[str] = None  # None = could not tell — no shard verdict

    # Event types that may be skipped when the key is absent. ERROR and
    # BOOKMARK frames never carry the key but must take the full path (they
    # drive 410 handling and resume bookkeeping in the caller).
    _SKIPPABLE = frozenset({"ADDED", "MODIFIED", "DELETED"})

    @property
    def skippable(self) -> bool:
        return (
            not self.has_key
            and self.type in self._SKIPPABLE
            and self.resource_version is not None
        )

    def foreign_shard(self, shard: int, shards: int) -> bool:
        """True when this frame provably belongs to ANOTHER ingest shard
        (uid extracted, hash owned elsewhere) and is safe to skip as an
        rv-only marker. Doubt (no uid/type/rv) routes to the full parse —
        the watch source's post-parse ownership filter keeps correctness,
        same false-positives-cost-time-never-correctness contract as
        ``skippable``."""
        if shards <= 1 or self.uid is None:
            return False
        from k8s_watcher_tpu_torch.watch.sharded import shard_of

        return (
            self.type in self._SKIPPABLE
            and self.resource_version is not None
            and shard_of(self.uid, shards) != shard
        )


_FULL_PARSE = FrameScan(type=None, resource_version=None, has_key=True)


class PythonFrameScanner:
    """Regex fallback with semantics identical to the native scanner.

    ``extract_uid=False`` (an UNSHARDED stream — ``foreign_shard`` never
    consults the uid there) skips the uid regex on the per-frame path;
    the sharded construction sites opt in."""

    def __init__(self, resource_key: str, *, extract_uid: bool = True):
        self.resource_key = resource_key
        self.extract_uid = extract_uid
        self._quoted_key = f'"{resource_key}"'.encode()

    def scan(self, raw: bytes) -> FrameScan:
        if not raw.lstrip()[:1] == b"{":
            return _FULL_PARSE
        t = _TYPE_RE.search(raw)
        rv = _RV_RE.search(raw)
        uid = _UID_RE.search(raw) if self.extract_uid else None
        return FrameScan(
            type=t.group(1).decode() if t else None,
            resource_version=rv.group(1).decode() if rv else None,
            has_key=self._quoted_key in raw,
            uid=uid.group(1).decode() if uid else None,
        )

    def scan_chunk(self, buf: bytes, shard: Optional[tuple] = None):
        """Split ``buf`` into newline-delimited frames and scan each.

        Returns ``(records, consumed)``: records are
        ``(start, length, rv, count)`` tuples. ``rv is not None`` means the
        record stands for ``count`` consecutive skippable frames whose last
        resume version is ``rv``; ``rv is None`` means ``count == 1`` and
        the caller must full-parse ``buf[start:start+length]``.
        ``buf[consumed:]`` is the incomplete tail to prepend to the next
        chunk.

        ``shard`` (``(i, n)``) adds the uid-hash ownership skip: a frame
        whose extracted uid provably belongs to another ingest shard is
        skippable even when the resource key is present (the owning stream
        delivers it; this one only needs the resume point). No extractable
        uid -> no shard verdict -> full parse (``foreign_shard`` contract).
        """
        records = []
        pos = 0
        n = len(buf)
        while pos < n:
            nl = buf.find(b"\n", pos)
            if nl < 0:
                break
            end = nl
            if end > pos and buf[end - 1] == 0x0D:  # \r
                end -= 1
            if end > pos:
                scan = self.scan(buf[pos:end])
                skip = scan.skippable or (
                    shard is not None and scan.foreign_shard(*shard)
                )
                if skip and records and records[-1][2] is not None:
                    # coalesce the skip-run (rv monotonic: keep the last)
                    start, length, _, count = records[-1]
                    records[-1] = (start, end - start, scan.resource_version, count + 1)
                else:
                    rv = scan.resource_version if skip else None
                    records.append((pos, end - pos, rv, 1))
            pos = nl + 1
        return records, pos


class _FastScanRec(ctypes.Structure):
    _fields_ = [
        ("start", ctypes.c_long),
        ("len", ctypes.c_long),
        ("count", ctypes.c_long),
        ("flags", ctypes.c_int),
        ("type", ctypes.c_char * 32),
        ("rv", ctypes.c_char * 96),
    ]


_CHUNK_RECS = 256  # frames decoded per native call


class NativeFrameScanner:
    """ctypes front-end for the fastscan C ABI."""

    def __init__(self, resource_key: str, lib_path, *, extract_uid: bool = True):
        self.resource_key = resource_key
        self.extract_uid = extract_uid
        self._quoted_key = f'"{resource_key}"'.encode()
        lib = ctypes.CDLL(str(lib_path))
        self._fn = lib.fastscan_frame
        self._fn.restype = ctypes.c_int
        self._fn.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.c_char_p, ctypes.c_long,
            ctypes.c_char_p, ctypes.c_long,
            ctypes.c_char_p, ctypes.c_long,
        ]
        self._type_buf = ctypes.create_string_buffer(64)
        self._rv_buf = ctypes.create_string_buffer(128)
        self._chunk_fn = lib.fastscan_chunk
        self._chunk_fn.restype = ctypes.c_long
        self._chunk_fn.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.c_char_p, ctypes.c_long,
            ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(_FastScanRec), ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
        ]
        self._recs = (_FastScanRec * _CHUNK_RECS)()

    def scan_chunk(self, buf: bytes, shard: Optional[tuple] = None):
        """Batch counterpart of ``scan``: one native call decodes up to
        ``_CHUNK_RECS`` frames; the skip verdict (flags bit 3) — the
        key-absence test AND the ``shard`` uid-hash ownership test (C-side
        crc32, identical to ``shard_of``) — is computed in C so the
        per-skipped-frame Python cost is one flag test. Same return
        contract as ``PythonFrameScanner.scan_chunk``."""
        shard_idx, shards = shard if shard is not None else (0, 0)
        records = []
        base = 0
        view = buf
        while True:
            consumed = ctypes.c_long(0)
            n = self._chunk_fn(
                view, len(view),
                self._quoted_key, len(self._quoted_key),
                shard_idx, shards,
                self._recs, _CHUNK_RECS,
                ctypes.byref(consumed),
            )
            recs = self._recs
            for i in range(n):
                rec = recs[i]
                flags = rec.flags  # -1 (not JSON) has all bits set: test > 0
                if flags > 0 and flags & 8:
                    rec_tuple = (base + rec.start, rec.len, rec.rv.decode(), rec.count)
                    # merge a skip-run continuing across the cap boundary
                    if records and records[-1][2] is not None:
                        pstart, _, _, pcount = records[-1]
                        rec_tuple = (
                            pstart,
                            base + rec.start + rec.len - pstart,
                            rec_tuple[2],
                            pcount + rec.count,
                        )
                        records[-1] = rec_tuple
                        continue
                else:
                    rec_tuple = (base + rec.start, rec.len, None, 1)
                records.append(rec_tuple)
            if consumed.value == 0 or n < _CHUNK_RECS:
                base += consumed.value
                break
            base += consumed.value
            view = buf[base:]
        return records, base

    def scan(self, raw: bytes) -> FrameScan:
        flags = self._fn(
            raw, len(raw),
            self._quoted_key, len(self._quoted_key),
            self._type_buf, ctypes.sizeof(self._type_buf),
            self._rv_buf, ctypes.sizeof(self._rv_buf),
        )
        if flags < 0:
            return _FULL_PARSE
        # uid rides the Python regex on this per-frame path (the C ABI
        # predates shard ingest and extracts only type/rv) — semantics
        # stay IDENTICAL to PythonFrameScanner, which the parity test
        # pins. The chunked hot path never builds FrameScans, so this
        # regex never runs per-frame there.
        uid = _UID_RE.search(raw) if self.extract_uid else None
        return FrameScan(
            type=self._type_buf.value.decode() if flags & 2 else None,
            resource_version=self._rv_buf.value.decode() if flags & 4 else None,
            has_key=bool(flags & 1),
            uid=uid.group(1).decode() if uid else None,
        )


def make_scanner(
    resource_key: str,
    *,
    extract_uid: bool = True,
    mode: str = "auto",
):
    """Scanner for ``resource_key`` per ``mode`` (``ingest.prefilter``):

    - ``auto``  — native when it builds/loads, else Python, one INFO log on
      the downgrade (the default: degradation is expected on hosts without
      a toolchain and must not look like a fault);
    - ``native`` — pinned: the same fallback, but the downgrade logs a
      WARNING (the operator asked for native and is not getting it — the
      analytics backend-pin posture);
    - ``python`` — the pure-Python scanner, no build attempted;
    - ``off``   — None (caller runs the full-parse path).

    NEVER raises: any build/load failure — missing compiler, broken cache
    dir, unloadable object — degrades to ``PythonFrameScanner``.
    ``extract_uid=False`` for unsharded streams skips the per-frame uid
    work nothing would consume.
    """
    if mode == "off":
        return None
    if mode == "python":
        return PythonFrameScanner(resource_key, extract_uid=extract_uid)
    pinned = mode == "native"
    reason = None
    try:
        from k8s_watcher_tpu_torch.native.build import build_fastscan, last_build_error

        lib_path = build_fastscan()
        if lib_path is not None:
            return NativeFrameScanner(resource_key, lib_path, extract_uid=extract_uid)
        reason = last_build_error()
    except Exception as exc:  # noqa: BLE001 — degrade, never kill app start
        reason = str(exc)
    logger.log(
        logging.WARNING if pinned else logging.INFO,
        "native fastscan unavailable (%s)%s; using Python scanner",
        reason or "unknown",
        " — ingest.prefilter pinned to 'native'" if pinned else "",
    )
    return PythonFrameScanner(resource_key, extract_uid=extract_uid)
