"""Durable watcher state: last-seen resourceVersion + phase/slice snapshots.

Atomic JSON file writes (write-temp + rename) with throttling so checkpoint
I/O stays off the hot path even at 1 k events/min. A missing or corrupt
checkpoint degrades to a cold start — never a crash.

Cost at scale: a plain flush rewrites the whole JSON — about 4 MB at 10k
tracked pods, about 19 MB at 50k. That whole-state rewrite is fine for the
small sections (resourceVersion, phase/slice snapshots) but not for the
``known_pods`` skeleton map, which dominates the state and whose churn per
throttle window is tiny compared to its size. Large maps therefore go
through :class:`JournaledMapStore` (attach via
``CheckpointStore.attach_journaled_map``): a base snapshot plus an
append-only delta journal, so a steady-state flush costs O(changed
entries), not O(tracked pods). The base is rewritten (compaction) only when
the journal has grown past the size of the map itself, amortizing the
O(state) cost over O(state) appended deltas.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Set

logger = logging.getLogger(__name__)

_SCHEMA_VERSION = 1


def _atomic_write(path: Path, payload: str) -> bool:
    """Write-temp + rename; returns False (after logging) on failure so
    callers can keep their dirty state for a retry."""
    tmp = None
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=path.name, suffix=".tmp")
        with os.fdopen(fd, "w") as fh:
            fh.write(payload)
        os.replace(tmp, path)
        return True
    except OSError as exc:
        logger.error("Atomic write to %s failed: %s", path, exc)
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return False


class JournaledMapStore:
    """Incremental persistence for one large string-keyed map.

    On-disk layout (both under the parent checkpoint's directory):

    - ``<name>.base.json`` — ``{"version": 1, "gen": G, "map": {...}}``,
      written atomically (temp + rename) on compaction;
    - ``<name>.journal.jsonl`` — one JSON object per line,
      ``{"g": G, "k": key, "v": value}`` for an upsert or
      ``{"g": G, "k": key, "d": true}`` for a delete, appended in
      complete lines on each flush.

    Load replays journal lines IN ORDER over the base map (last write
    wins) and stops at the first malformed line — a crash mid-append
    leaves at most one partial trailing line, which is discarded. The
    generation number fences the compaction crash window: a new base is
    renamed into place BEFORE the journal is truncated, so a crash
    between the two leaves stale journal lines whose ``g`` no longer
    matches the base's — they are skipped on load instead of reverting
    newer base values.

    Same contracts as CheckpointStore: values must be replaced, never
    mutated in place (``replace`` keeps the caller's dict by reference);
    serialization happens outside the lock; a corrupt file degrades to a
    cold start, never a crash; no fsync (a lost checkpoint costs a cold
    start, by design).
    """

    def __init__(
        self,
        path_stem: os.PathLike | str,
        *,
        compact_factor: float = 1.0,
        min_compact_entries: int = 2048,
        compact_slice_entries: int = 4096,
    ):
        stem = Path(path_stem)
        self.base_path = stem.with_name(stem.name + ".base.json")
        self.journal_path = stem.with_name(stem.name + ".journal.jsonl")
        # in-progress incremental compaction target; a leftover from a
        # crash is garbage (never loaded) and removed on startup
        self.tmp_path = stem.with_name(stem.name + ".base.json.compacting")
        # compact when journal lines > max(min_compact_entries,
        # compact_factor * len(map)) — the default amortizes one O(state)
        # base rewrite over >= O(state) appended deltas
        self.compact_factor = compact_factor
        self.min_compact_entries = min_compact_entries
        # throttled flushes (CheckpointStore.maybe_flush) serialize at most
        # this many entries of an in-progress compaction per call, bounding
        # the per-flush pause a 50k-entry one-shot compaction would put on
        # the drain thread; slices interleave with normal delta flushes.
        # 0 = one-shot compaction always.
        # Direct flush() calls still complete compaction in full — they are
        # the durability barrier (shutdown, tests).
        self.compact_slice_entries = compact_slice_entries
        self._lock = threading.Lock()
        # serializes flush/compaction I/O: a concurrent append racing a
        # compaction's generation bump would write lines the new fence
        # silently discards on load
        self._io_lock = threading.Lock()
        self._map: Dict[str, Any] = {}
        self._gen = 0
        self._journal_entries = 0
        # keys journaled at next flush; None = full compaction needed
        # (unknown delta, e.g. legacy migration or a replace() without a
        # changed_keys hint)
        self._pending: Optional[Set[str]] = set()
        # in-progress sliced compaction (guarded by _io_lock): dict with
        # gen/snapshot/keys/idx/fh/delta, or None
        self._compacting: Optional[Dict[str, Any]] = None
        # True once this map has EVER held state (a base/journal existed
        # on disk, or replace() ran): distinguishes an empty-but-present
        # map (every key legitimately deleted) from a never-populated one
        # (CheckpointStore.get must fall back to its default only for
        # the latter)
        self._populated = False
        # lock-free stats mirror: a dict REPLACED wholesale (atomic ref
        # swap under the GIL) at every point gen/journal/compaction state
        # changes, so a /debug/checkpoint scrape never blocks on _io_lock
        # behind an in-flight compaction slice
        self._io_shadow: Dict[str, Any] = {
            "generation": 0, "journal_entries": 0, "compacting": None,
        }
        self._load()
        self._publish_io_shadow()  # _load's early returns skip the one inside

    def _load(self) -> None:
        try:
            # a crash mid-compaction leaves a partial target file; it is
            # never read (only the renamed base is), so just reclaim it
            self.tmp_path.unlink()
        except OSError:
            pass
        try:
            data = json.loads(self.base_path.read_text())
            # gen is load-bearing (it fences journal replay): a base whose
            # gen isn't a plain int is corrupt AS A WHOLE — adopting its
            # map with a reset gen would replay the wrong journal lines
            # over it, and int(None/list) raising out of __init__ would
            # crash-loop the watcher instead of degrading (the module
            # contract: cold start, never a crash)
            if (
                isinstance(data, dict)
                and data.get("version") == _SCHEMA_VERSION
                and isinstance(data.get("map"), dict)
                and isinstance(data.get("gen", 0), int)
                and not isinstance(data.get("gen", 0), bool)
            ):
                self._map = data["map"]
                self._gen = data.get("gen", 0)
                self._populated = True
            else:
                logger.warning("Journaled map %s has unknown schema; starting cold", self.base_path)
        except FileNotFoundError:
            pass
        except (json.JSONDecodeError, OSError, ValueError) as exc:
            logger.warning("Corrupt journaled map base %s (%s); starting cold", self.base_path, exc)
        try:
            journal = self.journal_path.read_text()
        except FileNotFoundError:
            return
        except OSError as exc:
            logger.warning("Unreadable journal %s (%s); using base only", self.journal_path, exc)
            return
        for line in journal.splitlines():
            if not line.strip():
                continue
            try:
                entry = json.loads(line)
                if entry.get("g") != self._gen:
                    continue  # stale generation (compaction crash window)
                key = entry["k"]
            except (json.JSONDecodeError, KeyError, TypeError, AttributeError):
                # partial trailing line from a crash mid-append; anything
                # after it is unordered relative to the tear — stop
                logger.warning("Journal %s has a torn line; replay stopped there", self.journal_path)
                break
            self._journal_entries += 1
            self._populated = True
            if entry.get("d"):
                self._map.pop(key, None)
            else:
                self._map[key] = entry.get("v")
        self._publish_io_shadow()

    def _publish_io_shadow(self) -> None:
        """Refresh the lock-free stats mirror. Call from every site that
        mutates gen/journal depth/compaction progress (all run under
        ``_io_lock``, so the build is consistent); readers just grab the
        reference — no lock, no stall behind a compaction slice."""
        comp = self._compacting
        self._io_shadow = {
            "generation": self._gen,
            "journal_entries": self._journal_entries,
            "compacting": (
                {"target_gen": comp["gen"], "written": comp["idx"], "total": len(comp["keys"])}
                if comp is not None
                else None
            ),
        }

    # -- accessors ---------------------------------------------------------

    def current(self) -> Dict[str, Any]:
        """Shallow copy of the live map (same contract as known_pods())."""
        with self._lock:
            return dict(self._map)

    @property
    def populated(self) -> bool:
        """True once the map has ever held state (disk or replace()).
        An empty-but-populated map means "every key deleted" — a real
        answer, distinct from "nothing persisted yet"."""
        with self._lock:
            return self._populated

    def stats(self) -> Dict[str, Any]:
        """Observability snapshot for /debug/checkpoint: generation,
        journal depth, live-map size, and on-disk byte counts.

        Deliberately does NOT take ``_io_lock``: a scrape must never
        stall behind an in-flight compaction slice (a 50k-map rewrite
        holds that lock for tens of ms at a time). It reads the
        ``_io_shadow`` mirror instead — replaced wholesale under
        ``_io_lock`` by every mutator, so one reference read yields an
        internally-consistent (gen, journal depth, compaction progress)
        triple; it can be one flush stale, never torn."""
        shadow = self._io_shadow
        gen = shadow["generation"]
        journal_entries = shadow["journal_entries"]
        compacting = shadow["compacting"]
        with self._lock:
            map_size = len(self._map)
            pending = self._pending
            pending_desc = "full" if pending is None else len(pending)
        def _size(p: Path) -> Optional[int]:
            try:
                return p.stat().st_size
            except OSError:
                return None
        return {
            "generation": gen,
            "journal_entries": journal_entries,
            "pending": pending_desc,
            "map_size": map_size,
            "base_bytes": _size(self.base_path),
            "journal_bytes": _size(self.journal_path),
            "compacting": compacting,
        }

    @property
    def pending(self) -> bool:
        with self._lock:
            if self._pending is None or bool(self._pending):
                return True
        # an in-progress compaction is pending work too: the throttled
        # flusher must keep calling until the new base lands (read without
        # _io_lock — a momentarily stale answer only delays one interval)
        return self._compacting is not None

    def replace(self, new_map: Dict[str, Any], changed_keys: Optional[Iterable[str]] = None) -> None:
        """Adopt ``new_map`` as the live state. ``changed_keys`` is the
        caller's delta hint (keys upserted or deleted since the LAST
        replace); without it the next flush pays a full compaction —
        correct for any caller, incremental only for hinting ones."""
        with self._lock:
            self._map = new_map
            self._populated = True
            if changed_keys is None:
                self._pending = None
            elif self._pending is not None:
                self._pending.update(changed_keys)
            # else: full compaction already pending, which supersedes hints

    # -- persistence -------------------------------------------------------

    def flush(self, finalize: bool = True) -> None:
        """Persist pending deltas. ``finalize=True`` (the default — direct
        calls are the durability barrier: shutdown, tests) also drives any
        in-progress compaction to completion; ``finalize=False`` (the
        throttled ``CheckpointStore.maybe_flush`` path) advances it by at
        most ``compact_slice_entries`` entries, bounding the per-flush
        pause on the ingest drain thread."""
        with self._io_lock:
            self._flush_locked(finalize)

    def _flush_locked(self, finalize: bool = True) -> None:
        with self._lock:
            pending = self._pending
            snapshot = self._map  # entries are never mutated in place
            self._pending = set()
        if self._compacting is not None:
            if pending is None:
                # a newer full rewrite supersedes the half-built target
                self._abort_compaction()
                self._start_compaction(snapshot, finalize)
            else:
                if pending:
                    # journal at the CURRENT gen — the old base + journal
                    # stay the durable truth until the new base lands —
                    # and remember the keys: their values changed after
                    # the compaction snapshot, so the new base needs them
                    # re-journaled under the new gen at finalize
                    if not self._append_journal(pending, snapshot):
                        self._abort_compaction()
                        return
                    self._compacting["delta"].update(pending)
                self._advance_compaction(finalize)
            return
        if pending is None:
            self._start_compaction(snapshot, finalize)
            return
        if not pending:
            return
        # a delta at or past the compaction threshold (>= so a mass change
        # that marked EVERY uid dirty lands here at the default factor of
        # 1.0) would journal ~the whole state and then compact next flush
        # anyway — writing the state up to 3x; compact instead. One-shot
        # (finalize) compaction skips the journal entirely: the new base
        # lands in THIS call. SLICED compaction journals the delta first —
        # its new base lands many throttle windows later, and a crash in
        # between must not revert these keys to their pre-delta values.
        if len(pending) >= max(self.min_compact_entries, self.compact_factor * len(snapshot)):
            if not finalize and self.compact_slice_entries:
                if not self._append_journal(pending, snapshot):
                    return
            self._start_compaction(snapshot, finalize)
            return
        if not self._append_journal(pending, snapshot):
            return
        if self._journal_entries > max(self.min_compact_entries, self.compact_factor * len(snapshot)):
            self._start_compaction(snapshot, finalize)

    def _append_journal(self, pending: Set[str], snapshot: Dict[str, Any]) -> bool:
        """Append ``pending``'s current values as gen-fenced journal lines;
        False (with a forced full rewrite owed) on failure."""
        lines = []
        for key in pending:
            if key in snapshot:
                lines.append(json.dumps({"g": self._gen, "k": key, "v": snapshot[key]}))
            else:
                lines.append(json.dumps({"g": self._gen, "k": key, "d": True}))
        blob = "\n".join(lines) + "\n"
        try:
            self.journal_path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.journal_path, "a") as fh:
                fh.write(blob)  # one write call: a crash tears at most the tail
        except OSError as exc:
            logger.error("Journal append to %s failed: %s", self.journal_path, exc)
            with self._lock:
                # a SURVIVED write error (ENOSPC mid-flush) can leave a
                # torn line in the MIDDLE of the journal; replay stops at
                # the first malformed line, so any append after the tear
                # would be silently discarded on reload. Force a full
                # compaction (new base, truncated journal) instead of
                # retrying appends past the tear.
                self._pending = None
            return False
        self._journal_entries += len(pending)
        self._publish_io_shadow()
        return True

    # -- sliced compaction -------------------------------------------------

    def _start_compaction(self, snapshot: Dict[str, Any], finalize: bool) -> None:
        """One-shot compact when finalizing (or slicing disabled), else
        open the incremental target and write the first slice."""
        if finalize or not self.compact_slice_entries:
            self._compact(snapshot)
            return
        gen = self._gen + 1
        try:
            self.tmp_path.parent.mkdir(parents=True, exist_ok=True)
            fh = open(self.tmp_path, "w")
            fh.write('{"version": %d, "gen": %d, "map": {' % (_SCHEMA_VERSION, gen))
        except OSError as exc:
            logger.error("Could not open compaction target %s: %s", self.tmp_path, exc)
            with self._lock:
                self._pending = None  # still owe the full write
            return
        self._compacting = {
            "gen": gen,
            "snapshot": snapshot,
            "keys": list(snapshot),
            "idx": 0,
            "fh": fh,
            # keys whose value changed after the snapshot was captured;
            # re-journaled under the new gen at finalize so the new base +
            # journal replay to the LIVE state, not the snapshot
            "delta": set(),
        }
        self._publish_io_shadow()
        self._advance_compaction(finalize=False)

    def _abort_compaction(self) -> None:
        comp = self._compacting
        if comp is None:
            return
        self._compacting = None
        self._publish_io_shadow()
        try:
            comp["fh"].close()
        except Exception:  # noqa: BLE001 — best-effort teardown
            pass
        try:
            self.tmp_path.unlink()
        except OSError:
            pass

    def _compaction_failed(self, what: str, exc: Exception) -> None:
        logger.error("Compaction %s for %s failed: %s", what, self.base_path, exc)
        self._abort_compaction()
        with self._lock:
            self._pending = None  # still owe the full write

    def _advance_compaction(self, finalize: bool) -> None:
        """Serialize the next slice (all remaining when ``finalize``) into
        the target file; rename it into place once every entry is down."""
        comp = self._compacting
        keys = comp["keys"]
        idx = comp["idx"]
        end = len(keys) if finalize else min(idx + self.compact_slice_entries, len(keys))
        if end > idx:
            snapshot = comp["snapshot"]
            dumps = json.dumps
            blob = ",".join(dumps(k) + ":" + dumps(snapshot[k]) for k in keys[idx:end])
            if idx > 0:
                blob = "," + blob
            try:
                comp["fh"].write(blob)
            except OSError as exc:
                self._compaction_failed("slice write", exc)
                return
            comp["idx"] = end
            self._publish_io_shadow()
        if comp["idx"] < len(keys):
            return  # more slices on later flushes
        self._finalize_compaction()

    def _finalize_compaction(self) -> None:
        """Close the target, re-journal the during-compaction delta under
        the NEW generation, then rename the base into place.

        Crash ordering (same fence discipline as ``_compact``):
        - after the delta append, before the rename: the old base is still
          in place, its old-gen journal lines replay, the new-gen delta
          lines are fenced out — consistent;
        - after the rename, before the journal rewrite below: old-gen
          lines are fenced out, the new-gen delta lines replay over the
          new base — consistent. The rewrite is space reclamation only.
        """
        comp = self._compacting
        gen = comp["gen"]
        try:
            comp["fh"].write("}}")
            comp["fh"].close()
        except OSError as exc:
            self._compaction_failed("target close", exc)
            return
        with self._lock:
            current = self._map
            delta_entries = [(k, k in current, current.get(k)) for k in comp["delta"]]
        lines = [
            json.dumps({"g": gen, "k": k, "v": v}) if present
            else json.dumps({"g": gen, "k": k, "d": True})
            for k, present, v in delta_entries
        ]
        if lines:
            try:
                with open(self.journal_path, "a") as jfh:
                    jfh.write("\n".join(lines) + "\n")
            except OSError as exc:
                self._compaction_failed("delta append", exc)
                return
        try:
            os.replace(self.tmp_path, self.base_path)
        except OSError as exc:
            # orphaned future-gen delta lines stay in the journal —
            # harmless, the fence skips them on load
            self._compaction_failed("rename", exc)
            return
        self._compacting = None
        self._gen = gen
        self._journal_entries = len(lines)
        self._publish_io_shadow()
        # reclaim the old-gen (now fenced-out) journal lines; atomic so a
        # crash can't tear the delta lines we just made load-bearing
        _atomic_write(self.journal_path, "\n".join(lines) + "\n" if lines else "")

    def _compact(self, snapshot: Dict[str, Any]) -> None:
        """Rewrite the base from ``snapshot`` under a new generation, then
        truncate the journal. Crash between the two: stale journal lines
        carry the old generation and are skipped on load."""
        gen = self._gen + 1
        payload = json.dumps({"version": _SCHEMA_VERSION, "gen": gen, "map": snapshot})
        if not _atomic_write(self.base_path, payload):
            with self._lock:
                self._pending = None  # still owe a full write
            return
        self._gen = gen
        self._journal_entries = 0
        self._publish_io_shadow()
        try:
            open(self.journal_path, "w").close()
        except OSError as exc:
            # harmless: the stale lines are generation-fenced out on load
            logger.warning("Could not truncate journal %s: %s", self.journal_path, exc)


class CheckpointStore:
    def __init__(
        self,
        path: os.PathLike | str,
        *,
        interval_seconds: float = 5.0,
        metrics=None,  # metrics.MetricsRegistry, optional
    ):
        self.path = Path(path)
        self.interval_seconds = interval_seconds
        self.metrics = metrics
        self._lock = threading.Lock()
        self._state: Dict[str, Any] = {"version": _SCHEMA_VERSION}
        self._dirty = False
        self._last_flush = 0.0
        self._last_flush_ms: Optional[float] = None
        self._journaled: Dict[str, JournaledMapStore] = {}
        self._load()

    def stats(self) -> Dict[str, Any]:
        """Observability snapshot for /debug/checkpoint."""
        with self._lock:
            main_keys = sorted(k for k in self._state if k != "version")
            last_flush_age = time.monotonic() - self._last_flush if self._last_flush else None
            last_flush_ms = self._last_flush_ms
        return {
            "path": str(self.path),
            "interval_seconds": self.interval_seconds,
            "last_flush_age_seconds": round(last_flush_age, 1) if last_flush_age is not None else None,
            "last_flush_ms": last_flush_ms,
            "single_file_keys": main_keys,
            "journaled": {key: s.stats() for key, s in self._journaled.items()},
        }

    def attach_journaled_map(self, key: str, **opts: Any) -> JournaledMapStore:
        """Route ``key`` through an incremental :class:`JournaledMapStore`
        (files ``<checkpoint>.<key>.base.json`` / ``.journal.jsonl``).
        ``get``/``put``/``flush`` keep working unchanged for the key; a
        legacy copy inside the single-file state is migrated out on
        attach, so old checkpoints restore seamlessly."""
        store = JournaledMapStore(self.path.with_name(self.path.name + "." + key), **opts)
        with self._lock:
            legacy = self._state.pop(key, None)
            if legacy is not None:
                self._dirty = True
        if not isinstance(legacy, (dict, type(None))):
            # a foreign writer's garbage (string/list/number) must degrade
            # to a cold map, not crash the first get() — same tolerance as
            # the per-entry checks in watch.py
            logger.warning(
                "Discarding malformed legacy %r section during journaled-map migration", key
            )
            legacy = None
        if legacy is not None and not store.populated:
            # migrate only into a NEVER-populated store: an existing
            # journaled map (even one emptied to {}) is newer truth than
            # a stale legacy section
            store.replace(legacy)  # unknown delta -> full compaction on flush
        self._journaled[key] = store
        return store

    def _load(self) -> None:
        try:
            data = json.loads(self.path.read_text())
        except FileNotFoundError:
            return
        except (json.JSONDecodeError, OSError) as exc:
            logger.warning("Corrupt checkpoint %s (%s); starting cold", self.path, exc)
            return
        if isinstance(data, dict) and data.get("version") == _SCHEMA_VERSION:
            self._state = data
        else:
            logger.warning("Checkpoint %s has unknown schema; starting cold", self.path)

    # -- accessors ---------------------------------------------------------

    def resource_version(self) -> Optional[str]:
        with self._lock:
            return self._state.get("resource_version")

    def update_resource_version(self, rv: str) -> None:
        with self._lock:
            self._state["resource_version"] = rv
            self._dirty = True
        self.maybe_flush()

    def get(self, key: str, default: Any = None) -> Any:
        journaled = self._journaled.get(key)
        if journaled is not None:
            # an empty-but-present map is a real answer (every entry was
            # legitimately deleted — e.g. a cluster drained to zero pods);
            # conflating it with "missing" (the old `current() or default`)
            # resurrected the caller's default state after a restart. The
            # default applies only when the map was NEVER populated.
            if journaled.populated:
                return journaled.current()
            return default
        with self._lock:
            return self._state.get(key, default)

    def put(self, key: str, value: Any, *, changed_keys: Optional[Iterable[str]] = None) -> None:
        journaled = self._journaled.get(key)
        if journaled is not None:
            journaled.replace(value, changed_keys=changed_keys)
            self.maybe_flush()
            return
        with self._lock:
            self._state[key] = value
            self._dirty = True
        self.maybe_flush()

    # -- persistence -------------------------------------------------------

    def due(self) -> bool:
        """True when the throttle window has elapsed — callers with expensive
        snapshots should skip building them entirely until this is True."""
        with self._lock:
            return time.monotonic() - self._last_flush >= self.interval_seconds

    def maybe_flush(self) -> None:
        """Flush if dirty and the throttle interval has elapsed. Throttled
        flushes advance an in-progress base compaction by bounded slices
        (``finalize=False``) so the hot path never eats a whole-map
        serialization in one pause."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_flush < self.interval_seconds:
                return
            if not self._dirty and not any(s.pending for s in self._journaled.values()):
                return
        self.flush(finalize=False)

    def flush(self, finalize: bool = True) -> None:
        t0 = time.perf_counter()
        for store in self._journaled.values():
            store.flush(finalize)
        self._flush_main()
        flush_ms = 1e3 * (time.perf_counter() - t0)
        with self._lock:
            self._last_flush_ms = round(flush_ms, 2)
        if self.metrics is not None:
            self.metrics.counter("checkpoint_flushes").inc()
            self.metrics.histogram("checkpoint_flush_duration").record(flush_ms / 1e3)

    def _flush_main(self) -> None:
        with self._lock:
            # shallow copy under the lock, serialize OUTSIDE it: values are
            # replaced wholesale (put/update_resource_version), never
            # mutated in place (known_pods() documents the same contract),
            # so the copy is consistent — and json.dumps of a 10k-pod
            # skeleton map (~4 MB, tens of ms) must not hold the lock the
            # watch loop takes on every event's _save_rv
            snapshot_state = dict(self._state)
            self._dirty = False
            self._last_flush = time.monotonic()
        snapshot = json.dumps(snapshot_state)
        _atomic_write(self.path, snapshot)
