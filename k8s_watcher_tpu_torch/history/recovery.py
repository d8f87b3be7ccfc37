"""WAL recovery: rebuild the fleet view (and its rv line) from disk (the JAX
package's ``history/recovery.py``).

The contract that makes restart-surviving resume tokens possible:

- **State**: fold every retained segment in order — a ``snap`` record
  replaces the whole state, a ``delta`` record mutates one key — and the
  terminal fold IS the view the process died with (modulo the torn
  tail, which is truncated away).
- **rv continuity**: the recovered ``rv`` is the newest durable rv; the
  restarted view keeps counting from it, so the monotonic rv line spans
  incarnations and a pre-restart token stays meaningful.
- **Instance continuity**: the view's instance id rides every snapshot
  record; recovery re-adopts it, so the ``&view=`` epoch check passes
  across restarts instead of 410ing per incarnation.
- **Journal preload**: the last ``journal_limit`` deltas are handed back
  so the in-memory delta journal (the thing ``read_since`` actually
  serves) starts warm — a token minted before SIGTERM resumes from
  memory exactly as if the process had never died. Tokens older than
  the preloaded journal 410 — the same compaction-horizon semantics as
  steady state, now applied across restarts.

Columnar view core: the recovered ``objects`` dict seeds
``FleetView.restore`` which, on the columnar core, reseeds the store's
columns IN PLACE — pods land in the lazy pending buffer (no O(fleet)
``json.dumps`` on the boot path; the first snapshot-body build pays the
serialization it was going to pay anyway) and the node/cluster interners
keep their codes across the restore, so any cached analytics
materializations stay decodable. The fold order below (snapshot objects,
then deltas in rv order) is exactly the dict-insertion order the dict
core would have ended with, which is what keeps post-restore snapshot
bodies byte-identical across the two cores.

Tear handling: a crash tears at most the tail of the *active* segment
(one buffered write per drain), which the writer truncates on reopen. A
torn *sealed* segment (bit rot, foreign truncation) does not end the
world either: the fold skips the segment's damaged tail and resyncs at
the NEXT segment's opening snapshot — the journal is cleared across the
resync because delta continuity was lost, never silently bridged.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from k8s_watcher_tpu_torch.history.wal import (
    DELTAS,
    FRAME_HEADER,
    MAX_RECORD_BYTES,
    OP_DELETE,
    SNAP,
    decode_record,
    item_object,
    list_segments,
    read_frames,
    record_items,
)

logger = logging.getLogger(__name__)


class RecoveredState(NamedTuple):
    """Everything a restarted view needs from the WAL."""

    instance: Optional[str]  # None on a cold (empty) WAL
    rv: int
    objects: Dict[Tuple[str, str], Dict[str, Any]]
    journal: List[Dict[str, Any]]  # delta records, rv-ascending, tail only
    #: seq -> (first_rv, last_rv, records) for the segment inventory
    segment_rvs: Dict[int, Tuple[int, int, int]]
    segments: int
    truncated_bytes: int  # torn tail removed from the active segment
    #: True iff the WAL ends in the terminal snapshot a clean close()
    #: writes (and nothing tore anywhere). An UNCLEAN end means deltas
    #: acked to subscribers beyond the durable rv may have been lost —
    #: the serve plane must then mint a FRESH view instance so
    #: pre-crash resume tokens 410 into a re-snapshot instead of
    #: silently grafting onto a re-minted (divergent) rv line.
    clean: bool


def _fold_records(
    records,
    state: Dict[Tuple[str, str], Dict[str, Any]],
    journal,  # deque(maxlen=journal_limit) — the tail bound is the deque's
    rv: int,
    instance: Optional[str],
) -> Tuple[int, Optional[str]]:
    """Fold one segment's records into (state, journal); returns the
    updated (rv, instance)."""
    for record in records:
        rtype = record.get("t")
        if rtype == SNAP:
            snap_rv = int(record.get("rv", 0))
            state.clear()
            for entry in record.get("objects", ()):  # [[kind, key, obj], ...]
                try:
                    kind, key, obj = entry
                except (TypeError, ValueError):
                    continue
                state[(str(kind), str(key))] = obj
            if snap_rv != rv:
                # a rebase (overrun hole) or a resync after a torn sealed
                # segment: delta continuity across this point is gone, so
                # the preloaded journal must not bridge it
                journal.clear()
            rv = snap_rv
            instance = record.get("instance") or instance
        elif rtype == DELTAS:
            for item in record_items(record):
                try:
                    delta_rv, kind, key, op, obj = item
                    delta_rv = int(delta_rv)
                    obj = item_object(obj)
                except (TypeError, ValueError):
                    continue
                if delta_rv <= rv and rv:
                    # replay of an already-folded rv — idempotent skip
                    continue
                if rv and delta_rv != rv + 1:
                    # an rv hole (overrun rebase without a provider, or a
                    # damaged record skipped upstream): the journal must
                    # stay contiguous — resume continuity across the hole
                    # is gone
                    journal.clear()
                kind = str(kind)
                key = str(key)
                if op == OP_DELETE:
                    state.pop((kind, key), None)
                    obj = None
                else:
                    state[(kind, key)] = obj
                rv = delta_rv
                journal.append({"rv": delta_rv, "kind": kind, "key": key, "op": op, "object": obj})
        # unknown record types are skipped (forward compatibility)
    return rv, instance


def journal_deltas(journal_records: List[Dict[str, Any]]):
    """Recovered journal records -> the ``serve.view.Delta`` tuples the
    in-memory journal preloads. Monotonic ``t`` stamps are re-minted at
    boot (monotonic clocks don't survive restarts); the wall stamps stay
    in the WAL for forensics."""
    from k8s_watcher_tpu_torch.serve.view import Delta

    now_monotonic = time.monotonic()
    return [
        Delta(
            int(r.get("rv", 0)),
            str(r.get("kind", "")),
            str(r.get("key", "")),
            "DELETE" if r.get("op") == OP_DELETE else "UPSERT",
            None if r.get("op") == OP_DELETE else r.get("object"),
            now_monotonic,
        )
        for r in journal_records
    ]


def _first_rv(records, fallback: int) -> int:
    """The first rv a segment's records cover (its opening snapshot's rv
    in the normal layout; the first delta's for a headless segment)."""
    for record in records:
        if record.get("t") == SNAP:
            return int(record.get("rv", fallback))
        if record.get("t") == DELTAS:
            items = record_items(record) or ()
            if items:
                try:
                    return int(items[0][0])
                except (TypeError, ValueError, IndexError):
                    continue
    return fallback


def recover_state(
    directory: Path | str,
    *,
    journal_limit: int = 8192,
    truncate_tail: bool = False,
) -> RecoveredState:
    """Fold every retained segment; optionally truncate the ACTIVE
    (last) segment's torn tail in place (the writer-owned open path —
    read-only consumers like replay leave files untouched)."""
    import collections

    directory = Path(directory)
    segments = list_segments(directory)
    state: Dict[Tuple[str, str], Dict[str, Any]] = {}
    # maxlen deque: a full WAL folds millions of deltas, and a list-based
    # tail trim (del [:1] per delta past the limit) would make boot
    # recovery quadratic
    journal: collections.deque = collections.deque(maxlen=max(1, journal_limit))
    segment_rvs: Dict[int, Tuple[int, int, int]] = {}
    rv = 0
    instance: Optional[str] = None
    truncated = 0
    torn_any = False
    last_record_type: Optional[str] = None
    last_snap_rv = -1
    for index, (seq, path) in enumerate(segments):
        try:
            data = path.read_bytes()
        except OSError as exc:
            logger.warning("Unreadable WAL segment %s (%s); skipping", path, exc)
            continue
        records, clean_bytes, torn = read_frames(data)
        if torn:
            torn_any = True
            if index == len(segments) - 1:
                if truncate_tail:
                    try:
                        with open(path, "r+b") as fh:
                            fh.truncate(clean_bytes)
                        truncated = len(data) - clean_bytes
                        logger.warning(
                            "Truncated %dB torn tail off WAL segment %s",
                            truncated, path,
                        )
                    except OSError as exc:
                        logger.error("Could not truncate torn WAL tail %s: %s", path, exc)
            else:
                # a damaged SEALED segment: fold its clean prefix; the
                # next segment's opening snapshot resyncs (and clears the
                # journal — continuity was lost here)
                logger.warning(
                    "WAL segment %s is torn mid-chain (%d clean of %d bytes); "
                    "resyncing at the next segment's snapshot",
                    path, clean_bytes, len(data),
                )
        rvs_before = rv
        rv, instance = _fold_records(records, state, journal, rv, instance)
        if records:
            segment_rvs[seq] = (_first_rv(records, rvs_before), rv, len(records))
            last = records[-1]
            last_record_type = last.get("t")
            # only the FINAL-flagged terminal snapshot counts as a clean
            # end: a rotation/rebase snapshot as the last record means
            # the process died right after writing it — acked deltas may
            # still have been lost
            last_snap_rv = (
                int(last.get("rv", -1))
                if last_record_type == SNAP and last.get("final")
                else -1
            )
    return RecoveredState(
        instance=instance,
        rv=rv,
        objects=state,
        journal=list(journal),
        segment_rvs=segment_rvs,
        segments=len(segments),
        truncated_bytes=truncated,
        # clean close() leaves a terminal snapshot as the very last
        # record, at exactly the final rv, with nothing torn anywhere
        clean=(not torn_any and last_record_type == SNAP and last_snap_rv == rv),
    )


def _peek_first_record(path: Path):
    """Read just the first framed record of a segment (its opening
    snapshot, in the normal layout) — the cheap seek primitive
    ``reconstruct_at`` uses to skip whole segments."""
    import zlib

    try:
        with open(path, "rb") as fh:
            header = fh.read(FRAME_HEADER.size)
            if len(header) < FRAME_HEADER.size:
                return None
            length, crc = FRAME_HEADER.unpack(header)
            if length == 0 or length > MAX_RECORD_BYTES:
                return None
            payload = fh.read(length)
            if len(payload) < length or zlib.crc32(payload) & 0xFFFFFFFF != crc:
                return None
    except OSError:
        return None
    record = decode_record(payload)
    return record if isinstance(record, dict) else None


def reconstruct_at(directory: Path | str, at_rv: int):
    """Time travel: the fleet state as of exactly ``at_rv``.

    Returns ``(status, rv, objects)``:

    - ``("ok", at_rv, state)`` — folded from the newest snapshot at or
      before ``at_rv`` plus the deltas up to it;
    - ``("gone", anchor_rv, None)`` — ``at_rv`` is not reconstructible:
      it precedes the retention horizon OR sits inside a hole (overrun
      rebase / tear resync). ``anchor_rv`` is a reconstructible rv to
      re-anchor at (the retention floor, or the snapshot past the hole);
    - ``("future", newest_rv, None)`` — ``at_rv`` is past everything
      durable (the caller distinguishes "not yet flushed" from "never").
    """
    directory = Path(directory)
    segments = list_segments(directory)
    state: Dict[Tuple[str, str], Dict[str, Any]] = {}
    rv = 0
    floor: Optional[int] = None
    reached = False
    # seek: every segment opens with a full snapshot, so the fold can
    # start at the NEWEST segment whose opening snapshot is <= at_rv
    # instead of decoding the entire retained WAL on a serve handler
    # thread per ?at= query. The
    # peeks also yield the true retention floor (oldest opening snap).
    start_idx = 0
    peeks = [_peek_first_record(path) for _seq, path in segments]
    for record in peeks:
        if record is not None and record.get("t") == SNAP:
            floor = int(record.get("rv", 0))
            break
    for i in range(len(segments) - 1, -1, -1):
        record = peeks[i]
        if (
            record is not None
            and record.get("t") == SNAP
            and int(record.get("rv", 0)) <= at_rv
        ):
            start_idx = i
            break
    for _seq, path in segments[start_idx:]:
        try:
            data = path.read_bytes()
        except OSError:
            continue
        records, _clean, _torn = read_frames(data)
        for record in records:
            rtype = record.get("t")
            if rtype == SNAP:
                snap_rv = int(record.get("rv", 0))
                if floor is None:
                    floor = snap_rv
                if snap_rv > at_rv:
                    # overshoot. The fold is the at_rv state ONLY when it
                    # stands exactly at at_rv: the rv line is dense, so a
                    # jump from rv < at_rv straight to snap_rv > at_rv
                    # means at_rv sits inside a HOLE (overrun rebase /
                    # tear resync) — serving the older state as
                    # "historical at at_rv" would be silently wrong data
                    # on the exact forensic surface built for postmortems
                    if reached and rv == at_rv:
                        return ("ok", at_rv, state)
                    return ("gone", floor if not reached else snap_rv, None)
                state.clear()
                for entry in record.get("objects", ()):
                    try:
                        kind, key, obj = entry
                    except (TypeError, ValueError):
                        continue
                    state[(str(kind), str(key))] = obj
                rv = snap_rv
                reached = rv <= at_rv
            elif rtype == DELTAS:
                for item in record_items(record):
                    try:
                        delta_rv, kind, key, op, obj = item
                        delta_rv = int(delta_rv)
                        obj = item_object(obj)
                    except (TypeError, ValueError):
                        continue
                    if delta_rv <= rv and rv:
                        continue
                    if delta_rv > at_rv:
                        # dense-line overshoot means rv == at_rv (the ok
                        # case); rv < at_rv here implies delta_rv > rv+1,
                        # i.e. at_rv sits inside a failed-write hole
                        if rv == at_rv:
                            return ("ok", at_rv, state)
                        return ("gone", delta_rv, None)
                    if op == OP_DELETE:
                        state.pop((str(kind), str(key)), None)
                    else:
                        state[(str(kind), str(key))] = obj
                    rv = delta_rv
                    reached = True
    if not reached:
        return ("gone", floor if floor is not None else 0, None)
    if rv < at_rv:
        return ("future", rv, None)
    return ("ok", at_rv, state)
