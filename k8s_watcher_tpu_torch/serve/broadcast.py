"""Epoll broadcast core: the serving plane's streaming data plane (the JAX
package's ``serve/broadcast.py``).

The HTTP front does the handshake of a ``?watch=1`` stream (request parse,
bearer auth, pre-stream 410 checks, response headers) on its per-connection
thread, then hands the socket off non-blocking to one of a small fixed pool
of ``selectors`` loops (``serve.io_threads``). From there:

- **One wakeup per publish.** The view calls each loop's ``wake`` once per
  applied publish (a self-pipe byte, coalesced while one is pending). The
  loop walks only subscribers with pending deltas.
- **Encode-once delivery.** A pull returns the publish-time frame bytes
  (``FleetView.read_frames_since``); delivering a delta appends the SHARED
  bytes object to the subscriber's outbound buffer. Only the small
  SYNC/COMPACTED/GONE control frames are made here.
- **Backpressure, not blocked threads.** A slow client's unsent bytes sit in
  its bounded buffer (``serve.sub_buffer_bytes``); partial writes resume
  from the kernel-accepted offset when the socket turns writable. Over
  budget, the loop stops pulling for it: its cursor lags into the view's
  read-time latest-wins compaction (or 410 past the horizon).
- **Liveness.** SYNC heartbeats keep idle streams' resume tokens fresh; a
  peer close frees the subscriber slot at once; the watch window's deadline
  closes a stream with a final SYNC and the terminal chunk.

``serve_loop_lag_seconds`` gauges wake-to-service latency;
``serve_fanout_bytes`` counts bytes queued to subscribers.
"""

from __future__ import annotations

import logging
import os
import selectors
import socket
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Union

from k8s_watcher_tpu_torch.serve.view import (
    CODEC_JSON,
    GONE,
    OK,
    FleetView,
    Subscription,
    SubscriptionHub,
    chunk_frame,
)

logger = logging.getLogger(__name__)

#: chunked-transfer end-of-body marker — the clean close of a stream
TERMINAL_CHUNK = b"0\r\n\r\n"
#: idle heartbeat cadence (mirrors the threaded front's SYNC contract)
SYNC_INTERVAL_SECONDS = 2.0
#: a closing client gets this long to drain its final bytes before the
#: socket is torn down anyway (a dead peer must not pin a slot forever)
DRAIN_GRACE_SECONDS = 10.0
#: selector timeout ceiling: timers (SYNC, deadlines) are checked at
#: least this often even with no IO and no publishes
MAX_SELECT_SECONDS = 0.5
#: timer-sweep throttle: the O(clients) SYNC/deadline walk runs at most
#: this often (timer contracts are seconds-scale), so high-rate publish
#: iterations don't pay it each
TIMER_SWEEP_SECONDS = 0.1


class _StreamClient:
    """One handed-off watch stream: socket + cursor + outbound buffer."""

    __slots__ = (
        "sock", "fd", "sub", "limit", "deadline", "hard_deadline",
        "last_frame", "buf", "buf_bytes", "closing", "view_id",
        "want_write", "codec", "fresh", "traced",
    )

    def __init__(
        self,
        sock: socket.socket,
        sub: Subscription,
        *,
        deadline: float,
        limit: Optional[int],
        view_id: str,
        codec: str = CODEC_JSON,
        fresh: bool = False,
        traced: bool = False,
    ):
        self.sock = sock
        self.fd = sock.fileno()
        self.sub = sub
        self.limit = limit
        self.deadline = deadline
        self.hard_deadline = deadline + DRAIN_GRACE_SECONDS
        self.last_frame = time.monotonic()
        # outbound buffer: bytes objects are SHARED frame bytes (never
        # mutated); a partial write replaces the head with a memoryview
        # suffix — zero-copy resume from the kernel-accepted offset
        self.buf: Deque[Union[bytes, memoryview]] = deque()
        self.buf_bytes = 0
        self.closing = False  # terminal bytes queued; close once drained
        self.view_id = view_id
        self.want_write = False
        # negotiated wire codec: frames pulled (and control frames
        # synthesized) in this codec; the per-codec frame arrays are
        # shared across every subscriber on the same codec
        self.codec = codec
        # negotiated freshness stamps (?fresh=1): pulls select the
        # stamped frame variant; control frames never carry stamps
        self.fresh = fresh
        # negotiated trace forwarding (?trace=1): pulls select the
        # trace-forwarding frame variant (always stamped)
        self.traced = traced


class _LoopWorker(threading.Thread):
    """One selector loop: owns a disjoint subset of handed-off sockets."""

    def __init__(self, loop: "BroadcastLoop", index: int):
        super().__init__(name=f"serve-io-{index}", daemon=True)
        self.loop = loop
        self.selector = selectors.DefaultSelector()
        self._rpipe, self._wpipe = os.pipe()
        os.set_blocking(self._rpipe, False)
        os.set_blocking(self._wpipe, False)
        self.selector.register(self._rpipe, selectors.EVENT_READ, None)
        self._inbox: Deque[_StreamClient] = deque()
        self._inbox_lock = threading.Lock()
        self._clients: Dict[int, _StreamClient] = {}
        self._running = True
        self._closed = False  # pipes torn down; wake() must not write
        # wake coalescing: publishes while a wake is already pending
        # don't write another pipe byte (GIL-atomic flag flips)
        self._wake_pending = False
        self._notify_t = 0.0
        # pump scheduling state: the last view rv a full walk serviced,
        # plus fds needing a pull regardless (fresh admissions, buffers
        # that just drained below budget)
        self._pumped_rv = -1
        self._needs_pull: set = set()
        # timer scheduling: O(1) select timeouts off a cached next-due
        # stamp maintained by the (throttled) timer sweep
        self._next_due = float("inf")
        self._last_timer_sweep = 0.0

    # -- cross-thread surface (publish hook / HTTP handler threads) -------

    def wake(self, stamp: float = 0.0) -> None:
        if self._closed:
            return  # torn down: the write fd may have been REUSED by
            # another open — writing would corrupt whatever owns it now
        if stamp and not self._notify_t:
            self._notify_t = stamp
        if not self._wake_pending:
            self._wake_pending = True
            try:
                os.write(self._wpipe, b"x")
            except (BlockingIOError, OSError):
                pass  # pipe full = a wake is already queued

    def submit(self, client: _StreamClient) -> None:
        with self._inbox_lock:
            self._inbox.append(client)
        self.wake()

    @property
    def client_count(self) -> int:
        return len(self._clients)

    def stop(self) -> None:
        self._running = False
        self.wake()

    # -- loop internals (single-threaded from here down) -------------------

    def run(self) -> None:
        try:
            self._run_loop()
        except Exception:  # noqa: BLE001 — a dead loop must be loud
            logger.exception("Broadcast loop %s died", self.name)
        finally:
            self._teardown()

    def _run_loop(self) -> None:
        while self._running:
            events = self.selector.select(self._select_timeout())
            now = time.monotonic()
            woke = False
            for key, mask in events:
                if key.data is None:
                    woke = True
                    continue
                client = key.data
                if mask & selectors.EVENT_READ:
                    self._on_readable(client)
                if mask & selectors.EVENT_WRITE and client.fd in self._clients:
                    self._flush(client)
            if woke:
                # drain FIRST, clear the flag after: a wake landing
                # between the two either finds the flag still True (its
                # publish is serviced by THIS iteration's pump, which
                # reads view.rv below) or writes a fresh byte select
                # returns on. The reverse order could eat a byte written
                # under a True flag and strand the flag True forever —
                # silently degrading every future wake to the 0.5 s
                # select-timeout poll.
                try:
                    while os.read(self._rpipe, 4096):
                        pass
                except (BlockingIOError, OSError):
                    pass
                self._wake_pending = False
                stamp, self._notify_t = self._notify_t, 0.0
                if stamp and self.loop.lag_gauge is not None:
                    self.loop.lag_gauge.set(time.monotonic() - stamp)
            self._admit()
            self._pump()
            self._timers(time.monotonic())

    def _select_timeout(self) -> float:
        # O(1): the timer sweep caches the earliest due stamp; the
        # MAX_SELECT ceiling bounds how stale it can go (a client
        # admitted after a sweep introduces no due sooner than
        # SYNC_INTERVAL anyway). A due stamp inside the sweep-throttle
        # window waits for the window — a timer can fire at most
        # TIMER_SWEEP_SECONDS late, and a due the throttle would skip
        # must not spin select at timeout 0 until the window opens.
        wake_at = max(self._next_due, self._last_timer_sweep + TIMER_SWEEP_SECONDS)
        return max(0.0, min(MAX_SELECT_SECONDS, wake_at - time.monotonic()))

    def _admit(self) -> None:
        while True:
            with self._inbox_lock:
                if not self._inbox:
                    return
                client = self._inbox.popleft()
            try:
                client.sock.setblocking(False)
                self.selector.register(client.sock, selectors.EVENT_READ, client)
            except (OSError, ValueError, KeyError):
                # socket already dead on arrival
                self._drop(client, registered=False)
                continue
            self._clients[client.fd] = client
            self._needs_pull.add(client.fd)  # pull pre-admission backlog
            # opening SYNC carries the resume token (threaded-front parity)
            self._queue_control(
                client,
                {"type": "SYNC", "rv": client.sub.rv, "view": client.view_id},
            )
            self._flush(client)

    def _pump(self) -> None:
        """Deliver pending deltas. A full walk (skipping caught-up and
        over-budget subscribers in O(1) each) runs only when the view rv
        advanced since the last pump — an idle iteration pumps just the
        ``_needs_pull`` stragglers (fresh admissions, buffers that
        drained back below budget), so no-publish wakeups cost
        O(changed), not O(subscribers)."""
        if not self._clients:
            self._needs_pull.clear()
            return
        view_rv = self.loop.view.rv  # one lock acquisition per pump
        if view_rv != self._pumped_rv:
            self._pumped_rv = view_rv
            targets = list(self._clients.values())
        elif self._needs_pull:
            targets = [
                self._clients[fd] for fd in self._needs_pull if fd in self._clients
            ]
        else:
            return
        self._needs_pull.clear()
        budget = self.loop.sub_buffer_bytes
        instance = self.loop.view.instance
        for client in targets:
            if client.closing or client.buf_bytes >= budget:
                # over budget: stop pulling — the cursor lags and the
                # NEXT pull rides read-time latest-wins compaction
                continue
            if client.view_id != instance:
                # a relay re-adopted its upstream under this stream: the old
                # cursor means nothing in the new rv space, so end with GONE
                self._queue_control(client, {"type": "GONE", "rv": client.sub.rv, "view": instance})
                self._finish(client)
                continue
            if client.sub.rv >= view_rv:
                continue
            result = client.sub.pull_frames(
                limit=client.limit, codec=client.codec, fresh=client.fresh,
                traced=client.traced,
            )
            if result.status == GONE:
                self._queue_control(
                    client,
                    {"type": "GONE", "rv": result.from_rv,
                     "oldest_rv": self.loop.view.oldest_rv},
                )
                self._finish(client)
            elif result.status != OK:
                # INVALID mid-stream = the view restarted under us; the
                # client's documented recovery is the same re-snapshot
                self._queue_control(
                    client,
                    {"type": "GONE", "rv": result.from_rv,
                     "view": self.loop.view.instance},
                )
                self._finish(client)
            elif result.frames:
                if result.compacted:
                    self._queue_control(
                        client,
                        {"type": "COMPACTED", "from_rv": result.from_rv,
                         "to_rv": result.to_rv},
                    )
                self._queue_frames(client, result.frames)
                client.last_frame = time.monotonic()
            elif result.compacted:
                # a sparse relay journal: the cursor moved over a sanctioned
                # hole with nothing to send. COMPACTED sanctions the range and
                # the SYNC moves the resume token past it, or the next delta
                # would read as a gap downstream
                self._queue_control(
                    client, {"type": "COMPACTED", "from_rv": result.from_rv, "to_rv": result.to_rv})
                self._queue_control(client, {"type": "SYNC", "rv": client.sub.rv, "view": client.view_id})
                client.last_frame = time.monotonic()
            self._flush(client)

    def _timers(self, now: float) -> None:
        # throttled full sweep: timers here have seconds-scale contracts
        # (2 s SYNC cadence, multi-second windows), so sweeping at most
        # every TIMER_SWEEP_SECONDS keeps high-rate publish iterations
        # from paying an O(subscribers) walk each. The sweep also
        # recomputes the cached next-due stamp _select_timeout reads.
        if now - self._last_timer_sweep < TIMER_SWEEP_SECONDS:
            return
        self._last_timer_sweep = now
        next_due = float("inf")
        instance = self.loop.view.instance
        for client in list(self._clients.values()):
            if not client.closing and client.view_id != instance:
                # an idle stream learns of a relay re-adopt here (the pump
                # walks only streams with pending deltas)
                self._queue_control(client, {"type": "GONE", "rv": client.sub.rv, "view": instance})
                self._finish(client)
                if client.fd not in self._clients:
                    continue
            if client.closing:
                if now >= client.hard_deadline:
                    # peer never drained its final bytes: tear down
                    self._drop(client)
                else:
                    next_due = min(next_due, client.hard_deadline)
                continue
            if now >= client.deadline:
                # clean window end: final SYNC carries the resume token
                self._queue_control(
                    client,
                    {"type": "SYNC", "rv": client.sub.rv, "view": client.view_id},
                )
                self._finish(client)
                if client.fd in self._clients:
                    next_due = min(next_due, client.hard_deadline)
                continue
            if now - client.last_frame >= SYNC_INTERVAL_SECONDS and not client.buf:
                # heartbeat only truly idle streams: a client with bytes
                # still buffered is stalled, not idle — another SYNC
                # would just grow the backlog it is failing to drain
                self._queue_control(
                    client,
                    {"type": "SYNC", "rv": client.sub.rv, "view": client.view_id},
                )
                client.last_frame = now
                self._flush(client)
                if client.fd not in self._clients:
                    continue
            next_due = min(next_due, client.deadline)
            if not client.buf:
                # stalled clients (bytes pending) contribute no SYNC due:
                # writability, not a clock, unblocks them — a past-due
                # stamp they can never clear would spin the select
                next_due = min(next_due, client.last_frame + SYNC_INTERVAL_SECONDS)
        self._next_due = next_due

    # -- client plumbing ---------------------------------------------------

    def _queue_frames(self, client: _StreamClient, frames: List[bytes]) -> None:
        total = 0
        for frame in frames:
            client.buf.append(frame)
            total += len(frame)
        client.buf_bytes += total
        if self.loop.fanout_bytes is not None:
            self.loop.fanout_bytes.inc(total)

    def _queue_control(self, client: _StreamClient, obj: dict) -> None:
        frame = chunk_frame(obj, client.codec)
        client.buf.append(frame)
        client.buf_bytes += len(frame)
        if self.loop.fanout_bytes is not None:
            self.loop.fanout_bytes.inc(len(frame))

    def _finish(self, client: _StreamClient) -> None:
        """Queue the chunked terminal and close once the buffer drains."""
        client.buf.append(TERMINAL_CHUNK)
        client.buf_bytes += len(TERMINAL_CHUNK)
        client.closing = True
        client.hard_deadline = time.monotonic() + DRAIN_GRACE_SECONDS
        self._flush(client)

    def _flush(self, client: _StreamClient) -> None:
        if client.fd not in self._clients:
            return
        while client.buf:
            head = client.buf[0]
            try:
                n = client.sock.send(head)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._drop(client)
                return
            client.buf_bytes -= n
            if n < len(head):
                # kernel buffer full mid-frame: keep the unsent suffix as
                # a memoryview (zero-copy — the underlying bytes object is
                # the shared frame) and resume on the next writable event
                view = head if isinstance(head, memoryview) else memoryview(head)
                client.buf[0] = view[n:]
                break
            client.buf.popleft()
        self._set_write_interest(client, bool(client.buf))
        if not client.buf and client.closing:
            self._drop(client)
        elif (
            not client.closing
            and client.buf_bytes < self.loop.sub_buffer_bytes
            and client.sub.rv < self._pumped_rv
        ):
            # back under budget with deltas still pending: re-arm a pull
            # even if no new publish advances the view meanwhile
            self._needs_pull.add(client.fd)

    def _set_write_interest(self, client: _StreamClient, want: bool) -> None:
        if want == client.want_write or client.fd not in self._clients:
            return
        events = selectors.EVENT_READ
        if want:
            events |= selectors.EVENT_WRITE
        try:
            self.selector.modify(client.sock, events, client)
            client.want_write = want
        except (OSError, ValueError, KeyError):
            self._drop(client)

    def _on_readable(self, client: _StreamClient) -> None:
        # nothing legitimate arrives on an established watch stream;
        # readable means the peer closed (EOF) or reset — either way the
        # subscriber slot and cursor are freed NOW, not at window end
        try:
            data = client.sock.recv(4096)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop(client)
            return
        if not data:
            self._drop(client)
        # stray request bytes on a watch stream are ignored (a stream is
        # not a keep-alive conversation; it ends by close)

    def _drop(self, client: _StreamClient, *, registered: bool = True) -> None:
        if registered:
            self._clients.pop(client.fd, None)
            try:
                self.selector.unregister(client.sock)
            except (OSError, ValueError, KeyError):
                pass
        try:
            client.sock.close()
        except OSError:
            pass
        self.loop.hub.unsubscribe(client.sub)

    def _teardown(self) -> None:
        # refuse wakes BEFORE closing the pipe fds: a publish racing the
        # close could otherwise os.write() into whatever file/socket the
        # kernel hands the recycled fd number to next
        self._closed = True
        for client in list(self._clients.values()):
            self._drop(client)
        with self._inbox_lock:
            stranded = list(self._inbox)
            self._inbox.clear()
        for client in stranded:
            self._drop(client, registered=False)
        try:
            self.selector.unregister(self._rpipe)
        except (OSError, ValueError, KeyError):
            pass
        self.selector.close()
        for fd in (self._rpipe, self._wpipe):
            try:
                os.close(fd)
            except OSError:
                pass


class BroadcastLoop:
    """The fixed pool of loop workers behind the serving plane's streams.

    Sockets are assigned round-robin at handoff; every publish wakes
    each worker once (coalesced). ``serve.io_threads`` sizes the pool —
    one loop drives thousands of streams (the work per publish is
    appends + sends), more loops spread send() syscall load across
    cores for very wide fleets.
    """

    def __init__(
        self,
        view: FleetView,
        hub: SubscriptionHub,
        *,
        threads: int = 1,
        sub_buffer_bytes: int = 1 << 20,
        metrics=None,
    ):
        self.view = view
        self.hub = hub
        self.sub_buffer_bytes = max(4096, int(sub_buffer_bytes))
        self.fanout_bytes = (
            metrics.counter("serve_fanout_bytes") if metrics is not None else None
        )
        self.lag_gauge = (
            metrics.gauge("serve_loop_lag_seconds") if metrics is not None else None
        )
        self._workers = [_LoopWorker(self, i) for i in range(max(1, int(threads)))]
        self._next = 0
        self._started = False
        view.register_wakeup(self.notify)

    def start(self) -> "BroadcastLoop":
        if not self._started:
            self._started = True
            for worker in self._workers:
                worker.start()
        return self

    def stop(self) -> None:
        # stop NOTIFYING before stopping workers: publishes keep flowing
        # during app shutdown, and a notify after the workers close their
        # pipes would write into recycled fds
        self._started = False
        self.view.unregister_wakeup(self.notify)
        for worker in self._workers:
            worker.stop()
        for worker in self._workers:
            worker.join(timeout=2.0)

    def notify(self) -> None:
        """The view's post-publish wakeup: one self-pipe byte per worker
        (coalesced while one is pending) — never a per-subscriber wake."""
        if not self._started:
            return
        stamp = time.monotonic()
        for worker in self._workers:
            worker.wake(stamp)

    def submit(
        self,
        sock: socket.socket,
        sub: Subscription,
        *,
        timeout: float,
        limit: Optional[int],
        view_id: str,
        codec: str = CODEC_JSON,
        fresh: bool = False,
        traced: bool = False,
    ) -> None:
        """Adopt a handed-off socket (headers already written by the HTTP
        front). The loop owns the socket AND the subscription from here —
        including unsubscribe on every exit path."""
        client = _StreamClient(
            sock, sub,
            deadline=time.monotonic() + timeout,
            limit=limit,
            view_id=view_id,
            codec=codec,
            fresh=fresh,
            traced=traced,
        )
        # round-robin across LIVE workers only: a dead loop's inbox is a
        # black hole (stream never admitted, slot never freed) — the
        # HTTP front refuses handoff when no worker is alive, so a raise
        # here is the narrow race between that check and this one
        n = len(self._workers)
        for offset in range(n):
            worker = self._workers[(self._next + offset) % n]
            if worker.is_alive():
                self._next += offset + 1
                worker.submit(client)
                return
        raise RuntimeError("no live broadcast loop worker")

    @property
    def alive(self) -> bool:
        """Fully healthy: every worker running (the /healthz verdict)."""
        return self._started and all(w.is_alive() for w in self._workers)

    @property
    def accepting(self) -> bool:
        """Able to adopt new streams: at least one live worker (submit
        skips dead ones) — degraded-but-serving is still serving."""
        return self._started and any(w.is_alive() for w in self._workers)

    @property
    def threads(self) -> int:
        return len(self._workers)

    @property
    def client_count(self) -> int:
        return sum(w.client_count for w in self._workers)
