"""Lease-based leader election for the watcher singleton.

The JAX package's ``k8s/leader.py``. The watcher is a singleton: a crashed
watcher means no notifications until something restarts it. This module lets
N replicas run with exactly one active: the standard Kubernetes leader
election protocol over ``coordination.k8s.io/v1`` Lease objects (the same
algorithm as client-go's ``leaderelection`` package, which kube-scheduler and
kube-controller-manager use):

- a candidate tries to create the Lease; on 409 someone else holds it;
- the holder renews ``renewTime`` every ``retry_period``;
- a non-holder acquires iff ``renewTime + leaseDurationSeconds`` has passed
  (the holder died without releasing) — optimistic concurrency via
  ``metadata.resourceVersion`` ensures only one stealer wins;
- a holder that cannot renew within ``renew_deadline`` steps down;
- a clean ``stop()`` releases the Lease (empty ``holderIdentity``) so
  standbys take over immediately instead of waiting out the lease.

Wall-clock caveat (same as client-go): expiry is judged by comparing the
OBSERVER's clock against the renewTime written by the holder, so it assumes
bounded clock skew between replicas; ``lease_duration`` must comfortably
exceed worst-case skew plus one renew period.
"""

from __future__ import annotations

import logging
import threading
import time
from datetime import datetime, timezone
from typing import Callable, Optional

from k8s_watcher_tpu_torch.config import leader_timing_error
from k8s_watcher_tpu_torch.k8s.client import K8sApiError, K8sClient, K8sConflictError

logger = logging.getLogger(__name__)

_MICROTIME = "%Y-%m-%dT%H:%M:%S.%fZ"  # k8s metav1.MicroTime wire format


def _now() -> datetime:
    return datetime.now(timezone.utc)


def _format_time(dt: datetime) -> str:
    return dt.astimezone(timezone.utc).strftime(_MICROTIME)


def _parse_time(raw: Optional[str]) -> Optional[datetime]:
    if not raw:
        return None
    text = raw.strip().replace("z", "Z")
    if text.endswith("Z"):
        text = text[:-1] + "+00:00"
    try:
        return datetime.fromisoformat(text)
    except ValueError:
        return None


class LeaderElector:
    """Run-for-leadership state machine; owns one background thread.

    Callbacks fire on the elector thread: ``on_started_leading`` once per
    term, ``on_stopped_leading`` when a held leadership is lost or released.
    """

    def __init__(
        self,
        client: K8sClient,
        *,
        # IMPORTANT: give the elector a client whose request_timeout is well
        # under renew_deadline (see elector_client()). A renew RPC that can
        # block longer than the deadline would keep is_leader true past the
        # point a standby may legally steal the lease — split-brain.
        lease_namespace: str,
        lease_name: str,
        identity: str,
        lease_duration_seconds: float = 15.0,
        renew_deadline_seconds: float = 10.0,
        retry_period_seconds: float = 2.0,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ):
        error = leader_timing_error(lease_duration_seconds, renew_deadline_seconds, retry_period_seconds)
        if error:
            raise ValueError(error)
        self.client = client
        self.lease_namespace = lease_namespace
        self.lease_name = lease_name
        self.identity = identity
        self.lease_duration = lease_duration_seconds
        self.renew_deadline = renew_deadline_seconds
        self.retry_period = retry_period_seconds
        self._on_started = on_started_leading
        self._on_stopped = on_stopped_leading
        self._leader = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._observed_lease: Optional[dict] = None

    # -- public API --------------------------------------------------------

    @property
    def is_leader(self) -> bool:
        return self._leader.is_set()

    def start(self) -> "LeaderElector":
        self._thread = threading.Thread(target=self._run, name="leader-elector", daemon=True)
        self._thread.start()
        return self

    def wait_for_leadership(self, timeout: Optional[float] = None) -> bool:
        """Block until this instance leads (True) or timeout/stop (False)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._stop.is_set():
            remaining = 0.2 if deadline is None else min(0.2, deadline - time.monotonic())
            if remaining <= 0:
                return self._leader.is_set()
            if self._leader.wait(timeout=remaining):
                return True
        return False

    def stop(self) -> None:
        """Stop campaigning; if leading, release the Lease for fast failover.

        Deliberate shutdown does NOT fire ``on_stopped_leading`` — the owner
        initiated it and a "lost leadership" reaction would be spurious."""
        self._stop.set()
        self._on_stopped = None
        if self._thread is not None:
            self._thread.join(timeout=self.retry_period * 2 + 2.0)
        if self._leader.is_set():
            self._release()
            self._set_leading(False)

    # -- state machine -----------------------------------------------------

    def _set_leading(self, leading: bool) -> None:
        was = self._leader.is_set()
        if leading and not was:
            self._leader.set()
            logger.info("Acquired leadership of %s/%s as %s", self.lease_namespace, self.lease_name, self.identity)
            if self._on_started:
                self._on_started()
        elif not leading and was:
            self._leader.clear()
            if self._stop.is_set():
                # deliberate shutdown, not an incident — keep WARNING-level
                # logs meaningful for alerting on real involuntary losses
                logger.info("Stepped down from leadership of %s/%s", self.lease_namespace, self.lease_name)
            else:
                logger.warning("Lost leadership of %s/%s", self.lease_namespace, self.lease_name)
            if self._on_stopped:
                self._on_stopped()

    def _run(self) -> None:
        while not self._stop.is_set():
            if self._leader.is_set():
                # the local validity deadline is judged on the MONOTONIC
                # clock (client-go does the same): a wall-clock step must
                # not extend how long an unrenewed leader believes it still
                # leads, or two replicas could both act as leader
                renewed_at = time.monotonic()
                # renew until it fails past the deadline; the acquisition
                # write just happened, so the first renew waits a period
                while not self._stop.is_set():
                    if self._stop.wait(self.retry_period):
                        return
                    if self._try_acquire_or_renew():
                        renewed_at = time.monotonic()
                    elif time.monotonic() - renewed_at >= self.renew_deadline:
                        # involuntary loss: step down and RETIRE this elector
                        # (client-go's elector returns too). Re-campaigning
                        # here could re-take the lease while the owning app
                        # is mid-shutdown, blocking the healthy standby.
                        self._set_leading(False)
                        return
            else:
                if self._try_acquire_or_renew():
                    self._set_leading(True)
                    continue  # go straight into the renew loop
                if self._stop.wait(self.retry_period):
                    return

    def _spec(self, transitions: int, acquire_time: Optional[str] = None) -> dict:
        now = _format_time(_now())
        return {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": int(self.lease_duration),
            "acquireTime": acquire_time or now,
            "renewTime": now,
            "leaseTransitions": transitions,
        }

    def _try_acquire_or_renew(self) -> bool:
        """One protocol step; True iff we hold a freshly-renewed lease."""
        try:
            lease = self.client.get_lease(self.lease_namespace, self.lease_name)
            if self._stop.is_set():
                # stop() may already have released the lease while this
                # thread was blocked in the GET above — do not write, or a
                # half-dead elector would take the released lease back
                return False
            if lease is None:
                self._observed_lease = self.client.create_lease(
                    self.lease_namespace, self.lease_name, self._spec(transitions=0)
                )
                return True

            spec = lease.get("spec") or {}
            holder = spec.get("holderIdentity") or ""
            if holder and holder != self.identity:
                renew = _parse_time(spec.get("renewTime"))
                duration = float(spec.get("leaseDurationSeconds") or self.lease_duration)
                if renew is not None and (_now() - renew).total_seconds() < duration:
                    self._observed_lease = lease
                    return False  # held and fresh
                logger.info("Lease %s/%s held by %s is expired; attempting takeover",
                            self.lease_namespace, self.lease_name, holder)

            transitions = int(spec.get("leaseTransitions") or 0)
            if holder != self.identity:
                transitions += 1  # leadership changes hands
            acquire_time = spec.get("acquireTime") if holder == self.identity else None
            lease["spec"] = self._spec(transitions, acquire_time)
            # resourceVersion from the GET above makes this a compare-and-swap:
            # if another candidate stole it first, the PUT 409s and we yield
            self._observed_lease = self.client.replace_lease(self.lease_namespace, self.lease_name, lease)
            return True

        except K8sConflictError:
            return False  # raced another candidate; they won this round
        except Exception as exc:  # noqa: BLE001 — the elector thread must survive
            # any failure mode of the API path (malformed JSON from a proxy,
            # unexpected response shape, ...): a dead elector thread would
            # leave a standby that never leads and never alerts
            logger.warning("Leader election step failed: %s", exc)
            return False

    def _release(self) -> None:
        # retried on conflict: an in-flight renew PUT from the (possibly
        # still-draining) elector thread can land between our GET and PUT;
        # re-reading picks up its resourceVersion so the release still wins
        for _ in range(3):
            try:
                lease = self.client.get_lease(self.lease_namespace, self.lease_name)
                if lease is None or (lease.get("spec") or {}).get("holderIdentity") != self.identity:
                    return
                lease["spec"]["holderIdentity"] = ""
                lease["spec"]["renewTime"] = _format_time(_now())
                self.client.replace_lease(self.lease_namespace, self.lease_name, lease)
                logger.info("Released lease %s/%s", self.lease_namespace, self.lease_name)
                return
            except K8sConflictError:
                continue
            except K8sApiError as exc:
                logger.warning("Failed to release lease (standbys will wait out the term): %s", exc)
                return
        logger.warning("Failed to release lease after retries (standbys will wait out the term)")


def default_identity() -> str:
    import os
    import socket

    return f"{socket.gethostname()}-{os.getpid()}"


def elector_client(client: K8sClient, renew_deadline_seconds: float, lease_duration_seconds: float) -> K8sClient:
    """A dedicated lease client with a bounded per-RPC timeout.

    The watch client's request_timeout (30 s default) can exceed the renew
    deadline; a single stalled renew RPC would then pin the elector thread
    past the point a standby legally steals the lease, leaving two replicas
    both acting as leader. Bound each lease RPC so the deadline check always
    runs with margin before lease expiry (client-go bounds renews the same
    way).
    """
    timeout = max(1.0, min(renew_deadline_seconds / 2.0, (lease_duration_seconds - renew_deadline_seconds) / 2.0))
    return K8sClient(client.connection, request_timeout=min(timeout, client.request_timeout))
