"""Lease-based leader election over any Store (port of
``tpu_composer/runtime/leases.py``).

Reference analog: the reference operator's cmd/main.go:142-155 —
controller-runtime leader election with ID ``c5744f42.hpsys.ibm.ie.com``, which is client-go's leaderelection
package under the hood: a coordination.k8s.io Lease CAS'd with
resourceVersion preconditions, renewed every ``renew_period``, stealable once
``lease_duration`` elapses without a renewal. ``LeaseElector`` implements
exactly that loop against our ``Store`` interface, so the same code elects
across replicas sharing one store (in process, or a persistent standalone
store across processes). The file-lock ``LeaderElector`` remains for
single-host standalone deployments without a shared store.

Interface-compatible with ``runtime.leader.LeaderElector``:
``try_acquire() / acquire() / release() / is_leader``; additionally runs a
background renew thread while leading, and drops ``is_leader`` if renewal
fails longer than the lease duration (the fencing contract: a partitioned
leader stops acting before a successor can take over).
"""

from __future__ import annotations

import datetime
import logging
import os
import re
import socket
import threading
import time
import uuid
from typing import Any, Optional

from tpu_composer_torch.api.lease import Lease, LeaseSpec
from tpu_composer_torch.api.meta import ObjectMeta, now_iso, parse_iso
from tpu_composer_torch.runtime.metrics import lease_transitions_total
from tpu_composer_torch.runtime.store import (
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
    StoreError,
)

LEADER_ELECTION_ID = "c5744f42.tpu.composer.dev"


def default_identity() -> str:
    """hostname_uuid — the same shape client-go uses (id must be unique per
    replica even on one host)."""
    return f"{socket.gethostname()}_{uuid.uuid4().hex[:8]}"


def sanitize_identity(identity: str) -> str:
    """Identity → DNS-1123-ish object-name fragment, shared by every
    consumer that names a store object after a replica (``member.<id>``
    heartbeat leases, ``telemetry.<id>`` fleet snapshots) — one rule, so
    an operator can correlate a replica's objects across subsystems."""
    out = re.sub(r"[^a-z0-9.-]+", "-", identity.lower()).strip("-.")
    return out or "replica"


class RenewObservation:
    """What a contender last saw on a lease — (holder, renew_time) — and
    WHEN it first saw that exact pair, on its own monotonic clock.

    The steal discipline shared by the single-leader elector and the shard
    elector (client-go's observedRenewTime): a lease is stealable only
    after the pair has sat unchanged for a full lease duration of LOCAL
    monotonic time. Comparing the holder's wall-clock stamp against the
    contender's wall clock alone would let a contender whose clock runs a
    lease-duration ahead (NTP step, VM resume) depose a healthy leader.
    """

    __slots__ = ("holder", "renew_time", "first_mono")

    def __init__(self, holder: str, renew_time: str, first_mono: float) -> None:
        self.holder = holder
        self.renew_time = renew_time
        self.first_mono = first_mono

    @classmethod
    def advance(
        cls,
        prev: Optional["RenewObservation"],
        holder: str,
        renew_time: str,
        now_mono: float,
    ) -> "RenewObservation":
        """Carry the previous observation forward, resetting the clock
        whenever the observed (holder, renew_time) pair changes."""
        if prev is not None and prev.holder == holder and prev.renew_time == renew_time:
            return prev
        return cls(holder, renew_time, now_mono)

    def expired(self, lease_duration_s: float, now_mono: float) -> bool:
        """Free (no holder) or observed-unchanged past the duration."""
        if not self.holder:
            return True
        return now_mono - self.first_mono > max(1.0, float(lease_duration_s))


class LeaseElector:
    def __init__(
        self,
        # Duck-typed Store/ChaosStore/CachedClient — the elector only
        # needs get/create/update + the CAS error taxonomy.
        store: Any,
        name: str = LEADER_ELECTION_ID,
        identity: str = "",
        lease_duration_s: float = 15.0,
        renew_period_s: float = 5.0,
        renew_deadline_s: float = 0.0,
    ) -> None:
        self.store = store
        self.name = name
        self.identity = identity or default_identity()
        self.lease_duration_s = lease_duration_s
        self.renew_period_s = renew_period_s
        # Fencing contract (client-go: RenewDeadline < LeaseDuration): we must
        # stop acting strictly BEFORE the lease becomes stealable, leaving the
        # gap (lease_duration - renew_deadline) to absorb the failure-retry
        # granularity, the manager watchdog poll, and controller stop time.
        if renew_deadline_s <= 0:
            renew_deadline_s = lease_duration_s * 2.0 / 3.0
        if renew_deadline_s >= lease_duration_s:
            raise ValueError(
                f"renew_deadline_s ({renew_deadline_s}) must be < "
                f"lease_duration_s ({lease_duration_s})"
            )
        self.renew_deadline_s = renew_deadline_s
        self.log = logging.getLogger("LeaseElector")
        self._lock = threading.Lock()
        self._leading = False
        # Steal-side observation clock (see RenewObservation).
        self._steal_obs: Optional[RenewObservation] = None
        self._stop_renew = threading.Event()
        self._renew_thread: Optional[threading.Thread] = None
        # Parity with LeaderElector's log line
        self.lock_path = f"lease/{name}"

    # ------------------------------------------------------------------
    def _now(self) -> datetime.datetime:
        return datetime.datetime.now(datetime.timezone.utc)

    def _expired(self, spec: LeaseSpec) -> bool:
        if not spec.holder_identity:
            return True
        if not spec.renew_time:
            return True
        try:
            renewed = parse_iso(spec.renew_time)
        except ValueError:
            return True
        age = (self._now() - renewed).total_seconds()
        return age > spec.lease_duration_seconds

    def _stealable(self, spec: LeaseSpec) -> bool:
        """Expired by BOTH clocks: the holder's wall-clock stamp is older
        than the lease duration AND this process has watched the
        (holder, renew_time) pair sit unchanged for a full lease duration
        on its monotonic clock (RenewObservation — the discipline shared
        with the shard elector). Either alone is spoofable by a clock
        jump on one side; together a healthy leader is never deposed."""
        if not spec.holder_identity or not spec.renew_time:
            return True  # released — free immediately
        now_mono = time.monotonic()
        self._steal_obs = RenewObservation.advance(
            self._steal_obs, spec.holder_identity, spec.renew_time, now_mono
        )
        if not self._expired(spec):
            return False
        return self._steal_obs.expired(spec.lease_duration_seconds, now_mono)

    def try_acquire(self) -> bool:
        """One CAS attempt: create the Lease, renew our own, or steal an
        expired one. Never blocks beyond the store round trip."""
        with self._lock:
            if self._leading:
                return True
            now = now_iso()
            try:
                existing = self.store.try_get(Lease, self.name)
                if existing is None:
                    self.store.create(
                        Lease(
                            metadata=ObjectMeta(name=self.name),
                            spec=LeaseSpec(
                                holder_identity=self.identity,
                                lease_duration_seconds=max(1, round(self.lease_duration_s)),
                                acquire_time=now,
                                renew_time=now,
                            ),
                        )
                    )
                elif existing.spec.holder_identity == self.identity:
                    existing.spec.renew_time = now
                    self.store.update(existing)
                elif self._stealable(existing.spec):
                    existing.spec.holder_identity = self.identity
                    existing.spec.acquire_time = now
                    existing.spec.renew_time = now
                    existing.spec.lease_transitions += 1
                    self.store.update(existing)  # CAS via resourceVersion
                else:
                    return False
            except (AlreadyExistsError, ConflictError):
                return False  # another replica won the race
            except StoreError as e:
                self.log.warning("lease acquire failed: %s", e)
                return False
            self._leading = True
            lease_transitions_total.inc(event="acquired")
            self._start_renewing()
            return True

    def acquire(
        self,
        poll_interval: float = 0.5,
        stop_event: Optional[threading.Event] = None,
    ) -> bool:
        """Block until leadership is acquired (or stop_event is set)."""
        while True:
            if self.try_acquire():
                return True
            if stop_event is not None and stop_event.wait(poll_interval):
                return False
            if stop_event is None:
                import time

                time.sleep(poll_interval)

    # ------------------------------------------------------------------
    def _start_renewing(self) -> None:
        self._stop_renew.clear()
        self._renew_thread = threading.Thread(
            target=self._renew_loop, name="lease-renew", daemon=True
        )
        self._renew_thread.start()

    def _renew_loop(self) -> None:
        # MONOTONIC fencing clock: the "stop acting" deadline must be
        # immune to wall-clock jumps — an NTP step (or a VM resume)
        # rewinding time.time() mid-partition would otherwise compute a
        # tiny/negative failing_for and keep a partitioned leader alive
        # past the point its lease became stealable. Wall time is used
        # only for the renew_time STAMP other replicas read.
        last_success = time.monotonic()
        # After a failed renew, poll fast (1s) so the renew_deadline check
        # fires promptly instead of one renew_period late; the stand-down
        # must land inside (lease_duration - renew_deadline) before the
        # lease becomes stealable by a contender.
        wait_s = self.renew_period_s
        fail_retry_s = min(1.0, self.renew_period_s)
        while not self._stop_renew.wait(wait_s):
            try:
                lease = self.store.get(Lease, self.name)
                if lease.spec.holder_identity != self.identity:
                    # someone stole it (we must have been expired) — stand down
                    self.log.warning(
                        "lease lost to %s", lease.spec.holder_identity
                    )
                    with self._lock:
                        self._leading = False
                    return
                lease.spec.renew_time = now_iso()
                self.store.update(lease)
                last_success = time.monotonic()
                wait_s = self.renew_period_s
            except (ConflictError, NotFoundError, StoreError) as e:
                # Fencing: if we cannot renew past the renew deadline (which
                # is strictly less than the lease duration), another replica
                # may be about to lead — stop claiming we do while the lease
                # is still OURS on the wire, so both replicas never drive the
                # fabric concurrently.
                failing_for = time.monotonic() - last_success
                lease_transitions_total.inc(event="renewed_fail")
                self.log.warning(
                    "lease renew failed (%.0fs): %s", failing_for, e
                )
                if failing_for >= self.renew_deadline_s:
                    with self._lock:
                        self._leading = False
                    return
                wait_s = fail_retry_s

    # ------------------------------------------------------------------
    def release(self) -> None:
        """Give the lease up voluntarily (clean shutdown → instant failover,
        like client-go's ReleaseOnCancel)."""
        with self._lock:
            was_leading = self._leading
            self._leading = False
        self._stop_renew.set()
        if self._renew_thread is not None:
            self._renew_thread.join(timeout=self.renew_period_s + 1)
            self._renew_thread = None
        if not was_leading:
            # A deposed replica never touches the lease on its way out —
            # whatever is on the wire belongs to the successor.
            return
        lease_transitions_total.inc(event="released")
        try:
            lease = self.store.try_get(Lease, self.name)
            if lease is not None and lease.spec.holder_identity == self.identity:
                lease.spec.holder_identity = ""
                lease.spec.renew_time = ""
                # CAS-guarded on identity (the read above) + resourceVersion
                # (the store's update precondition): if a successor steals
                # the lease between our read and this write, the write
                # conflicts and the successor's lease survives untouched.
                self.store.update(lease)
        except ConflictError:
            pass  # successor CAS'd in between read and write — theirs now
        except StoreError:
            pass  # expiry will free it

    @property
    def is_leader(self) -> bool:
        with self._lock:
            return self._leading
