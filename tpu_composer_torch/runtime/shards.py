"""Shard leases: scale the control plane past one active replica (port of
``tpu_composer/runtime/shards.py``; :func:`shard_for` sends every name to
the shard the JAX package's does).

Every layer below this one — informer cache, dispatcher, crash-consistent
adoption, self-healing repair — assumed a single active leader, so the
operator was both a single point of failure and a single-process throughput
ceiling. This module generalizes ``runtime/leases.py`` single-leader
election into K *shard leases* (``shard-0..K-1``): N operator replicas each
CAS-acquire a balanced subset, a stable consistent-hash mapping
(:func:`shard_for`, crc32 — PYTHONHASHSEED-independent) routes every object key to exactly one shard, and ownership is
enforced end-to-end (controller queues, syncer passes, dispatcher lanes,
the fabric write path). The design follows the composable-controller
argument of arXiv:2506.23628:
partition device ownership rather than funnel it through one reconciler —
and the 32-GPU composable-system scaling study (arXiv:2404.06467), where
control-plane serialization dominates at scale.

Three properties carry the robustness story:

- **Handoff, not restart.** Acquiring a shard fires ``on_acquire``
  callbacks before the serving resync floods the queues; the operator's
  entry point wires the cold-start adoption pass there, scoped to the
  shard's keys —
  so failover and rebalancing reuse exactly the machinery the
  kill–restart soak proves.
- **Fencing on loss.** A replica whose renewals fail past the
  renew-deadline (measured on the MONOTONIC clock — wall jumps must not
  keep a partitioned owner alive) drops ownership and fires ``on_lose``
  (the entry point purges that shard's dispatcher lanes) strictly before the
  lease becomes stealable by a successor — the shard-level twin of the
  single-leader deposed fencing.
- **Observation-based expiry.** A contender steals a shard only after
  *its own monotonic clock* has watched the incumbent's ``renew_time``
  stay unchanged for a full lease duration (client-go's observedRenewTime
  discipline) — a skewed or jumped wall clock on either side can neither
  hasten nor indefinitely delay a steal.

Membership: each replica also renews one ``member`` lease, so replicas
holding zero shards (hot standbys) stay visible to the balance target
``ceil(K / live_members)``. The rebalancer sheds one shard per tick when
this replica holds more than the target AND the fleet spread is >1 off
balance — a returning replica is handed work without thrash.

One shard (the entry point's default) constructs none of this: the
single-leader path is untouched.
"""

from __future__ import annotations

import logging
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from tpu_composer_torch.api.lease import Lease, LeaseSpec
from tpu_composer_torch.api.meta import ObjectMeta, now_iso
from tpu_composer_torch.runtime import tracing
from tpu_composer_torch.runtime.leases import (
    RenewObservation,
    default_identity,
    sanitize_identity as _sanitize,
)
from tpu_composer_torch.runtime.metrics import (
    shard_handoffs_total,
    shard_ownership_gauge,
)
from tpu_composer_torch.runtime.store import (
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
    StoreError,
)

SHARD_ELECTION_ID = "c5744f42.tpu.composer.dev"


def shard_for(name: str, num_shards: int) -> int:
    """Stable object-key → shard mapping. crc32, not hash(): the mapping
    must be identical across replicas, restarts and PYTHONHASHSEED —
    two replicas disagreeing on a key's shard is a double-attach."""
    if num_shards <= 1:
        return 0
    return zlib.crc32(name.encode("utf-8")) % num_shards


class ShardFencedError(Exception):
    """Raised by a fabric write path whose key's shard this replica no
    longer owns — the mutation must not be issued. Quiet-exception in the
    controllers: the key requeues under backoff and the worker-side
    ownership filter drops it; the new owner drives the op via its scoped
    adoption pass reading the same durable intent."""


class ShardOwnership:
    """Thread-safe view of the shards this replica currently serves.

    ``None`` everywhere a component accepts an ownership handle means
    "unsharded" — no filtering, today's single-leader behavior.
    """

    def __init__(self, num_shards: int) -> None:
        self.num_shards = max(1, int(num_shards))
        self._lock = threading.Lock()
        self._owned: Set[int] = set()

    def owned(self) -> Set[int]:
        with self._lock:
            return set(self._owned)

    def owns_shard(self, shard: int) -> bool:
        with self._lock:
            return shard in self._owned

    def owns_key(self, name: str) -> bool:
        return self.owns_shard(shard_for(name, self.num_shards))

    # elector-internal mutators -----------------------------------------
    def _add(self, shard: int) -> None:
        with self._lock:
            self._owned.add(shard)

    def _discard(self, shard: int) -> None:
        with self._lock:
            self._owned.discard(shard)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // max(1, b))


class ShardLeaseElector:
    """K shard leases + one member lease per replica, over any Store.

    Interface-compatible with the Manager's elector slot
    (``acquire(stop_event)/try_acquire()/release()/is_leader/lock_path``)
    — but ``is_leader`` stays True for the process lifetime: losing a
    shard fences and hands off THAT shard; it never deposes the replica,
    which keeps running as a hot standby re-acquiring work as leases free
    up. Tests may drive :meth:`tick` directly for determinism instead of
    starting the renew thread.
    """

    def __init__(
        self,
        # Duck-typed Store/ChaosStore/CachedClient (same contract as
        # LeaseElector: get/create/update + the CAS error taxonomy).
        store: Any,
        num_shards: int,
        identity: str = "",
        name: str = SHARD_ELECTION_ID,
        lease_duration_s: float = 15.0,
        renew_period_s: float = 5.0,
        renew_deadline_s: float = 0.0,
        expected_replicas: int = 0,
    ) -> None:
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.store = store
        self.num_shards = num_shards
        self.name = name
        self.identity = identity or default_identity()
        self.lease_duration_s = lease_duration_s
        self.renew_period_s = renew_period_s
        if renew_deadline_s <= 0:
            renew_deadline_s = lease_duration_s * 2.0 / 3.0
        if renew_deadline_s >= lease_duration_s:
            raise ValueError(
                f"renew_deadline_s ({renew_deadline_s}) must be < "
                f"lease_duration_s ({lease_duration_s})"
            )
        self.renew_deadline_s = renew_deadline_s
        # Startup damping: during the first lease_duration after start,
        # cap acquisition at ceil(K/expected_replicas) so replica-1 of a
        # rolling N-replica deploy doesn't seize every shard only to shed
        # (and hand off) most of them moments later. 0/1 disables.
        self.expected_replicas = max(0, expected_replicas)
        self.ownership = ShardOwnership(num_shards)
        #: fired ONCE per tick with every shard won that tick
        #: ({shard: reason}), after the CAS lands and ownership flips on
        #: (so the dispatcher's owns-gate accepts re-driven work), BEFORE
        #: the serving resync — the scoped-adoption slot. Batched so a
        #: K-shard bootstrap costs one store list + one fabric listing,
        #: not K. A callback failure is logged, not fatal (reconcile-path
        #: safety nets converge).
        self.on_acquire: List[Callable[[Dict[int, str]], None]] = []
        #: fired once per tick with the set of shards just won, after
        #: on_acquire — the resync slot (re-enqueue the shards' keys into
        #: running controllers).
        self.on_ready: List[Callable[[Set[int]], None]] = []
        #: fired with (shard, reason) AFTER ownership flips off — the
        #: fencing slot (purge dispatcher lanes for the shard's keys).
        self.on_lose: List[Callable[[int, str], None]] = []
        self.log = logging.getLogger("ShardLeaseElector")
        self.lock_path = f"lease/{name} x{num_shards}"
        self._member_name = f"member.{_sanitize(self.identity)}.{name}"
        self._tick_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._first_tick = threading.Event()
        self._started_mono: Optional[float] = None
        # shard -> monotonic time of the last successful renewal (the
        # fencing clock — wall-time jumps cannot move it).
        self._last_renew: Dict[int, float] = {}
        # lease name -> what we saw + when we first saw THAT (holder,
        # renew_time) pair on our monotonic clock.
        self._obs: Dict[str, RenewObservation] = {}
        self._failing = False  # fast-retry cadence while renewals fail
        #: Tag the renew thread's trace events (adopt spans from the
        #: on_acquire hooks) with this replica's identity pid. Default on
        #: for direct harness use; an entry point may flip it off so every
        #: event stays on plain os.getpid().
        self.tag_traces = True

    # ------------------------------------------------------------------
    def shard_lease_name(self, shard: int) -> str:
        return f"shard-{shard}.{self.name}"

    def owned_shards(self) -> Set[int]:
        return self.ownership.owned()

    @property
    def is_leader(self) -> bool:
        # Shard mode never deposes the whole replica: a shard loss fences
        # that shard; the process stays up as a standby. The Manager
        # watchdog therefore never fires for a shard elector.
        return not self._stop.is_set()

    # ------------------------------------------------------------------
    # lease bookkeeping
    # ------------------------------------------------------------------
    def _observe(self, lease_name: str, lease: Optional[Lease], now: float) -> RenewObservation:
        holder = lease.spec.holder_identity if lease is not None else ""
        renew = lease.spec.renew_time if lease is not None else ""
        obs = RenewObservation.advance(
            self._obs.get(lease_name), holder, renew, now
        )
        self._obs[lease_name] = obs
        return obs

    def _observed_expired(self, lease: Lease, obs: RenewObservation, now: float) -> bool:
        """Expired by OUR observation clock (RenewObservation, shared with
        the single-leader elector's steal gate): the (holder, renew_time)
        pair has sat unchanged for longer than the lease's advertised
        duration. Wall-clock stamps are never compared against wall-clock
        now — a jumped clock on either side cannot force an early steal."""
        return obs.expired(lease.spec.lease_duration_seconds, now)

    def _live_members(
        self, leases: Dict[str, Lease], now: float
    ) -> Tuple[Set[str], Dict[str, int]]:
        """(live replica identities, live shard-lease counts per holder).

        A replica is live if it renews a member lease OR holds any
        unexpired shard lease (covers electors that predate membership).
        Zero-holders matter: the balance target must see a hot standby.
        """
        live: Set[str] = {self.identity}
        counts: Dict[str, int] = {}
        for lease_name, lease in leases.items():
            obs = self._obs.get(lease_name)
            if obs is None:
                obs = self._observe(lease_name, lease, now)
            if not lease.spec.holder_identity:
                continue
            if self._observed_expired(lease, obs, now):
                continue
            if lease_name.startswith("member."):
                live.add(lease.spec.holder_identity)
            elif lease_name.startswith("shard-"):
                live.add(lease.spec.holder_identity)
                counts[lease.spec.holder_identity] = (
                    counts.get(lease.spec.holder_identity, 0) + 1
                )
        return live, counts

    # ------------------------------------------------------------------
    # the tick
    # ------------------------------------------------------------------
    def tick(self) -> None:
        """One full pass: membership heartbeat, renew owned shards (fence
        on deadline), shed for balance, acquire free/expired shards up to
        the balance target. Safe to call directly (tests) or from the
        renew thread."""
        with self._tick_lock:
            self._tick_locked()
        self._first_tick.set()

    def _tick_locked(self) -> None:
        now = time.monotonic()
        if self._started_mono is None:
            self._started_mono = now
        try:
            leases = {
                l.metadata.name: l
                for l in self.store.list(Lease)
                if l.metadata.name.endswith(self.name)
            }
        except StoreError as e:
            # Store dark: every owned shard's renewal is failing. Check
            # the monotonic fencing deadline per shard and stand down the
            # ones we can no longer prove are ours.
            self.log.warning("shard lease listing failed: %s", e)
            self._failing = True
            for shard in sorted(self.ownership.owned()):
                if now - self._last_renew.get(shard, now) >= self.renew_deadline_s:
                    self._lose(shard, "fenced")
            return
        for lease_name, lease in leases.items():
            self._observe(lease_name, lease, now)
        # Observations of deleted leases would otherwise accrete forever
        # across member churn (each crashed incarnation leaves a name).
        for stale in [n for n in self._obs if n not in leases]:
            del self._obs[stale]
        self._failing = False
        self._renew_member(leases, now)
        self._gc_dead_members(leases, now)
        live, counts = self._live_members(leases, now)
        target = _ceil_div(self.num_shards, len(live))
        if (
            self.expected_replicas > 1
            and now - self._started_mono < self.lease_duration_s
        ):
            target = min(
                target, _ceil_div(self.num_shards, self.expected_replicas)
            )
        self._renew_owned(leases, now)
        self._maybe_shed(leases, live, counts, now)
        self._maybe_acquire(leases, live, target, now)
        # A multi-shard win runs one scoped adoption pass per shard inside
        # the acquire hooks (store + fabric listings) — at real apiserver
        # RTTs that can eat a sizable slice of the renew period, and the
        # NEXT tick's renewals would land late enough to creep toward the
        # fencing deadline. Re-renew in the same tick when acquisition ran
        # long, so handoff work can never starve the shards already held
        # into self-fencing. (`leases` carries the post-renew objects, so
        # the CAS preconditions are current.)
        if time.monotonic() - now > self.renew_period_s / 2:
            self._renew_owned(leases, time.monotonic())
        self._export()

    def _renew_member(self, leases: Dict[str, Lease], now: float) -> None:
        stamp = now_iso()
        lease = leases.get(self._member_name)
        try:
            if lease is None:
                self.store.create(Lease(
                    metadata=ObjectMeta(name=self._member_name),
                    spec=LeaseSpec(
                        holder_identity=self.identity,
                        lease_duration_seconds=max(1, round(self.lease_duration_s)),
                        acquire_time=stamp,
                        renew_time=stamp,
                    ),
                ))
            else:
                lease.spec.holder_identity = self.identity
                lease.spec.renew_time = stamp
                self.store.update(lease)
        except (AlreadyExistsError, ConflictError):
            pass  # racing our own previous incarnation — next tick wins
        except StoreError as e:
            self._failing = True
            self.log.warning("member heartbeat failed: %s", e)

    def _gc_dead_members(self, leases: Dict[str, Lease], now: float) -> None:
        """Retire heartbeat Leases of dead incarnations. The identity
        embeds a per-boot uuid, so a kill -9'd replica never deletes its
        own member lease — without this sweep every crash leaks one Lease
        into the store (and one observation into every live replica)
        forever, and the listing that gates each renewal tick grows
        monotonically with pod churn. Conservative threshold (2x lease
        duration past our first observation of the final renew stamp):
        deleting a merely-partitioned replica's heartbeat is also safe —
        it re-creates the lease on its first healed tick."""
        for lease_name in list(leases):
            if not lease_name.startswith("member."):
                continue
            if lease_name == self._member_name:
                continue
            lease = leases[lease_name]
            obs = self._obs.get(lease_name)
            if obs is None:
                continue
            dead_for = now - obs.first_mono
            if dead_for <= 2 * max(
                1.0, float(lease.spec.lease_duration_seconds)
            ):
                continue
            try:
                self.store.delete(Lease, lease_name)
                del leases[lease_name]
                self._obs.pop(lease_name, None)
                self.log.info("retired dead member heartbeat %s", lease_name)
            except (NotFoundError, ConflictError):
                del leases[lease_name]
                self._obs.pop(lease_name, None)
            except StoreError:
                pass  # next tick retries

    def _renew_owned(self, leases: Dict[str, Lease], now: float) -> None:
        for shard in sorted(self.ownership.owned()):
            lease = leases.get(self.shard_lease_name(shard))
            if lease is None or lease.spec.holder_identity != self.identity:
                # Stolen (we must have been expired) or deleted out from
                # under us — the successor may already be serving. Stand
                # down NOW; the fencing margin absorbed the gap.
                self._lose(shard, "deposed")
                continue
            lease.spec.renew_time = now_iso()
            try:
                updated = self.store.update(lease)
                if updated is not None:
                    leases[lease.metadata.name] = updated
                    self._observe(lease.metadata.name, updated, now)
                self._last_renew[shard] = now
            except (ConflictError, NotFoundError, StoreError) as e:
                self._failing = True
                failing_for = now - self._last_renew.get(shard, now)
                self.log.warning(
                    "shard %d renew failed (%.1fs): %s", shard, failing_for, e
                )
                # Monotonic fencing deadline, the same contract as the
                # single-leader elector: stop serving the shard strictly
                # before its lease becomes stealable.
                if failing_for >= self.renew_deadline_s:
                    self._lose(shard, "fenced")

    def _maybe_shed(
        self,
        leases: Dict[str, Lease],
        live: Set[str],
        counts: Dict[str, int],
        now: float,
    ) -> None:
        owned = self.ownership.owned()
        target = _ceil_div(self.num_shards, len(live))
        if len(owned) <= target:
            return
        min_held = min((counts.get(m, 0) for m in live), default=0)
        if len(owned) - min_held <= 1:
            return  # spread within 1 — balanced enough, don't thrash
        # Shed ONE shard per tick (gentle: each handoff costs the new
        # owner a scoped adoption pass); highest shard id for determinism.
        shard = max(owned)
        self._lose(shard, "rebalance")
        self._release_shard_lease(shard)

    def _maybe_acquire(
        self,
        leases: Dict[str, Lease],
        live: Set[str],
        target: int,
        now: float,
    ) -> None:
        # Rotate the scan start by identity so N booting replicas don't
        # all CAS shard-0 first.
        start = zlib.crc32(self.identity.encode()) % self.num_shards
        owned_before = len(self.ownership.owned())
        wins: Dict[int, str] = {}
        for off in range(self.num_shards):
            shard = (start + off) % self.num_shards
            if self.ownership.owns_shard(shard):
                continue
            lease_name = self.shard_lease_name(shard)
            lease = leases.get(lease_name)
            holder = lease.spec.holder_identity if lease is not None else ""
            dead_holder = bool(holder) and holder not in live
            # Balance gates only FREE shards (bootstrap/handoff). A shard
            # whose holder is dead is taken unconditionally — availability
            # beats balance, and the rebalancer evens things out later.
            if not dead_holder and owned_before + len(wins) >= target:
                continue
            stamp = now_iso()
            try:
                if lease is None:
                    created = self.store.create(Lease(
                        metadata=ObjectMeta(name=lease_name),
                        spec=LeaseSpec(
                            holder_identity=self.identity,
                            lease_duration_seconds=max(1, round(self.lease_duration_s)),
                            acquire_time=stamp,
                            renew_time=stamp,
                        ),
                    ))
                    if created is not None:
                        leases[lease_name] = created
                    wins[shard] = "bootstrap"
                    continue
                obs = self._obs.get(lease_name) or self._observe(lease_name, lease, now)
                if not self._observed_expired(lease, obs, now):
                    continue
                lease.spec.holder_identity = self.identity
                lease.spec.acquire_time = stamp
                lease.spec.renew_time = stamp
                lease.spec.lease_transitions += 1
                updated = self.store.update(lease)  # CAS via resourceVersion
                leases[lease_name] = updated if updated is not None else lease
                wins[shard] = "failover" if holder else "handoff"
            except (AlreadyExistsError, ConflictError):
                continue  # another replica won this shard's race
            except StoreError as e:
                self._failing = True
                self.log.warning("shard %d acquire failed: %s", shard, e)
        if wins:
            self._serve_won(wins, now)

    # ------------------------------------------------------------------
    def _serve_won(self, wins: Dict[int, str], now: float) -> None:
        """Flip every shard won this tick on, then fire ONE batched
        on_acquire + on_ready round.

        Ownership flips ON before the on_acquire hooks: the scoped
        adoption pass inside them re-drives in-flight ops through THIS
        replica's dispatcher, whose owns-gate would silently discard the
        submissions if the shards still read as unowned. The serving
        resync (on_ready, which floods the controller queues with the
        shards' keys) still runs strictly after adoption; the only
        reconciles that can slip in between are watch-event-triggered
        ones, and those are safe by construction — idempotent verbs plus
        the durable intent nonce, the same contract that protects the
        no-adoption (hook-failure) path. Batching matters at bootstrap: a
        lone replica winning all K shards runs one adoption pass (one
        store list + one fabric listing) and one resync, not K of each —
        which is also what keeps a multi-shard win from starving renewals
        of the shards already held."""
        for shard, reason in wins.items():
            self._last_renew[shard] = now
            self.log.info("acquired shard %d (%s)", shard, reason)
            shard_handoffs_total.inc(reason=reason)
            self.ownership._add(shard)
            shard_ownership_gauge.set(1, shard=str(shard))
        for cb in self.on_acquire:
            try:
                cb(dict(wins))
            except Exception:
                self.log.exception(
                    "on_acquire hook failed for shards %s; relying on"
                    " reconcile-path recovery", sorted(wins)
                )
        for cb in self.on_ready:
            try:
                cb(set(wins))
            except Exception:
                self.log.exception(
                    "on_ready hook failed for shards %s", sorted(wins)
                )

    def _lose(self, shard: int, reason: str) -> None:
        # Ownership OFF first: controllers and the fabric write path stop
        # accepting the shard's keys before the fencing callbacks run.
        self.ownership._discard(shard)
        self._last_renew.pop(shard, None)
        self.log.warning("lost shard %d (%s)", shard, reason)
        shard_handoffs_total.inc(reason=reason)
        shard_ownership_gauge.set(0, shard=str(shard))
        for cb in self.on_lose:
            try:
                cb(shard, reason)
            except Exception:
                self.log.exception("on_lose hook failed for shard %d", shard)

    def _release_shard_lease(self, shard: int) -> None:
        """CAS-clear one shard lease, guarded on identity + rv: a deposed
        replica can never delete a successor's lease."""
        try:
            lease = self.store.try_get(Lease, self.shard_lease_name(shard))
            if lease is not None and lease.spec.holder_identity == self.identity:
                lease.spec.holder_identity = ""
                lease.spec.renew_time = ""
                self.store.update(lease)
        except ConflictError:
            pass  # a successor CAS'd in between read and write — theirs now
        except StoreError:
            pass  # expiry frees it

    def _export(self) -> None:
        owned = self.ownership.owned()
        for shard in range(self.num_shards):
            shard_ownership_gauge.set(
                1 if shard in owned else 0, shard=str(shard)
            )

    # ------------------------------------------------------------------
    # elector interface (Manager slot)
    # ------------------------------------------------------------------
    def try_acquire(self) -> bool:
        self.tick()
        return True

    def acquire(
        self,
        poll_interval: float = 0.5,
        stop_event: Optional[threading.Event] = None,
    ) -> bool:
        """Start the renew loop and block until the first full tick has
        completed (unlike the single-leader elector this returns even with
        zero shards held — a standby replica still serves /healthz and
        acquires work the moment leases free up)."""
        self.start()
        while not self._first_tick.wait(timeout=poll_interval):
            if stop_event is not None and stop_event.is_set():
                return False
            if self._stop.is_set():
                return False
        return True

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="shard-lease-renew", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        # The renew thread runs the scoped-adoption on_acquire hooks, whose
        # adopt spans must carry THIS replica's trace pid — a failover's
        # post-crash adoption renders as the stealing replica's process in
        # a merged fleet trace, not as an anonymous shared pid.
        if self.tag_traces:
            tracing.bind_thread(self.identity)
        fail_retry = min(1.0, self.renew_period_s)
        wait = 0.0  # first tick immediately
        while not self._stop.wait(wait):
            try:
                self.tick()
            except Exception:
                self.log.exception("shard tick failed")
            wait = fail_retry if self._failing else self.renew_period_s

    def release(self) -> None:
        """Voluntary stand-down: fence every owned shard, CAS-clear its
        lease (instant failover for successors) and retire the member
        heartbeat. Safe to call repeatedly."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.renew_period_s + 1)
            self._thread = None
        with self._tick_lock:
            for shard in sorted(self.ownership.owned()):
                self._lose(shard, "released")
                self._release_shard_lease(shard)
            try:
                self.store.delete(Lease, self._member_name)
            except (NotFoundError, StoreError):
                pass  # expiry retires the heartbeat
