"""UpstreamSyncer — fabric↔cluster anti-drift repair loop.
(Port of ``tpu_composer/controllers/syncer.py``.)

Reference analog: internal/controller/upstreamsyncer_controller.go — a
manager runnable (not a reconciler) ticking every 60s (:52-77):
fabric.GetResources() is diffed against local ComposableResources; a fabric
attachment with no local owner is tracked, and if still unclaimed after a
grace period (10 min, :38) a synthetic detach-CR is created, labeled with the
leaked device id (:140-165) — its reconciler adopts the id and runs the
normal detach path, returning the chip to the pool.

Ours keeps the design but with configurable cadence/grace (the bench runs
sub-second) and structured events. The store handle is normally the
CachedClient (cmd/main ``--cached-reads``): the per-tick
ComposableResource scan is an informer-cache read, so shrinking the sync
period for fast leak reclaim no longer multiplies apiserver list load.

Crash consistency: the reference tracks first-seen times in process memory,
so every controller restart resets the 10-minute grace clock — under a
crash-loop an orphaned device is never reclaimed. Here each newly-missing
device also gets a durable tracking object (a ``DeviceTaintRule`` named
``orphan-first-seen-<id>`` carrying the wall-clock first-seen annotation,
scheduling-inert: its name never collides with ``taint_rule_name`` and it
fails the whole-node-marker shape test), and a fresh syncer seeds its clock
from those records.
"""

from __future__ import annotations

import datetime
import threading
import time
from typing import Callable, Dict, Optional

from tpu_composer_torch.api.dra import DeviceTaintRule, DeviceTaintRuleSpec
from tpu_composer_torch.api.meta import ObjectMeta, parse_iso
from tpu_composer_torch.api.types import (
    ANNOTATION_ORPHAN_FIRST_SEEN,
    ComposableResource,
    ComposableResourceSpec,
    LABEL_READY_TO_DETACH,
    Node,
    RESOURCE_STATE_DEGRADED,
    RESOURCE_STATE_ONLINE,
    RESOURCE_STATE_REPAIRING,
)
from tpu_composer_torch.fabric.provider import FabricError, FabricProvider
from tpu_composer_torch.runtime.events import WARNING, EventRecorder
from tpu_composer_torch.runtime.metrics import degraded_members
from tpu_composer_torch.runtime.store import (
    AlreadyExistsError,
    NotFoundError,
    Store,
    StoreError,
)
from tpu_composer_torch.topology.slices import is_tpu_model

import logging

#: Name prefix of the durable orphan-tracking objects. Distinct from both
#: ``taint_rule_name``'s "quarantine-<uuid>" (per-device detach taints) and
#: "quarantine-node-<node>" (whole-node markers) so no consumer of either
#: ever picks a tracker up by mistake.
ORPHAN_TRACKER_PREFIX = "orphan-first-seen-"


def orphan_tracker_name(device_id: str) -> str:
    return ORPHAN_TRACKER_PREFIX + device_id.replace("/", "-").replace(
        ":", "-"
    ).lower()


def is_orphan_tracker(rule) -> bool:
    return rule.metadata.name.startswith(ORPHAN_TRACKER_PREFIX)


class UpstreamSyncer:
    def __init__(
        self,
        store: Store,
        fabric: FabricProvider,
        period: float = 60.0,  # :61
        grace: float = 600.0,  # :38 (10 min)
        recorder: Optional[EventRecorder] = None,
        vanish_threshold: int = 2,
        ownership=None,
        suspend: Optional[Callable[[], bool]] = None,
        session=None,
        fallback_multiplier: float = 20.0,
    ) -> None:
        self.store = store
        self.fabric = fabric
        self.period = period
        self.grace = grace
        self.recorder = recorder or EventRecorder()
        # Event-driven anti-drift (wire plane v2, same shape as the
        # dispatcher's poll-fallback): while the FabricSession streams,
        # the timed get_resources() relist is demoted to a
        # period × fallback_multiplier safety net, and inventory events /
        # gap recoveries ring self._wake for an immediate pass instead.
        # session=None (or a down/unsupported stream) keeps the plain
        # timed cadence — polling stays the primary path exactly as
        # before.
        self.session = session
        self.fallback_multiplier = max(1.0, fallback_multiplier)
        self._wake = threading.Event()
        if session is not None:
            session.on_event(self._on_fabric_event)
            session.on_gap(self._wake.set)
            session.on_state(lambda _healthy: self._wake.set())
        # Outage ride-through (cmd/main wires the store breaker's is_open
        # here): while the store is dark, "device not in any CR" proves
        # nothing — status writes can't land, so the diff would reclaim
        # healthy mid-attach devices. While suspended every orphan grace
        # clock freezes and no detach-CRs are created; a real orphan must
        # re-age a FULL grace after heal.
        self.suspend = suspend
        # Shard ownership (runtime.shards.ShardOwnership): with N replicas
        # each running a syncer against the same fabric, every mutating
        # sweep is partitioned by key hash — orphan reclamation by device
        # id, vanish detection by member name, stale-quarantine clearing
        # by node name — so exactly one replica acts per object. All three
        # paths are idempotent, so the partition is about duplicate work
        # and event spam, not correctness. None = unsharded (act on all).
        self.ownership = ownership
        # Consecutive sync passes an Online member's device must be absent
        # from get_resources() before the member is marked Degraded
        # (device-vanished detection). Damping twin of the controller's
        # health_failure_threshold: one glitchy listing must not degrade a
        # healthy member.
        self.vanish_threshold = max(1, vanish_threshold)
        self.log = logging.getLogger("UpstreamSyncer")
        # resource name -> consecutive passes its devices were missing.
        self._vanish_counts: Dict[str, int] = {}
        # device_id -> first-seen-missing time in the caller's `now`
        # timebase (:38, :107-123). Seeded from the durable trackers on the
        # first pass so a restart resumes, not resets, each grace clock.
        self._missing: Dict[str, float] = {}
        # device_ids whose first-seen record is known to be durable; a
        # persist that failed leaves its id out so later ticks retry.
        self._tracked: set = set()
        self._loaded = False

    def _owned(self, key: str) -> bool:
        return self.ownership is None or self.ownership.owns_key(key)

    def _on_fabric_event(self, evt) -> None:
        # Inventory transitions (chips added/removed/moved) are exactly
        # what the diff pass exists to reconcile; completion/health events
        # have their own consumers and don't ring here.
        from tpu_composer_torch.fabric.events import EVENT_INVENTORY

        if evt.type == EVENT_INVENTORY:
            self._wake.set()

    def effective_period(self) -> float:
        """Seconds until the next unprompted pass: ``period`` while polling
        is primary, ``period × fallback_multiplier`` while the fabric event
        stream is healthy (the relist is then only drift insurance)."""
        if self.session is not None and self.session.healthy():
            return self.period * self.fallback_multiplier
        return self.period

    # The Manager runnable entry point (mgr.Add(RunnableFunc) analog).
    def __call__(self, stop_event: threading.Event) -> None:
        from tpu_composer_torch.fabric.events import doorbell_wait

        last_pass = float("-inf")
        while not stop_event.is_set():
            # Doorbell-driven passes are floored at the base period: a
            # churny fabric rings once per attach/detach, and relisting
            # per event would cost MORE wire ops than the timed poll
            # this plane demoted. Bursts coalesce to one pass per
            # period; a ring after a quiet stretch fires immediately.
            doorbell_wait(
                stop_event, self._wake,
                deadline=time.monotonic() + self.effective_period(),
                floor=last_pass + self.period,
            )
            if stop_event.is_set():
                return
            self._wake.clear()
            last_pass = time.monotonic()
            try:
                self.sync_once()
            except (FabricError, StoreError) as e:
                # StoreError too: the manager runs this in a bare thread —
                # one transient apiserver 5xx mid-pass must not kill
                # orphan reclamation AND the quarantine backstop until
                # process restart. Next tick retries.
                self.log.warning("sync failed: %s", e)

    def sync_once(self, now: Optional[float] = None) -> int:
        """One diff pass; returns the number of detach-CRs created."""
        now = time.monotonic() if now is None else now
        if self.suspend is not None and self.suspend():
            # Store outage: the local view is known-stale. Re-stamp every
            # missing clock so suspension is frozen time, not accrued
            # grace — the post-heal pass starts each orphan's clock over.
            for dev_id in self._missing:
                self._missing[dev_id] = now
            return 0
        if not self._loaded:
            # Only a SUCCESSFUL load retires the flag: a transient list
            # failure here must not permanently disable clock resumption
            # (each later tick retries until one load lands).
            self._loaded = self._load_trackers(now)
        # Store-only; runs BEFORE the fabric call so a fabric outage
        # (get_resources raising every tick) cannot also suspend the
        # stale-marker backstop for its whole duration.
        self._sweep_stale_quarantines()
        upstream = self.fabric.get_resources()

        resources = self.store.list(ComposableResource)
        local_ids = {d for r in resources for d in r.status.device_ids}
        upstream_ids = set()
        created = 0

        for dev in upstream:
            upstream_ids.add(dev.device_id)
            if dev.device_id in local_ids:
                if self._missing.pop(dev.device_id, None) is not None:
                    self._drop_tracker(dev.device_id)  # reappeared (:99-105)
                continue
            if not self._owned(dev.device_id):
                # Sharded: another replica's syncer owns this orphan's
                # grace clock and detach-CR — acting here would duplicate
                # trackers and events fleet-wide.
                continue
            first = self._missing.get(dev.device_id)
            if first is None:
                first = now
                self._missing[dev.device_id] = now
            if dev.device_id not in self._tracked:
                # First sighting, or an earlier persist failed: (re)try,
                # back-dating the stamp so the durable clock matches the
                # in-memory one rather than restarting at persist time.
                if self._persist_tracker(dev, age=now - first):
                    self._tracked.add(dev.device_id)
            if now - first < self.grace:
                continue
            if self._create_detach_cr(dev):
                created += 1
            self._missing.pop(dev.device_id, None)
            self._drop_tracker(dev.device_id)

        # Vanished upstream -> stop tracking (:130-135).
        for dev_id in list(self._missing):
            if dev_id not in upstream_ids:
                del self._missing[dev_id]
                self._drop_tracker(dev_id)

        # Post-Ready failure detection, syncer arm: an ONLINE member whose
        # devices left the fabric listing has lost its attachment out from
        # under the workload — feed the same Degraded path the health
        # probes use (self-healing data plane). Runs only on a SUCCESSFUL
        # listing: a fabric outage raises out of get_resources() above and
        # never reaches here, so "unreachable" can't masquerade as
        # "vanished".
        self._detect_vanished(resources, upstream_ids)
        return created

    def _detect_vanished(self, resources, upstream_ids) -> None:
        from tpu_composer_torch.agent.publisher import DevicePublisher
        from tpu_composer_torch.controllers.resource_controller import degrade_member

        # Prune clocks of members that no longer exist (deleted
        # mid-damping): every other pop site keys off the member being
        # listed, so without this sweep churning fleets grow the dict
        # unboundedly (the resource controller prunes its streak dicts on
        # purge the same way).
        names = {r.name for r in resources}
        for stale in [k for k in self._vanish_counts if k not in names]:
            del self._vanish_counts[stale]
        degraded = 0
        for r in resources:
            if not self._owned(r.name):
                # Sharded: the member's owner runs vanish damping and
                # recovery; the fleet gauge below then counts only owned
                # members (per-process /metrics sum across replicas).
                self._vanish_counts.pop(r.name, None)
                continue
            if (
                r.status.state == RESOURCE_STATE_DEGRADED
                and not r.being_deleted
                and r.status.failure is not None
                and r.status.failure.source == "syncer"
                and r.status.device_ids
                and all(d in upstream_ids for d in r.status.device_ids)
            ):
                # Listing-based recovery, the mirror of listing-based
                # detection: a device-vanished degrade recovers when every
                # device is reported again. (The member's own handler
                # deliberately does NOT probe-recover these — health can
                # answer OK while the attachment is missing.)
                if self._recover_vanished(r):
                    continue
            if r.status.state in (
                RESOURCE_STATE_DEGRADED, RESOURCE_STATE_REPAIRING,
            ) and not r.being_deleted:
                # Same predicate as the request controller's breaker pass
                # (terminating members excluded) so the two level-setters
                # of tpuc_degraded can't flap against each other.
                degraded += 1
            if (
                r.status.state != RESOURCE_STATE_ONLINE
                or r.being_deleted
                or r.status.pending_op is not None  # mutation racing the listing
                or not r.status.device_ids
            ):
                self._vanish_counts.pop(r.name, None)
                continue
            missing = [
                d for d in r.status.device_ids if d not in upstream_ids
            ]
            if not missing:
                self._vanish_counts.pop(r.name, None)
                continue
            n = self._vanish_counts.get(r.name, 0) + 1
            if n < self.vanish_threshold:
                self._vanish_counts[r.name] = n  # damped: no write yet
                continue
            try:
                ok = degrade_member(
                    self.store, DevicePublisher(self.store), self.recorder, r,
                    reason="device-vanished",
                    detail=(
                        f"device(s) {', '.join(missing)} no longer reported"
                        " by the fabric"
                    ),
                    source="syncer",
                    probes=n,
                )
            except StoreError as e:
                self.log.warning(
                    "degrading %s (vanished devices) failed: %s — retrying"
                    " next tick", r.name, e,
                )
                self._vanish_counts[r.name] = n  # keep the ripened clock
                continue
            if not ok:
                # Write lost a conflict (degrade_member returns False):
                # keep the ripened vanish clock so the very next tick
                # retries, and do NOT report a transition that never
                # committed.
                self._vanish_counts[r.name] = n
                continue
            self._vanish_counts.pop(r.name, None)
            degraded += 1
            self.log.warning(
                "%s: Online member's device(s) vanished from the fabric"
                " listing (%s) — marked Degraded", r.name, ", ".join(missing),
            )
        # Level-set the fleet gauge every pass (drift-proof, unlike
        # inc/dec pairs that desync across restarts).
        degraded_members.set(float(degraded))

    def _recover_vanished(self, r) -> bool:
        """Return a device-vanished Degraded member to Online (its devices
        are all reported by the fabric again). Returns False when the
        write lost — retried next pass."""
        from tpu_composer_torch.agent.publisher import DevicePublisher

        try:
            # Taints first: failing here retries the WHOLE recovery next
            # pass; the other order could strand "degraded" taints on
            # healthy chips until detach.
            DevicePublisher(self.store).delete_taints(r.status.device_ids)
            r.status.state = RESOURCE_STATE_ONLINE
            r.status.error = ""
            r.status.failure = None
            self.store.update_status(r)
        except StoreError:
            return False  # conflict/404/outage — retried next pass
        self.recorder.event(
            r, "Normal", "Recovered",
            "vanished device(s) are reported by the fabric again",
        )
        self.log.warning(
            "%s: devices reappeared in the fabric listing — recovered to"
            " Online", r.name,
        )
        return True

    # ------------------------------------------------------------------
    # durable grace clock (crash consistency)
    # ------------------------------------------------------------------
    def _load_trackers(self, now: float) -> bool:
        """Seed ``_missing`` from persisted first-seen records: a device
        already aged A seconds resumes at ``now - A`` in the caller's
        timebase, so a crash-loop cannot push reclamation out forever.
        Returns False on a store failure so the caller retries next tick."""
        try:
            rules = self.store.list(DeviceTaintRule)
        except StoreError as e:
            self.log.warning("orphan tracker load failed (will retry): %s", e)
            return False
        wall_now = time.time()
        for rule in rules:
            if not is_orphan_tracker(rule):
                continue
            dev_id = rule.spec.device_uuid
            stamp = rule.metadata.annotations.get(ANNOTATION_ORPHAN_FIRST_SEEN, "")
            try:
                age = max(0.0, wall_now - parse_iso(stamp).timestamp())
            except (ValueError, OverflowError):
                age = 0.0  # unreadable stamp: restart the clock, keep tracking
            if dev_id:
                self._missing[dev_id] = now - age
                self._tracked.add(dev_id)
        if self._missing:
            self.log.info(
                "resumed %d orphan grace clock(s) from durable trackers",
                len(self._missing),
            )
        return True

    def _persist_tracker(self, dev, age: float = 0.0) -> bool:
        """Durable first-seen record, back-dated by ``age`` seconds (the
        in-memory clock's view when an earlier persist failed). Failures
        are non-fatal — the in-memory clock still runs and the caller
        retries each tick until one create lands."""
        stamp = (
            datetime.datetime.now(datetime.timezone.utc)
            - datetime.timedelta(seconds=max(0.0, age))
        ).isoformat(timespec="microseconds").replace("+00:00", "Z")
        try:
            self.store.create(DeviceTaintRule(
                metadata=ObjectMeta(
                    name=orphan_tracker_name(dev.device_id),
                    annotations={ANNOTATION_ORPHAN_FIRST_SEEN: stamp},
                ),
                spec=DeviceTaintRuleSpec(
                    device_uuid=dev.device_id,
                    node_name="",  # never a whole-node marker
                    effect="",  # scheduling-inert: tracking only
                    reason="orphan grace tracking",
                ),
            ))
        except AlreadyExistsError:
            pass  # a previous incarnation already stamped it — keep the older clock
        except StoreError as e:
            self.log.warning(
                "orphan tracker for %s not persisted (will retry): %s",
                dev.device_id, e,
            )
            return False
        return True

    def _drop_tracker(self, device_id: str) -> None:
        self._tracked.discard(device_id)
        try:
            self.store.delete(DeviceTaintRule, orphan_tracker_name(device_id))
        except NotFoundError:
            pass
        except StoreError as e:
            self.log.warning(
                "orphan tracker for %s not deleted: %s — a restart may"
                " briefly re-track the device", device_id, e,
            )

    def _sweep_stale_quarantines(self) -> int:
        """Clear whole-node quarantine markers whose node left the fleet.

        Level-triggered backstop for the resource controller's node-DELETED
        mapper: that cleanup runs ONCE per deletion event, and a wire fault
        there — or a node deleted after reallocation already removed its
        dependent CRs, leaving no reconcile to retry through — would
        otherwise strand the marker and exclude a recreated same-name node
        from allocation forever. Per-rule faults are logged and skipped so
        one bad delete doesn't abort the sync pass; the next tick retries.
        """
        from tpu_composer_torch.agent.publisher import (
            DevicePublisher,
            is_node_quarantine_marker,
            retire_node,
        )

        cleared = 0
        try:
            rules = self.store.list(DeviceTaintRule)
        except StoreError as e:
            self.log.warning("quarantine sweep skipped: %s", e)
            return 0
        for rule in rules:
            if not is_node_quarantine_marker(rule):
                continue  # per-device taint or orphan tracker, not a node marker
            node = rule.spec.node_name
            if not self._owned(node):
                continue  # sharded: the node-key owner clears its markers
            try:
                if self.store.try_get(Node, node) is not None:
                    continue
                # clear_node_quarantine swallows NotFound: a concurrent
                # clear means done either way.
                retire_node(self.fabric, DevicePublisher(self.store), node)
            except StoreError as e:
                self.log.warning(
                    "stale quarantine marker %s (node %s gone) not cleared:"
                    " %s — retrying next tick", rule.metadata.name, node, e,
                )
                continue
            self.log.warning(
                "cleared stale quarantine marker for departed node %s", node
            )
            cleared += 1
        return cleared

    def _create_detach_cr(self, dev) -> bool:
        name = f"detach-{dev.device_id}".lower().replace("/", "-")
        # Explicit device type carried through FabricDevice; the model-name
        # sniff survives only as the fallback for providers that predate
        # the field (a "tpu-like" model name was never a type contract).
        dev_type = dev.type or ("tpu" if is_tpu_model(dev.model) else "gpu")
        cr = ComposableResource(
            metadata=ObjectMeta(
                name=name,
                labels={LABEL_READY_TO_DETACH: dev.device_id},
            ),
            spec=ComposableResourceSpec(
                type=dev_type,
                model=dev.model,
                target_node=dev.node or "unknown",
                force_detach=True,
            ),
        )
        try:
            self.store.create(cr)
        except AlreadyExistsError:
            return False
        self.recorder.event(
            cr, WARNING, "OrphanedDevice",
            f"fabric reports {dev.device_id} on {dev.node} with no local owner;"
            " created detach resource",
        )
        return True

    @property
    def tracked_missing(self) -> Dict[str, float]:
        return dict(self._missing)
