"""FabricDispatcher — the async fabric I/O pipeline between reconcile
workers and a FabricProvider (port of ``tpu_composer/fabric/dispatcher.py``).

Why this layer exists (the "30 s quantization" of attach polling, carried
to its conclusion): with store round trips off the read path, the
attach wave is bound by the fabric side — every ComposableResource paid its
own blocking ``add_resource`` inside a reconcile worker, and in-progress
attaches were re-polled on a fixed ``attach_poll`` timer. Composable-fabric
scaling work (arXiv:2404.06467) and RPC-amortization work (Dagger,
arXiv:2106.01482) both show the same failure shape: per-device control-plane
calls must be batched and pipelined or the fabric manager's per-call
overhead dominates as group size grows. The dispatcher provides:

- **per-node batching** — attach/detach submissions targeting the same node
  within a coalescing window (``batch_window``) collapse into one provider
  call through the optional ``add_resources``/``remove_resources`` group
  verbs (InMemoryPool, REST CM); providers without them get a transparent
  per-item fallback. Ordering is strict per-node FIFO: an attach can never
  reorder past a detach for the same node, and an op for a resource that
  still has an earlier in-flight op holds its lane until that op completes.
  Concurrency *across* nodes is bounded by ``concurrency`` worker threads.
- **failure splitting** — a group call that raises is retried
  member-by-member through the single verbs, so one bad device cannot
  poison its group and breaker / attach-budget / quarantine accounting
  stays per-resource (the single verbs' semantics, unchanged).
- **completion-driven requeue** — a submission immediately raises the
  ``DispatchedAttaching``/``DispatchedDetaching`` sentinel (the reconciler
  requeues on its normal poll timer as a safety net) and registers an
  ``on_ready`` latch; the dispatcher fires it the moment the op completes
  — or first reports fabric-side progress — so the CR's key re-enters its
  controller queue immediately instead of burning a fixed ``attach_poll``
  quantum. Fabric-async ops (wait sentinels from the provider) are
  re-polled by the dispatcher itself with one shared per-node poll pass.
- **shared snapshot reads** — concurrent/near-in-time ``get_resources``
  calls are single-flighted and served from a snapshot no older than
  ``snapshot_ttl`` (default: the batch window), amortizing the listing the
  controllers refresh per-node gauges from. Consumers (composed-chips
  gauge, the 60 s anti-drift syncer) tolerate far more staleness than the
  window; callers needing a linearizable listing should hold the raw
  provider.

The dispatcher is NOT itself a FabricProvider: ``add_resource``/
``remove_resource`` take an ``on_ready`` latch and raise dispatch sentinels,
which only the resource controller understands. Pass-through verbs
(``check_resource``, slice transactions) pass the raw provider through
unchanged so existing callers keep their synchronous semantics.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

from tpu_composer_torch.api.types import ComposableResource
from tpu_composer_torch.fabric.events import (
    EVENT_OP_COMPLETED,
    FabricEvent,
    FabricSession,
)
from tpu_composer_torch.fabric.provider import (
    AttachResult,
    DeviceHealth,
    DispatchedAttaching,
    DispatchedDetaching,
    FabricDevice,
    FabricError,
    FabricProvider,
    UnsupportedBatch,
    WaitingDeviceAttaching,
    WaitingDeviceDetaching,
)
from tpu_composer_torch.runtime import tracing
from tpu_composer_torch.runtime.contention import BusyTracker, ObservedLock
from tpu_composer_torch.runtime.metrics import (
    fabric_batch_size,
    fabric_calls_total,
    fabric_completion_latency,
    fabric_event_resyncs_total,
    fabric_inflight,
    fabric_poll_fallbacks_total,
    fabric_reads_coalesced_total,
)

VERB_ADD = "add"
VERB_REMOVE = "remove"

_GROUP_VERBS = {VERB_ADD: "add_resources", VERB_REMOVE: "remove_resources"}
_SINGLE_VERBS = {VERB_ADD: "add_resource", VERB_REMOVE: "remove_resource"}
_WAIT_SENTINELS = {VERB_ADD: WaitingDeviceAttaching, VERB_REMOVE: WaitingDeviceDetaching}
_DISPATCH_SENTINELS = {VERB_ADD: DispatchedAttaching, VERB_REMOVE: DispatchedDetaching}

# op states
_QUEUED = "queued"  # in its lane's FIFO, not yet issued to the provider
_INFLIGHT = "inflight"  # a worker is executing a provider call for it
_PENDING = "pending"  # provider answered a wait sentinel; dispatcher re-polls
_DONE = "done"  # outcome parked for the next reconcile to consume


class _Op:
    __slots__ = (
        "verb", "resource", "node", "name", "on_ready", "state",
        "result", "error", "submitted", "next_poll", "wait_msg", "ctx",
        "doorbell", "evented", "was_pending", "after",
    )

    def __init__(self, verb: str, resource: ComposableResource, now: float) -> None:
        self.verb = verb
        self.resource = resource
        self.node = resource.spec.target_node
        self.name = resource.metadata.name
        self.on_ready: List[Callable[[], None]] = []
        self.state = _QUEUED
        self.result: Optional[AttachResult] = None
        self.error: Optional[Exception] = None
        self.submitted = now
        self.next_poll = 0.0
        self.wait_msg = ""
        # Event-plane bookkeeping: ``doorbell`` is a one-shot "a completion
        # event arrived" flag consumed to schedule an immediate re-poll
        # (covering the event-lands-while-op-is-INFLIGHT race); ``evented``
        # is sticky — any event ever touched this op, so a terminal settle
        # was push-driven, not a safety-net catch; ``was_pending`` marks
        # ops that parked fabric-pending at least once (only those can
        # count as poll fallbacks).
        self.doorbell = False
        self.evented = False
        self.was_pending = False
        # Migration-ordered op pairs: this op may not be ISSUED to the
        # provider while the named (verb, resource) op is still live in
        # the dispatcher — the live-migration guarantee that a source
        # member's detach can never overtake its replacement's attach,
        # enforced at the fabric boundary as defense-in-depth below the
        # controller's make-before-break sequencing. Gone/settled target
        # = no constraint (the attach already reached the fabric or never
        # will through this process).
        self.after: Optional[Tuple[str, str]] = None
        # Causal handoff from the submitting reconcile span (trace_id = the
        # durable pending_op nonce): the execute pass links it into the
        # dispatch span, and completion spans re-hand it to the requeue.
        self.ctx: Optional[tracing.TraceContext] = None

    @property
    def key(self) -> Tuple[str, str]:
        return (self.verb, self.name)


class _Lane:
    """Per-node submission lane: FIFO of queued ops + fabric-pending ops."""

    __slots__ = ("fifo", "pending", "busy")

    def __init__(self) -> None:
        self.fifo: Deque[_Op] = collections.deque()
        self.pending: Dict[str, _Op] = {}  # name -> op awaiting fabric completion
        self.busy = False

    def idle(self) -> bool:
        return not self.fifo and not self.pending and not self.busy


class FabricDispatcher:
    def __init__(
        self,
        provider: FabricProvider,
        batch_window: float = 0.02,
        concurrency: int = 8,
        poll_interval: float = 0.25,
        max_batch: int = 16,
        snapshot_ttl: float = 0.05,
        done_ttl: float = 300.0,
        owns: Optional[Callable[[str], bool]] = None,
        fallback_multiplier: float = 20.0,
    ) -> None:
        self.provider = provider
        # Shard fencing gate: owns(resource_name) -> bool, None = every key
        # is ours (unsharded). Checked immediately before provider calls
        # are issued and enforced wholesale by abandon_unowned() when a
        # shard lease is lost — a fenced replica must stop mutating the
        # shard's keys before a successor can steal the lease.
        self._owns = owns
        self.batch_window = max(0.0, batch_window)
        self.concurrency = max(1, concurrency)
        self.poll_interval = max(0.001, poll_interval)
        self.max_batch = max(1, max_batch)
        # Listing staleness bound. Independent of the batch window: an
        # attach wave's per-node gauge refreshes arrive spread over the
        # whole wave, not within one coalescing window, and the consumers
        # (composed-chips gauge, 60 s anti-drift syncer) tolerate far more
        # than 50 ms.
        self.snapshot_ttl = snapshot_ttl
        self.done_ttl = done_ttl
        # Event plane (fabric/events.py): while an attached FabricSession
        # is streaming, completion events settle fabric-pending ops and the
        # per-op safety-net poll parks at poll_interval * fallback_multiplier
        # instead of the hot loop; session loss snaps parked polls back to
        # poll_interval. No session (the TPUC_FABRIC_EVENTS=0 escape hatch,
        # and every pre-event-plane caller) keeps the poll-driven path
        # bit-identical.
        self.fallback_multiplier = max(1.0, fallback_multiplier)
        self._session = None
        self.log = logging.getLogger("FabricDispatcher")
        # Contention telemetry: the dispatcher lock is one of the hottest
        # in the process (every submission, settle, snapshot read and
        # worker turn crosses it). ObservedLock records acquire-wait and
        # hold time; Condition parks are excluded by the wrapper's
        # _release_save/_acquire_restore protocol. Reentrant because a
        # bare Condition() wraps an RLock and the submission facade
        # re-enters (lazy start() under _call's hold).
        self._cond = threading.Condition(
            ObservedLock("dispatcher", reentrant=True)
        )
        # Lane saturation: busy seconds per worker turn (provider calls),
        # level-set into tpuc_worker_busy_ratio{pool="fabric-dispatch"}.
        self._busy = BusyTracker("fabric-dispatch", workers=self.concurrency)
        # Liveness hook (wired by cmd/main when the watchdog is enabled):
        # lane workers beat under their thread name every turn/idle wake
        # (bounded by the 5s idle cond timeout, far inside the default
        # stall threshold).
        self.watchdog = None
        self._lanes: Dict[str, _Lane] = {}
        self._ops: Dict[Tuple[str, str], _Op] = {}  # live (queued/inflight/pending)
        self._done: Dict[Tuple[str, str], Tuple[_Op, float]] = {}
        self._threads: List[threading.Thread] = []
        self._started = False
        self._shutdown = False
        # Draining: stop accepting NEW submissions while in-flight and
        # parked work settles (graceful shutdown / leader handoff). Unlike
        # _shutdown, workers keep running so queued ops reach the fabric
        # and completions can still be consumed by live reconciles.
        self._draining = False
        # Capability probe result: None = unknown, False = provider raised
        # UnsupportedBatch once (skip group attempts from then on).
        self._group_verbs_ok: Optional[bool] = None
        # get_resources single-flight + snapshot micro-cache.
        self._snap: Optional[List[FabricDevice]] = None
        self._snap_time = -1e9
        self._snap_err: Optional[Exception] = None
        self._snap_inflight = False

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> None:
        with self._cond:
            if self._started or self._shutdown:
                return
            self._started = True
            for i in range(self.concurrency):
                t = threading.Thread(
                    target=self._worker_loop, name=f"fabric-dispatch-{i}",
                    daemon=True,
                )
                t.start()
                self._threads.append(t)

    def stop(self, flush: bool = True) -> None:
        """Stop workers and clear dispatcher state.

        ``flush=True`` (the in-process stop/start path) fires every
        unfired ``on_ready`` latch — queued submissions that never reached
        the fabric AND parked ``_done`` outcomes nobody consumed — before
        clearing, so a still-running (or restarting) controller gets an
        immediate requeue and re-drives via the idempotent verbs instead
        of silently losing a completed attach result until its poll-timer
        safety net fires. ``flush=False`` (see :meth:`kill`) abandons
        everything, modeling a process crash."""
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()
        callbacks: List[Callable[[], None]] = []
        with self._cond:
            if flush:
                for op in self._ops.values():
                    callbacks.extend(op.on_ready)
                    op.on_ready = []
                for op, _ in self._done.values():
                    callbacks.extend(op.on_ready)
                    op.on_ready = []
            # Abandoned ops are safe: every verb is idempotent and the
            # controllers' poll-timer fallback (plus the cold-start
            # adoption pass reading the durable intent records) re-submits
            # after restart.
            self._lanes.clear()
            self._ops.clear()
            self._done.clear()
            fabric_inflight.set(0)
        for cb in callbacks:
            try:
                cb()
            except Exception:
                self.log.exception("on_ready latch failed during stop flush")

    def kill(self) -> None:
        """Hard stop: abandon queued ops and parked outcomes without firing
        latches — the closest in-process analog of SIGKILL. Used by the
        kill–restart soak harness; production shutdown uses drain+stop."""
        self.stop(flush=False)

    def drain(self, timeout: float) -> bool:
        """Graceful drain: refuse new submissions, let queued/in-flight/
        fabric-pending ops settle, and wait for parked outcomes to be
        consumed by their (still running) reconciles — all under
        ``timeout`` seconds. Returns True when fully drained.

        The caller (Manager shutdown / leader handoff) must keep the
        controllers running while draining: completions fire ``on_ready``
        latches that re-enqueue CR keys, and those reconciles are what
        consume parked outcomes and persist results before the process
        exits. The lease is released only after this returns."""
        deadline = time.monotonic() + max(0.0, timeout)
        with self._cond:
            self._draining = True
            self._cond.notify_all()
            while True:
                if not self._ops and not self._done:
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._shutdown:
                    drained = not self._ops and not self._done
                    if not drained:
                        self.log.warning(
                            "drain timed out with %d live op(s) and %d"
                            " unconsumed outcome(s); relying on durable"
                            " intent + adoption after restart",
                            len(self._ops), len(self._done),
                        )
                    return drained
                self._cond.wait(timeout=min(0.05, remaining))

    def run(self, stop_event: threading.Event) -> None:
        """Manager runnable: start workers, park until shutdown."""
        self.start()
        stop_event.wait()
        self.stop()

    # ------------------------------------------------------------------
    # submission facade (the resource controller's fabric write path)
    # ------------------------------------------------------------------
    def add_resource(
        self, resource: ComposableResource,
        on_ready: Optional[Callable[[], None]] = None,
    ) -> AttachResult:
        return self._call(VERB_ADD, resource, on_ready)

    def remove_resource(
        self, resource: ComposableResource,
        on_ready: Optional[Callable[[], None]] = None,
        after: Optional[Tuple[str, str]] = None,
    ) -> None:
        """``after=(verb, name)`` orders this detach behind another op:
        it is not issued to the provider while that op is still live here
        (migration-ordered pairs — a migrating source's detach parks
        behind its replacement's attach)."""
        return self._call(VERB_REMOVE, resource, on_ready, after=after)

    def _call(
        self,
        verb: str,
        resource: ComposableResource,
        on_ready: Optional[Callable[[], None]],
        after: Optional[Tuple[str, str]] = None,
    ) -> Optional[AttachResult]:
        name = resource.metadata.name
        key = (verb, name)
        with self._cond:
            done = self._done.pop(key, None)
            if done is not None:
                # Wake drain(): consuming a parked outcome may empty _done.
                self._cond.notify_all()
                op = done[0]
                if op.error is not None:
                    raise op.error
                return op.result
            op = self._ops.get(key)
            if op is None:
                if self._shutdown:
                    raise _DISPATCH_SENTINELS[verb](
                        f"{name}: dispatcher stopped; resubmit after restart"
                    )
                if self._draining:
                    # Graceful drain window: in-flight work settles, but no
                    # NEW fabric mutations start — the successor (or the
                    # restarted process) re-submits from durable state.
                    raise _DISPATCH_SENTINELS[verb](
                        f"{name}: dispatcher draining; resubmit after restart"
                    )
                self.start()  # lazy start: facade usable without wiring order
                op = _Op(verb, resource, time.monotonic())
                if after is not None and after != op.key:
                    op.after = after
                active = tracing.context()
                if active is not None:
                    # Flow-start on the submitting thread, bound to the
                    # reconcile span doing this submission.
                    op.ctx = active.handoff()
                # A parked outcome of the OPPOSITE verb is stale the moment
                # the state machine moves on (attach result nobody consumed
                # before deletion began, and vice versa).
                self._done.pop((_other(verb), name), None)
                self._ops[key] = op
                lane = self._lanes.setdefault(op.node, _Lane())
                lane.fifo.append(op)
                self._cond.notify_all()
            else:
                # Refresh the resource snapshot (spec/status may have moved)
                # only while still queued — an in-flight call must keep the
                # exact object it was issued with.
                if op.state == _QUEUED:
                    op.resource = resource
                if op.ctx is None:
                    active = tracing.context()
                    if active is not None:
                        op.ctx = active.handoff()
            if on_ready is not None:
                op.on_ready = [on_ready]
            if op.state == _PENDING:
                # The FABRIC answered "in progress" — surface the real wait
                # sentinel so streak/budget accounting sees fabric-side
                # progress exactly as the direct-call path would.
                raise _WAIT_SENTINELS[verb](op.wait_msg or f"{name}: {verb} in progress")
        raise _DISPATCH_SENTINELS[verb](f"{name}: {verb} dispatched")

    def cancel(self, verb: str, name: str) -> bool:
        """Drop a submission that has not reached the provider yet.

        Returns True when nothing took effect at the fabric for
        (verb, name) — the op was still queued (now removed), failed, or
        never existed. False means the provider call already started, the
        fabric holds it pending, OR a completed attach result is parked:
        in every False case the caller must run the op's normal completion
        path (e.g. detach after an uncancellable attach — a parked
        SUCCESSFUL AttachResult means the chips ARE attached, and
        discarding it would leak them until the syncer's orphan sweep)."""
        key = (verb, name)
        with self._cond:
            done = self._done.get(key)
            if done is not None:
                if verb == VERB_ADD and done[0].error is None:
                    return False  # attach materialized — must detach
                del self._done[key]
                return True
            op = self._ops.get(key)
            if op is None:
                return True
            if op.state != _QUEUED:
                return False
            del self._ops[key]
            lane = self._lanes.get(op.node)
            if lane is not None:
                try:
                    lane.fifo.remove(op)
                except ValueError:
                    pass
            # An op ordered `after` this one may be parked on its lane
            # waiting for this key to leave the live table — wake the
            # workers so it re-evaluates now rather than on the next
            # unrelated completion.
            self._cond.notify_all()
            return True

    def abandon_unowned(self) -> int:
        """Shard fence: drop every queued submission, fabric-pending
        re-poll and parked outcome whose resource key this replica no
        longer owns. Nothing is fired or parked — the successor re-derives
        the work from the durable ``pending_op`` intent via its scoped
        adoption pass (the same contract as :meth:`kill`, scoped to the
        lost shard's keys). Ops already executing at the provider settle
        inside the renew-deadline fencing margin. Returns the number of
        ops dropped."""
        if self._owns is None:
            return 0
        dropped = 0
        with self._cond:
            for key in [
                k for k, op in self._ops.items()
                if op.state in (_QUEUED, _PENDING) and not self._owns(op.name)
            ]:
                op = self._ops.pop(key)
                lane = self._lanes.get(op.node)
                if lane is not None:
                    if op.state == _QUEUED:
                        try:
                            lane.fifo.remove(op)
                        except ValueError:
                            pass
                    lane.pending.pop(op.name, None)
                    if self._lanes.get(op.node) is lane and lane.idle():
                        del self._lanes[op.node]
                dropped += 1
            for key in [
                k for k, (op, _) in self._done.items()
                if not self._owns(op.name)
            ]:
                del self._done[key]
                dropped += 1
            if dropped:
                self._cond.notify_all()
        if dropped:
            self.log.warning(
                "shard fence: abandoned %d op(s)/outcome(s) for keys this"
                " replica no longer owns", dropped,
            )
        return dropped

    # ------------------------------------------------------------------
    # event plane (fabric/events.py)
    # ------------------------------------------------------------------
    def attach_session(self, session: FabricSession) -> None:
        """Wire a FabricSession as the primary completion channel.

        An op_completed event is a DOORBELL: it wakes the matching
        fabric-pending op for an immediate shared-pass re-poll — the
        settle still reads authoritative state through the idempotent
        provider verb, so duplicated / reordered / fabricated events can
        at worst cost one redundant wire call, never a wrong settle. A
        sequence gap triggers ONE get_resources() resync; session loss
        snaps every parked poll back to the tight poll_interval."""
        self._session = session
        session.on_event(self._on_fabric_event)
        session.on_gap(self._on_event_gap)
        session.on_state(self._on_session_state)

    def _events_primary(self) -> bool:
        """True while push events are supposed to be delivering — the
        condition under which a timer-driven settle counts as a fallback
        catch (and under which parked polls may stretch)."""
        s = self._session
        return s is not None and s.supported()

    def _park_interval(self) -> float:
        s = self._session
        if s is not None and s.supported() and s.healthy():
            return self.poll_interval * self.fallback_multiplier
        return self.poll_interval

    def _on_fabric_event(self, ev: FabricEvent) -> None:
        if ev.type != EVENT_OP_COMPLETED or ev.verb not in _GROUP_VERBS:
            return
        key = (ev.verb, ev.resource)
        with self._cond:
            op = self._ops.get(key)
            if op is None:
                return  # already settled (or never ours): nothing to wake
            if ev.nonce:
                po = op.resource.status.pending_op
                if po is not None and po.nonce and po.nonce != ev.nonce:
                    # A completion from an EARLIER incarnation of this
                    # logical op (pre-crash intent, replayed stream):
                    # waking on it would be harmless, but matching the
                    # nonce keeps event-driven accounting honest.
                    return
            op.evented = True
            if op.state == _PENDING:
                op.next_poll = 0.0
                self._cond.notify_all()
            else:
                # Queued/inflight: the provider call racing this event may
                # still answer a wait sentinel — remember the doorbell so
                # the park that follows re-polls immediately instead of
                # waiting out a (possibly stretched) quantum.
                op.doorbell = True

    def _on_event_gap(self) -> None:
        """Sequence gap: events were lost. One listing resync refreshes
        the shared snapshot for inventory/health consumers, and every
        fabric-pending op re-polls immediately — a lost completion costs
        one get_resources, not a silent stretched-poll wait."""
        fabric_event_resyncs_total.inc()
        with self._cond:
            self._snap_time = -1e9  # force a fresh listing, not the cache
        try:
            self.get_resources()
        except Exception as e:
            self.log.warning("gap resync listing failed: %s", e)
        with self._cond:
            now = time.monotonic()
            for lane in self._lanes.values():
                for op in lane.pending.values():
                    op.next_poll = min(op.next_poll, now)
            self._cond.notify_all()

    def _on_session_state(self, healthy: bool) -> None:
        if healthy:
            return
        # Snap back: parked polls stretched while the stream was healthy
        # must not ride out their long quantum now that nobody will ring
        # the doorbell — cap every pending op at one tight poll_interval.
        with self._cond:
            cap = time.monotonic() + self.poll_interval
            changed = False
            for lane in self._lanes.values():
                for op in lane.pending.values():
                    if op.next_poll > cap:
                        op.next_poll = cap
                        changed = True
            if changed:
                self._cond.notify_all()

    # ------------------------------------------------------------------
    # shared snapshot reads
    # ------------------------------------------------------------------
    def get_resources(self) -> List[FabricDevice]:
        with self._cond:
            while True:
                now = time.monotonic()
                if now - self._snap_time <= self.snapshot_ttl:
                    if self._snap_err is not None:
                        raise self._snap_err
                    fabric_reads_coalesced_total.inc()
                    return list(self._snap or [])
                if not self._snap_inflight:
                    self._snap_inflight = True
                    break
                self._cond.wait(timeout=1.0)
        snap: Optional[List[FabricDevice]] = None
        err: Optional[Exception] = None
        try:
            snap = self.provider.get_resources()
        except Exception as e:  # parked for every coalesced waiter
            err = e
        fabric_calls_total.inc(verb="get_resources", batched="false")
        with self._cond:
            self._snap, self._snap_err = snap, err
            self._snap_time = time.monotonic()
            self._snap_inflight = False
            self._cond.notify_all()
        if err is not None:
            raise err
        return list(snap or [])

    # pass-through verbs: synchronous callers keep the raw provider contract
    def check_resource(self, resource: ComposableResource) -> DeviceHealth:
        return self.provider.check_resource(resource)

    def __getattr__(self, name: str) -> object:
        return getattr(self.provider, name)

    # ------------------------------------------------------------------
    # worker side
    # ------------------------------------------------------------------
    #: Fleet identity tagging lane threads' trace events (set by the
    #: owning Manager alongside the controllers' replica_id).
    replica_id: Optional[str] = None

    def _worker_loop(self) -> None:
        if self.replica_id:
            tracing.bind_thread(self.replica_id)
        wd, wd_name = self.watchdog, threading.current_thread().name
        try:
            while True:
                with self._cond:
                    task = None
                    while task is None:
                        if self._shutdown:
                            return
                        if wd is not None:
                            # Beat per wake (idle waits are ≤5s, well
                            # inside the default stall threshold). The
                            # watchdog's plain lock nests safely under
                            # the dispatcher cond's ObservedLock.
                            wd.beat(wd_name)
                        now = time.monotonic()
                        self._sweep_done(now)
                        task, wake = self._next_task(now)
                        if task is None:
                            self._busy.add(0.0)  # idle wake advances the window
                            # Bounded even when no work is queued: a fully
                            # idle pool must keep feeding the busy tracker or
                            # tpuc_worker_busy_ratio freezes at its last
                            # (possibly saturated) value for the whole idle
                            # stretch.
                            self._cond.wait(
                                timeout=wake if wake is not None else 5.0
                            )
                lane, verb, ops = task
                turn_t0 = time.monotonic()
                try:
                    self._execute(verb, ops)
                finally:
                    self._busy.add(time.monotonic() - turn_t0)
                    fired: List[Tuple[_Op, List[Callable[[], None]]]] = []
                    with self._cond:
                        lane.busy = False
                        for op in ops:
                            # Fire but RETAIN the latch (each reconcile pass
                            # re-registers, replacing the list, so it stays at
                            # one entry): a parked outcome keeps its latch so an
                            # in-process stop() can re-fire it — without this, a
                            # restart between completion and consumption would
                            # silently strand the result until a poll timer.
                            if op.on_ready:
                                fired.append((op, list(op.on_ready)))
                        # Prune empty lanes so churning fleets don't grow the
                        # lane map forever (O(1): a batch shares one node).
                        node = ops[0].node
                        if self._lanes.get(node) is lane and lane.idle():
                            del self._lanes[node]
                        self._cond.notify_all()
                    for op, callbacks in fired:
                        # The completion side of the causal chain: a short span
                        # in the op's trace wraps the latch, so the queue.add
                        # the latch performs hands a flow off to the next
                        # reconcile — Perfetto shows dispatch -> completion ->
                        # requeued reconcile as connected arrows across threads.
                        ctx = (
                            tracing.TraceContext(trace_id=op.ctx.trace_id)
                            if op.ctx is not None else None
                        )
                        with tracing.span(
                            "dispatch.complete", cat="dispatcher",
                            resource=op.name, verb=op.verb, state=op.state,
                            ctx=ctx,
                        ):
                            for cb in callbacks:
                                try:
                                    cb()
                                except Exception:
                                    self.log.exception("on_ready latch failed")
        finally:
            if wd is not None:
                # A clean shutdown must not race the final scan into a
                # phantom stall.
                wd.unregister(wd_name)

    def _next_task(
        self, now: float
    ) -> Tuple[Optional[Tuple["_Lane", str, List["_Op"]]], Optional[float]]:
        """Pick one lane turn: a window-expired FIFO batch, or a due shared
        poll of fabric-pending ops. Returns (task, wait_hint_seconds)."""
        wake: Optional[float] = None
        for lane in self._lanes.values():
            if lane.busy:
                continue
            # Due fabric-side polls first: they represent the oldest work.
            due = [op for op in lane.pending.values() if op.next_poll <= now]
            if due:
                verb = due[0].verb
                ops = [op for op in due if op.verb == verb][: self.max_batch]
                for op in ops:
                    op.state = _INFLIGHT
                    del lane.pending[op.name]
                lane.busy = True
                return (lane, verb, ops), None
            if lane.fifo:
                head = lane.fifo[0]
                ready_at = head.submitted + self.batch_window
                if ready_at <= now:
                    ops = self._take_batch(lane)
                    if ops:
                        lane.busy = True
                        return (lane, ops[0].verb, ops), None
                    # head blocked behind an engaged sibling — re-check when
                    # that op completes (cond is notified then).
                else:
                    wake = ready_at - now if wake is None else min(wake, ready_at - now)
            for op in lane.pending.values():
                hint = op.next_poll - now
                wake = hint if wake is None else min(wake, hint)
        return None, (max(0.001, wake) if wake is not None else None)

    def _take_batch(self, lane: _Lane) -> List[_Op]:
        """Longest same-verb FIFO prefix, capped at max_batch, stopping at
        any op whose resource still has an earlier op engaged with the
        fabric (per-resource serialization: a detach must never be issued
        while its attach is still materializing, and vice versa) — or at
        an op ordered ``after`` another op that is still live anywhere in
        the dispatcher (migration pairs: the source detach parks, possibly
        cross-lane, until its replacement's attach settles; that settle
        notifies the condition and this lane re-evaluates)."""
        ops: List[_Op] = []
        verb = lane.fifo[0].verb
        engaged = set(lane.pending)
        while lane.fifo and len(ops) < self.max_batch:
            op = lane.fifo[0]
            if op.verb != verb or op.name in engaged:
                break
            if op.after is not None:
                blocker = self._ops.get(op.after)
                if blocker is not None and blocker is not op:
                    break
                op.after = None  # settled or gone — constraint retired
            lane.fifo.popleft()
            op.state = _INFLIGHT
            ops.append(op)
        return ops

    # -- execution (no dispatcher lock held) ----------------------------
    def _execute(self, verb: str, ops: List[_Op]) -> None:
        # One parent span per lane turn. A single-member turn JOINS the
        # member's trace (ctx consumes its flow); a batched turn stays
        # trace-neutral but links every member's submission flow into
        # itself — the "parent span with per-member links" shape, so
        # Perfetto draws N arrows from N reconcile spans into one group
        # call and back out via each member's completion span.
        single_ctx = ops[0].ctx if len(ops) == 1 else None
        with tracing.span(
            f"dispatch.{verb}", cat="dispatcher", node=ops[0].node,
            members=len(ops), ctx=single_ctx,
        ) as sp:
            if single_ctx is None:
                for op in ops:
                    tracing.link(op.ctx)
                sp["resources"] = ",".join(op.name for op in ops[:16])
            else:
                sp["resource"] = ops[0].name
            self._execute_inner(verb, ops)

    def _drop_fenced(self, ops: List[_Op]) -> List[_Op]:
        """Last-line shard fence: an op taken from its lane after the
        fence raced abandon_unowned() must still never reach the provider
        under a lost shard's key."""
        if self._owns is None:
            return ops
        fenced = [op for op in ops if not self._owns(op.name)]
        if not fenced:
            return ops
        with self._cond:
            for op in fenced:
                self._ops.pop(op.key, None)
        self.log.warning(
            "shard fence: refusing %d op(s) for unowned key(s) %s",
            len(fenced), ",".join(op.name for op in fenced[:8]),
        )
        return [op for op in ops if self._owns(op.name)]

    def _execute_inner(self, verb: str, ops: List[_Op]) -> None:
        ops = self._drop_fenced(ops)
        if not ops:
            return
        fabric_inflight.inc(len(ops))
        try:
            if len(ops) > 1 and self._group_verbs_ok is not False:
                group = getattr(self.provider, _GROUP_VERBS[verb])
                try:
                    outcomes = group([op.resource for op in ops])
                except UnsupportedBatch:
                    self._group_verbs_ok = False
                else:
                    if self._group_verbs_ok is None:
                        self._group_verbs_ok = True
                    fabric_calls_total.inc(verb=verb, batched="true")
                    fabric_batch_size.observe(len(ops), verb=verb)
                    if isinstance(outcomes, list) and len(outcomes) == len(ops):
                        for op, out in zip(ops, outcomes):
                            self._settle(op, out)
                        return
                    # Malformed provider response: treat as whole-call
                    # failure below (split retry), never drop outcomes.
                    self.log.error(
                        "%s returned %d outcomes for %d members; splitting",
                        _GROUP_VERBS[verb], len(outcomes) if isinstance(outcomes, list) else -1,
                        len(ops),
                    )
            self._execute_singles(verb, ops)
        except Exception:
            # Whole group call raised (transport fault, dead endpoint,
            # chaos): failure splitting — retry member-by-member so one bad
            # member can't poison the group and accounting stays
            # per-resource.
            fabric_calls_total.inc(verb=verb, batched="true")
            fabric_batch_size.observe(len(ops), verb=verb)
            self._execute_singles(verb, ops)
        finally:
            fabric_inflight.inc(-len(ops))

    def _execute_singles(self, verb: str, ops: List[_Op]) -> None:
        single = getattr(self.provider, _SINGLE_VERBS[verb])
        for op in ops:
            try:
                out = single(op.resource)
            except Exception as e:
                out = e
            fabric_calls_total.inc(verb=verb, batched="false")
            self._settle(op, out)

    def _settle(self, op: _Op, outcome: object) -> None:
        """Record one member's outcome: result, fabric wait, or error."""
        now = time.monotonic()
        with self._cond:
            if self._owns is not None and not self._owns(op.name):
                # Shard lost while the provider call was in flight: do not
                # park the outcome — the key's new owner re-reads fabric
                # state via its scoped adoption pass, and a parked result
                # here would only stall this replica's graceful drains.
                self._ops.pop(op.key, None)
                return
            lane = self._lanes.setdefault(op.node, _Lane())
            if isinstance(outcome, _WAIT_SENTINELS[op.verb]):
                op.state = _PENDING
                op.was_pending = True
                op.wait_msg = str(outcome)
                if op.doorbell:
                    # A completion event landed while this call was in
                    # flight: re-poll NOW — the fabric already finished.
                    op.doorbell = False
                    op.next_poll = now
                else:
                    # Streaming session: park long (the event is the wake
                    # signal, the poll only a safety net). No session, or
                    # session down/unsupported: the tight quantum is the
                    # primary completion path, exactly as before.
                    op.next_poll = now + self._park_interval()
                lane.pending[op.name] = op
                # Fall through to fire on_ready (collected by the worker):
                # the reconciler gets one immediate pass that observes the
                # REAL wait sentinel, resetting streaks exactly as the
                # direct-call path would on fabric-side progress.
                return
            if op.was_pending and not op.evented and self._events_primary():
                # The safety net caught a completion the stream should
                # have pushed — the "degraded to polling" signal.
                fabric_poll_fallbacks_total.inc(verb=op.verb)
            op.state = _DONE
            if isinstance(outcome, Exception):
                op.error = outcome
            else:
                op.result = outcome if op.verb == VERB_ADD else None
            self._ops.pop(op.key, None)
            self._done[op.key] = (op, now)
            fabric_completion_latency.observe(
                now - op.submitted, verb=op.verb,
                outcome="error" if op.error is not None else "ok",
            )

    def _sweep_done(self, now: float) -> None:
        """Unconsumed outcomes (CR deleted before its requeue ran) rot away
        after done_ttl so the parking table can't grow unboundedly."""
        if not self._done:
            return
        stale = [k for k, (_, t) in self._done.items() if now - t > self.done_ttl]
        for k in stale:
            del self._done[k]

    # -- introspection (tests / debugging) ------------------------------
    def op_state(self, verb: str, name: str) -> Optional[str]:
        with self._cond:
            if (verb, name) in self._done:
                return _DONE
            op = self._ops.get((verb, name))
            return op.state if op is not None else None


def _other(verb: str) -> str:
    return VERB_REMOVE if verb == VERB_ADD else VERB_ADD
