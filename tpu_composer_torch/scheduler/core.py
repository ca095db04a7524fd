"""ClusterScheduler — the placement authority the request controller asks.
(Port of ``tpu_composer/scheduler/core.py``.)

One facade over the four scheduler pieces:

- :class:`~tpu_composer_torch.scheduler.placement.PlacementEngine` scores and
  picks host sets (fragmentation-aware bin-packing + ICI contiguity);
- :class:`~tpu_composer_torch.scheduler.queue.SchedulerQueue` remembers who is
  waiting, at what priority, for what gang demand;
- :class:`~tpu_composer_torch.scheduler.preemption.Preemptor` computes minimal
  victim sets when a high-priority demand cannot fit;
- :class:`~tpu_composer_torch.scheduler.defrag.DefragPlanner` (driven separately
  by the DefragLoop runnable) proposes migrations that reassemble
  contiguous capacity.

``place()`` is the one entry point for fresh slice placements and returns a
:class:`Placement` that either names the hosts (success), names the victims
the caller must evict first (preemption), or raises
:class:`~tpu_composer_torch.scheduler.placement.AllocationError` (queue and
retry). The caller is expected to serialize calls (the request controller's
allocation lock) — the queue itself is thread-safe, but two concurrent
placements would double-book capacity exactly as the inline allocator
would have.

Every decision additionally explains itself through the
:class:`~tpu_composer_torch.scheduler.ledger.DecisionLedger` (when constructed —
``decisions=False`` / TPUC_DECISIONS=0 skips all of it): a placement
records the candidates it considered with per-node verdicts and the
tiebreak that picked the winners; a hold-back records the binding
constraint (which resource, how short); a preemption records the victim
set with its minimality rationale. ``/debug/scheduler/explain/<name>``
serves the ring.
"""

from __future__ import annotations

import contextlib
import threading
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from tpu_composer_torch.api.types import ComposabilityRequest
from tpu_composer_torch.runtime import tracing
from tpu_composer_torch.runtime.metrics import (
    scheduler_fragmentation_score,
    scheduler_held_back_total,
    scheduler_queue_depth,
    scheduler_time_to_placement_seconds,
)
from tpu_composer_torch.scheduler import ledger as ledger_mod
from tpu_composer_torch.scheduler import native as sched_native
from tpu_composer_torch.scheduler.defrag import DefragPlanner
from tpu_composer_torch.scheduler.ledger import DecisionLedger, DecisionRecord
from tpu_composer_torch.scheduler.placement import AllocationError, PlacementEngine
from tpu_composer_torch.scheduler.preemption import Preemptor
from tpu_composer_torch.scheduler.snapshot import ChipIndexSnapshot
from tpu_composer_torch.scheduler.queue import PendingEntry, SchedulerQueue
from tpu_composer_torch.topology.slices import SliceShape

#: Inputs-digest bounds: a 10k-node cluster must not serialize 10k-entry
#: maps into every record — past the cap the digest keeps the distribution
#: (free-ports -> host count) instead of the per-node map.
_DIGEST_NODE_CAP = 64
# The ledger owns the candidates-per-record truncation policy; the
# scheduler threads it into the engine's verdict scan so no more than
# this many candidate dicts are ever materialized per decision.
_CANDIDATE_CAP = ledger_mod.CANDIDATE_CAP


@dataclass
class Placement:
    """Outcome of a placement decision: hosts to use, or victims to evict
    first (mutually exclusive — victims non-empty means no hosts yet)."""

    nodes: List[str] = field(default_factory=list)
    victims: List[str] = field(default_factory=list)


def _rejection_class(verdict: str) -> str:
    """Collapse a per-node verdict into the binding-resource vocabulary
    the held-back metric labels with."""
    if verdict.startswith("no-tpu-ports"):
        return "tpu-ports"
    if verdict == "node-resources":
        return "node-resources"
    if verdict == "quarantined":
        return "quarantined"
    if verdict in ("not-ready", "cordoned"):
        return "node-unavailable"
    return verdict


class ClusterScheduler:
    def __init__(
        self,
        store,
        defrag_mode: str = "delete",
        decisions: bool = True,
        recorder=None,  # duck-typed EventRecorder for ledger events
        native_sched: Optional[bool] = None,  # None = TPUC_NATIVE_SCHED
    ) -> None:
        self.store = store
        # Snapshot + native-kernel layer (TPUC_NATIVE_SCHED, default on):
        # incrementally-maintained packed arrays replace the per-decision
        # store walks, and the fit/verdict/victim scans run in the port's
        # native/tpusched.cc, built at first use (a failed build raises).
        # The snapshot declines stores it cannot watch losslessly (e.g.
        # chaos wrappers); the engine then walks the store, with
        # bit-identical decisions.
        if native_sched is None:
            native_sched = sched_native.native_sched_enabled()
        self.snapshot: Optional[ChipIndexSnapshot] = None
        native = None
        if native_sched:
            try:
                snap = ChipIndexSnapshot(store)
            except Exception:
                snap = None
            if snap is not None and snap.active:
                self.snapshot = snap
                native = sched_native.native_lib()
        self.engine = PlacementEngine(
            store, snapshot=self.snapshot, native=native
        )
        self.queue = SchedulerQueue()
        self.preemptor = Preemptor(store, self.engine)
        # THE allocation lock: the request controller serializes its
        # placement passes on it, and the defrag executor takes it around
        # each verify+delete — without the shared lock, defrag's capacity
        # re-verification could be invalidated by a concurrent placement
        # between its check and its delete, evicting a Running worker
        # with nowhere to re-land.
        self.alloc_lock = threading.Lock()
        # Decision ledger (scheduler/ledger.py): every decision records
        # its inputs, candidates, choice rationale and binding constraint.
        # decisions=False (cmd/main --no-decisions / TPUC_DECISIONS=0)
        # constructs NONE of it — no records, no verdict scans, no events.
        self.ledger: Optional[DecisionLedger] = (
            DecisionLedger(recorder=recorder) if decisions else None
        )
        # defrag_mode="migrate" (cmd/main's default with live migration
        # enabled) makes the executor emit evacuation marks the owners'
        # migration drivers act on make-before-break; "delete" keeps the
        # legacy delete/re-solve executor (escape hatch + direct tests).
        self.defrag = DefragPlanner(
            store, self.engine, queue=self.queue, lock=self.alloc_lock,
            mode=defrag_mode, decision_ledger=self.ledger,
        )

    # ------------------------------------------------------------------
    def place(
        self,
        req: ComposabilityRequest,
        shape: SliceShape,
        quarantined: Set[str],
    ) -> Placement:
        """Arbitrated placement for a fresh slice allocation."""
        # One store pass, two views: `occupied` (every live claim — what
        # the gate and the fragmentation gauge must see) and `used` (minus
        # this request's own children — what its own picking must see).
        occupied, used = self.engine.capacity_maps(req.name)
        self.queue.prune(self.store)
        demand = {"num_hosts": shape.num_hosts,
                  "chips_per_host": shape.chips_per_host}
        with self._decision_span(req) as ctx:
            try:
                nodes = self.engine.pick_hosts(
                    req, shape, quarantined, used=used
                )
            except AllocationError:
                self.queue.note_pending(
                    req, shape.num_hosts, shape.chips_per_host
                )
                self._update_gauges(quarantined, occupied)
                victims = self.preemptor.compute_victims(
                    req, shape, quarantined, used
                )
                if victims:
                    self._record_preempt(
                        req, demand, victims, quarantined, occupied, used,
                        ctx=ctx,
                    )
                    return Placement(victims=victims)
                self._hold_back(
                    req, demand, quarantined, occupied, used,
                    chips=shape.chips_per_host, ctx=ctx,
                )
                raise
            self._admit(
                req, {n: shape.chips_per_host for n in nodes}, occupied,
                quarantined,
                pending_demand=(shape.num_hosts, shape.chips_per_host),
                ctx=ctx,
            )
            self._record_placed(
                req, ledger_mod.KIND_PLACE, demand, nodes, quarantined,
                occupied, used, chips=shape.chips_per_host, ctx=ctx,
            )
            self._assume(req.name, nodes, shape.chips_per_host)
        return Placement(nodes=nodes)

    def place_scalar(
        self,
        req: ComposabilityRequest,
        count: int,
        existing,
        quarantined: Set[str],
    ) -> List[str]:
        """Arbitrated scalar (gpu/cxlmemory) placement: scalar devices
        consume the same per-host ports as slice workers, so they go
        through the same pending queue and backfill gate — a priority-0
        gpu request must not grab the last free port a feasible
        higher-priority slice is queued for. No preemption, though:
        evicting a gang for an independent device is never worth the
        disruption, and scalar requests themselves recover by waiting."""
        occupied, used = self.engine.capacity_maps(req.name)
        self.queue.prune(self.store)
        # Demand bookkeeping for the gate's feasibility probes: pinned /
        # samenode requests need ONE host with room for the DELTA
        # (anchored — growth can't move elsewhere); spread policies need
        # `count` hosts with one port each. The demand must be the delta,
        # not delta+held: probes run against the full `occupied` map,
        # which already counts the devices the request holds — adding
        # them again would double-count and make the gate call a
        # satisfiable anchored request 'unsatisfiable', dropping its
        # protection exactly when it needs it.
        res = req.spec.resource
        existing = list(existing)
        exclude: tuple = ()
        if res.target_node:
            anchor = res.target_node
            demand = (1, count)
        elif res.allocation_policy == "samenode":
            # One host must take the whole delta; a not-yet-anchored
            # request can still land anywhere (anchor "").
            anchor = existing[0] if existing else ""
            demand = (1, count)
        else:
            anchor = ""
            demand = (count, 1)
            if res.allocation_policy == "differentnode":
                # Growth can only land on UNUSED nodes; a probe counting
                # the request's own hosts would overreport feasibility.
                exclude = tuple(sorted(set(existing)))
        demand_doc = {"num_hosts": demand[0], "chips_per_host": demand[1]}
        # Verdict probes must mirror the picker: an anchored demand needs
        # the anchor to fit EVERYTHING the request puts there (already-held
        # devices + the delta) against the request-excluded map — probing
        # the delta alone would call the anchor 'ok' while the picker
        # rejected it (placement.py pick_scalar_nodes already+count check).
        probe_chips = demand[1]
        if anchor:
            probe_chips += sum(1 for e in existing if e == anchor)
        with self._decision_span(req) as ctx:
            try:
                nodes = self.engine.pick_scalar_nodes(
                    req, count, existing, quarantined, used=used
                )
            except AllocationError:
                self.queue.note_pending(req, *demand, anchor=anchor,
                                        exclude_nodes=exclude)
                self._update_gauges(quarantined, occupied)
                self._hold_back(
                    req, demand_doc, quarantined, occupied, used,
                    chips=probe_chips, exclude=set(exclude),
                    kind=ledger_mod.KIND_PLACE_SCALAR, anchor=anchor,
                    ctx=ctx,
                )
                raise
            add: dict = {}
            for n in nodes:
                add[n] = add.get(n, 0) + 1
            self._admit(req, add, occupied, quarantined,
                        pending_demand=demand, anchor=anchor,
                        exclude_nodes=exclude, ctx=ctx,
                        kind=ledger_mod.KIND_PLACE_SCALAR)
            self._record_placed(
                req, ledger_mod.KIND_PLACE_SCALAR, demand_doc, nodes,
                quarantined, occupied, used,
                chips=probe_chips, ctx=ctx,
                exclude=set(exclude),
            )
            if self.snapshot is not None:
                self.snapshot.assume(req.name, add)
        return nodes

    def _admit(
        self,
        req: ComposabilityRequest,
        add,
        occupied,
        quarantined: Set[str],
        pending_demand,
        anchor: str = "",
        exclude_nodes: tuple = (),
        ctx=None,
        kind: str = ledger_mod.KIND_PLACE,
    ) -> None:
        """Run the backfill gate over a tentative placement (`add`: node ->
        ports it would consume) against the FULL occupancy map — including
        the placer's own holdings, or a grow onto a contended host reads
        as free and slips the gate. On pass, dequeue + record wait
        metrics; on hold raise AllocationError naming the protected
        entry."""
        held = self._gate(req, add, occupied, quarantined)
        if held is not None:
            self.queue.note_pending(req, *pending_demand, anchor=anchor,
                                    exclude_nodes=exclude_nodes)
            scheduler_held_back_total.inc(reason="backfill-gate")
            self._update_gauges(quarantined, occupied)
            self._record_gate_hold(req, pending_demand, held, quarantined,
                                   occupied, ctx=ctx, kind=kind)
            raise AllocationError(
                f"held back: pending request {held.name} (priority"
                f" {held.priority} > {req.spec.priority}) needs this"
                " capacity"
            )
        wait = self.queue.note_placed(req.name)
        if wait is not None:
            scheduler_time_to_placement_seconds.observe(
                wait, type=req.spec.resource.type
            )
        self._update_gauges(quarantined, occupied)

    def place_extra(
        self,
        req: ComposabilityRequest,
        shape: SliceShape,
        exclude: Set[str],
        count: int,
        quarantined: Set[str],
    ) -> List[str]:
        """Grow-path placement for the delta workers of a live slice — and
        the replacement-target channel repair and live migration ride. Not
        gated: the slice already holds its capacity and a live resize must
        not deadlock behind the queue — arbitration happened at admission."""
        demand = {"num_hosts": count, "chips_per_host": shape.chips_per_host}
        with self._decision_span(req) as ctx:
            try:
                nodes = self.engine.pick_slice_hosts(
                    req, shape, exclude=exclude, count=count,
                    quarantined=quarantined,
                )
            except AllocationError:
                if self.ledger is not None:
                    occupied, used = self.engine.capacity_maps(req.name)
                    self._hold_back(
                        req, demand, quarantined, occupied, used,
                        chips=shape.chips_per_host, exclude=exclude,
                        kind=ledger_mod.KIND_PLACE_EXTRA, ctx=ctx,
                    )
                else:
                    scheduler_held_back_total.inc(reason="capacity")
                raise
            if self.ledger is not None:
                occupied, used = self.engine.capacity_maps(req.name)
                self._record_placed(
                    req, ledger_mod.KIND_PLACE_EXTRA, demand, nodes,
                    quarantined, occupied, used,
                    chips=shape.chips_per_host, ctx=ctx, exclude=exclude,
                )
            self._assume(req.name, nodes, shape.chips_per_host)
        return nodes

    def _assume(self, request: str, nodes, chips_per_host: int) -> None:
        """Fold a just-granted placement into the snapshot (no-op without
        one): on an async watch store the placeholder rows the controller
        is about to write are not visible yet, and the next decision under
        the lock must not double-book the granted capacity. Superseded by
        the request's real rows when the watch delivers them."""
        if self.snapshot is None:
            return
        claims: Dict[str, int] = {}
        for n in nodes:
            claims[n] = claims.get(n, 0) + chips_per_host
        self.snapshot.assume(request, claims)

    def forget(self, name: str) -> None:
        """Drop a request from the pending queue (deletion path)."""
        self.queue.forget(name)
        scheduler_queue_depth.set(float(self.queue.depth()))

    def requeue(self, req: ComposabilityRequest, num_hosts: int,
                chips_per_host: int) -> None:
        """Re-register a request whose placement was granted but whose
        execution (fabric reservation) failed — the gate protection must
        come back before the backoff retry, and the depth gauge with it.
        (The time-to-placement sample observed at grant time stands; the
        residual wait is re-measured from here.)"""
        self.queue.note_pending(req, num_hosts, chips_per_host)
        scheduler_queue_depth.set(float(self.queue.depth()))
        if self.ledger is not None:
            self.ledger.record(DecisionRecord(
                request=req.name,
                kind=ledger_mod.KIND_PLACE,
                outcome=ledger_mod.OUTCOME_HELD_BACK,
                priority=req.spec.priority,
                demand={"num_hosts": num_hosts,
                        "chips_per_host": chips_per_host},
                binding={"resource": "fabric-reservation"},
                summary=(
                    "placement granted but the fabric reservation failed;"
                    " re-queued with gate protection until the retry"
                ),
            ))

    # ------------------------------------------------------------------
    # decision-ledger recording (every helper below no-ops cheaply when
    # the ledger is off — the TPUC_DECISIONS=0 path builds nothing)
    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _decision_span(self, req: ComposabilityRequest):
        """A ``scheduler.decide`` span (cat=scheduler) around one decision
        when the ledger is on: the decision id doubles as a trace id, and
        flow handoffs minted inside the span give Perfetto the decision →
        attach arrows. Yields the TraceContext (None when off)."""
        if self.ledger is None or not tracing.enabled():
            yield None
            return
        ctx = tracing.new_trace(f"d-{uuid.uuid4().hex[:10]}")
        with tracing.span(
            "scheduler.decide", cat="scheduler", ctx=ctx, object=req.name,
            decision_id=ctx.trace_id,
        ):
            yield ctx

    def _inputs_digest(
        self, quarantined: Set[str], occupied: Dict[str, int]
    ) -> Dict[str, object]:
        """What the decision saw: free ports per schedulable node (or the
        distribution past the node cap), fragmentation, quarantine set,
        pending-queue depth."""
        free_by_node: Dict[str, int] = {}
        for n in self.engine.schedulable_nodes(quarantined):
            free_by_node[n.metadata.name] = max(
                0, n.status.tpu_slots - occupied.get(n.metadata.name, 0)
            )
        digest: Dict[str, object] = {
            "engine": self.engine.kernel_kind,
            "schedulable_hosts": len(free_by_node),
            "free_chips": sum(free_by_node.values()),
            "fragmentation": round(
                self.engine.fragmentation(quarantined, occupied), 4
            ),
            "queue_depth": self.queue.depth(),
            "quarantined": sorted(quarantined)[:32],
        }
        if len(free_by_node) <= _DIGEST_NODE_CAP:
            digest["free_by_node"] = dict(sorted(free_by_node.items()))
        else:
            dist: Dict[str, int] = {}
            for free in free_by_node.values():
                dist[str(free)] = dist.get(str(free), 0) + 1
            digest["free_distribution"] = dist
        return digest

    def _record_placed(
        self, req, kind, demand, nodes, quarantined, occupied, used,
        chips, ctx, exclude: Set[str] = frozenset(),
    ) -> None:
        if self.ledger is None:
            return
        candidates = self.engine.candidate_verdicts(
            req, chips, quarantined, used, exclude=exclude,
            cap=_CANDIDATE_CAP,
        )
        tiebreak = self.engine.tiebreak_rationale(nodes, used)
        rec = DecisionRecord(
            request=req.name,
            kind=kind,
            outcome=ledger_mod.OUTCOME_PLACED,
            priority=req.spec.priority,
            demand=demand,
            inputs=self._inputs_digest(quarantined, occupied),
            candidates=candidates,
            chosen=list(nodes),
            tiebreak=tiebreak,
            summary=(
                f"placed on {', '.join(nodes)}"
                f" ({demand['num_hosts']}x{demand['chips_per_host']} chips;"
                f" {tiebreak})"
            ),
        )
        if ctx is not None:
            rec.decision_id = ctx.trace_id
            # One flow per planned worker: the resource controller's
            # intent mint consumes them (ledger.link_decision), drawing
            # decision → attach arrows that then ride the nonce trace to
            # Ready.
            rec.flows = [ctx.handoff() for _ in range(len(nodes))]
        self.ledger.record(rec)

    def _hold_back(
        self, req, demand, quarantined, occupied, used, chips,
        exclude: Set[str] = frozenset(),
        kind: str = ledger_mod.KIND_PLACE, anchor: str = "", ctx=None,
    ) -> None:
        """Record a no-capacity hold-back with its binding constraint and
        count it by reason. With the ledger off, only the coarse counter
        moves (no verdict scan); a repeat within the ledger's rescan
        window collapses into the latest record WITHOUT rebuilding the
        candidate verdicts — a queued request's backoff retries must not
        pay O(nodes) scans under the allocation lock per tick."""
        if self.ledger is None:
            scheduler_held_back_total.inc(reason="capacity")
            return
        bumped = self.ledger.bump_if_recent(
            req.name, kind, ledger_mod.OUTCOME_HELD_BACK,
            exclude_resources=("backfill-gate", "fabric-reservation"),
        )
        if bumped is not None:
            scheduler_held_back_total.inc(
                reason=(bumped.binding or {}).get("resource", "capacity")
            )
            return
        candidates = self.engine.candidate_verdicts(
            req, chips, quarantined, used, exclude=exclude
        )
        binding = self._binding_constraint(
            req, demand, candidates, anchor=anchor
        )
        scheduler_held_back_total.inc(reason=binding["resource"])
        fitting = binding.get("fitting_hosts", 0)
        short = binding.get("short_hosts", "")
        self.ledger.record(DecisionRecord(
            request=req.name,
            kind=kind,
            outcome=ledger_mod.OUTCOME_HELD_BACK,
            decision_id=ctx.trace_id if ctx is not None else "",
            priority=req.spec.priority,
            demand=demand,
            inputs=self._inputs_digest(quarantined, occupied),
            candidates=candidates[:_CANDIDATE_CAP],
            binding=binding,
            summary=(
                f"held back: need {demand['num_hosts']} host(s) with"
                f" {demand['chips_per_host']} free TPU port(s), only"
                f" {fitting} fitting — binding: {binding['resource']}"
                + (f", {short} host(s) short" if short else "")
            ),
        ))

    def _binding_constraint(
        self, req, demand, candidates, anchor: str = ""
    ) -> Dict[str, object]:
        """The hold-back's binding constraint: which resource is short and
        by how much, from the candidate verdicts. A pinned demand binds on
        its target node's own verdict; otherwise the dominant rejection
        class among non-fitting nodes names the resource."""
        pinned = anchor or req.spec.resource.target_node
        fitting = sum(1 for c in candidates if c["verdict"] == "ok")
        short = max(0, demand["num_hosts"] - fitting)
        if pinned:
            verdict = next(
                (c["verdict"] for c in candidates if c["node"] == pinned),
                "missing",
            )
            return {
                "resource": "target-node",
                "node": pinned,
                "verdict": verdict,
                "fitting_hosts": fitting,
                "short_hosts": short,
            }
        rejections: Dict[str, int] = {}
        for c in candidates:
            if c["verdict"] == "ok":
                continue
            cls = _rejection_class(str(c["verdict"]))
            rejections[cls] = rejections.get(cls, 0) + 1
        dominant = (
            max(rejections.items(), key=lambda kv: (kv[1], kv[0]))[0]
            if rejections else "tpu-ports"
        )
        return {
            "resource": dominant,
            "needed_hosts": demand["num_hosts"],
            "chips_per_host": demand["chips_per_host"],
            "fitting_hosts": fitting,
            "short_hosts": short,
            "rejections": rejections,
        }

    def _record_gate_hold(
        self, req, pending_demand, held: PendingEntry, quarantined,
        occupied, ctx=None, kind: str = ledger_mod.KIND_PLACE,
    ) -> None:
        if self.ledger is None:
            return
        if self.ledger.bump_if_recent(
            req.name, kind, ledger_mod.OUTCOME_HELD_BACK,
            resource="backfill-gate",
        ) is not None:
            return  # repeat gate hold within the rescan window
        self.ledger.record(DecisionRecord(
            request=req.name,
            kind=kind,
            outcome=ledger_mod.OUTCOME_HELD_BACK,
            decision_id=ctx.trace_id if ctx is not None else "",
            priority=req.spec.priority,
            demand={"num_hosts": pending_demand[0],
                    "chips_per_host": pending_demand[1]},
            inputs=self._inputs_digest(quarantined, occupied),
            binding={
                "resource": "backfill-gate",
                "protecting": held.name,
                "protected_priority": held.priority,
                "protected_demand": {
                    "num_hosts": held.num_hosts,
                    "chips_per_host": held.chips_per_host,
                },
            },
            summary=(
                f"held back by backfill gate: placing now would starve"
                f" pending request {held.name} (priority {held.priority} >"
                f" {req.spec.priority})"
            ),
        ))

    def _record_preempt(
        self, req, demand, victims: List[str], quarantined, occupied, used,
        ctx=None,
    ) -> None:
        if self.ledger is None:
            return
        search = dict(self.preemptor.last_search)
        mode = search.get("mode", "unknown")
        pool = search.get("candidates", "?")
        rationale = (
            f"minimal victim set by {mode} search over {pool} candidate(s)"
            " (cardinality, then total victim priority, then chips evicted)"
        )
        self.ledger.record(DecisionRecord(
            request=req.name,
            kind=ledger_mod.KIND_PLACE,
            outcome=ledger_mod.OUTCOME_PREEMPTING,
            decision_id=ctx.trace_id if ctx is not None else "",
            priority=req.spec.priority,
            demand=demand,
            inputs=self._inputs_digest(quarantined, occupied),
            candidates=self.engine.candidate_verdicts(
                req, demand["chips_per_host"], quarantined, used,
                cap=_CANDIDATE_CAP,
            ),
            victims=list(victims),
            victim_rationale=rationale,
            binding=search,
            summary=(
                f"preempting {', '.join(victims)}"
                f" ({len(victims)} victim(s); {rationale})"
            ),
        ))

    # ------------------------------------------------------------------
    def _gate(
        self,
        req: ComposabilityRequest,
        add,
        occupied,
        quarantined: Set[str],
    ) -> Optional[PendingEntry]:
        """Conservative backfill: block this placement only if it would
        turn a currently-placeable higher-priority pending request into an
        unplaceable one. Probes run against the FULL occupancy map plus
        the tentative placement. Returns the entry being protected, or
        None."""
        entries = self.queue.entries_above(req.spec.priority)
        if not entries:
            return None
        after = dict(occupied)
        for n, chips in add.items():
            after[n] = after.get(n, 0) + chips
        # One node snapshot for all probes (2 per entry) this gate runs.
        nodes = self.engine.schedulable_nodes(quarantined)
        for entry in entries:
            if entry.name == req.name:
                continue
            other = self.store.try_get(ComposabilityRequest, entry.name)
            if other is None or other.being_deleted:
                continue
            feasible_now = self.engine.demand_feasible(
                other, entry.num_hosts, entry.chips_per_host, quarantined,
                occupied, anchor=entry.anchor, nodes=nodes,
                exclude_nodes=entry.exclude_nodes,
            )
            if not feasible_now:
                # Unsatisfiable either way (e.g. its only hosts are
                # quarantined) — holding everyone behind it would be
                # priority inversion for nothing.
                continue
            if not self.engine.demand_feasible(
                other, entry.num_hosts, entry.chips_per_host, quarantined,
                after, anchor=entry.anchor, nodes=nodes,
                exclude_nodes=entry.exclude_nodes,
            ):
                return entry
        return None

    def _update_gauges(self, quarantined: Set[str], occupied) -> None:
        # The gauge must reflect the REAL cluster: `occupied` is the full
        # occupancy map from the pass's single store scan (the
        # request-excluded picking view would read a resizing request's
        # attached chips as free and make the score flap).
        scheduler_queue_depth.set(float(self.queue.depth()))
        scheduler_fragmentation_score.set(
            self.engine.fragmentation(quarantined, occupied)
        )
