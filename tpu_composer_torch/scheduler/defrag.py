"""Defragmentation planner — reassemble contiguous TPU capacity.
(Port of ``tpu_composer/scheduler/defrag.py``.)

Long-running fleets fragment: single-host slices land, die, and re-land
until every host holds a couple of chips and no 2-host gang can compose
even though the totals say it should. The planner proposes **worker
migrations** that vacate nearly-empty hosts by repacking their sub-host
chip groups onto already-fragmented peers — the same tightest-fit objective
the placement engine scores, run in reverse over live placements.

Safety properties:

- ``plan()`` is a pure dry run: it reads the store, simulates, and returns
  a :class:`DefragPlan`; nothing moves until ``execute()`` is called with
  that plan (and the operator can run plan-only forever via
  ``TPUC_DEFRAG_EXECUTE=0``).
- only members of **single-host**, **Running** slices whose owner allows
  disruption (``preemptionPolicy != Never``) migrate — moving one worker of
  a multi-host gang would invalidate its ICI topology mid-flight;
- execution has two modes. ``mode="migrate"`` (cmd/main's default with the
  live-migration verb enabled) never deletes anything: each verified
  migration is handed to the owner's migration driver as a durable
  evacuation mark (``tpu.composer.dev/evacuate=defrag`` plus the verified
  target as a hint), and the member moves make-before-break — defrag is
  safe to run with ``--defrag-execute`` against live workloads.
  ``mode="delete"`` is the legacy shape (and the TPUC_MIGRATE=0 escape
  hatch): the member's ComposableResource is deleted, its owner re-enters
  NodeAllocating, and the placement engine's tightest-fit scoring lands the
  re-solve on the packed target. Both modes re-verify the plan against
  fresh state before touching anything;
- planning is gated on MIGRATABILITY in migrate mode: a request whose
  ``repairPolicy`` is ``None`` has opted out of the replacement machinery
  migration rides on, so its members anchor their hosts; and an open
  repair/migration breaker skips the pass entirely (evacuating through a
  brownout is how outages amplify). Skip reasons are tallied into
  ``last_report`` and served by the manager's ``/debug/defrag`` endpoint;
- a plan is idempotent: once executed and settled, the next ``plan()``
  finds no migration that improves the fragmentation score and returns
  empty.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from tpu_composer_torch.agent.publisher import quarantined_nodes
from tpu_composer_torch.api.meta import now_iso
from tpu_composer_torch.api.types import (
    ANNOTATION_EVACUATE,
    ANNOTATION_EVACUATE_TARGET,
    ComposabilityRequest,
    ComposableResource,
    LABEL_MANAGED_BY,
    MIGRATE_TRIGGER_DEFRAG,
    Node,
    PREEMPT_NEVER,
    REPAIR_NONE,
    REQUEST_STATE_RUNNING,
    RESOURCE_STATE_ONLINE,
)
from tpu_composer_torch.runtime.events import EventRecorder
from tpu_composer_torch.runtime.metrics import (
    migration_breaker_open,
    repair_breaker_open,
    scheduler_defrag_migrations_total,
    scheduler_fragmentation_score,
)
from tpu_composer_torch.runtime.store import ConflictError, NotFoundError, StoreError
from tpu_composer_torch.topology.slices import is_chip_group


@dataclass(frozen=True)
class Migration:
    request: str
    resource: str
    from_node: str
    to_node: str
    chips: int


@dataclass
class DefragPlan:
    migrations: List[Migration] = field(default_factory=list)
    frag_before: float = 0.0
    frag_after: float = 0.0
    #: Why candidates were excluded from THIS plan, reason -> count —
    #: carried on the plan itself so a report pairs migrations and skips
    #: from the same pass (the shared last_skips is only the latest
    #: complete snapshot, which a concurrent pass may have replaced).
    skips: Dict[str, int] = field(default_factory=dict)

    @property
    def empty(self) -> bool:
        return not self.migrations


class DefragPlanner:
    def __init__(self, store, engine, queue=None, lock=None,
                 mode: str = "delete", decision_ledger=None) -> None:
        self.store = store
        self.engine = engine
        # The scheduler's DecisionLedger, when wired: planner skips and
        # executed migrations land in the owners' decision rings so
        # "why is defrag not consolidating my worker" / "why did my
        # worker move" answer themselves via /debug/scheduler/explain.
        # None (TPUC_DECISIONS=0, or direct construction) records nothing.
        self.decision_ledger = decision_ledger
        # The scheduler's pending queue, when wired (ClusterScheduler
        # does): execute() refuses migrations whose owner's re-placement
        # the backfill gate would hold back — without this, a "capacity
        # shuffle" can silently turn into an unaccounted preemption.
        self.queue = queue
        # The scheduler's allocation lock, when wired: each migration's
        # verify+delete runs under it so a concurrent placement can't
        # fill the verified target between the check and the delete.
        self.lock = lock
        # Execution mode: "migrate" hands each verified migration to the
        # owner's live-migration driver (durable evacuation mark + target
        # hint — make-before-break, safe against live jobs); "delete" is
        # the legacy delete/re-solve shape kept for the TPUC_MIGRATE=0
        # escape hatch and direct-construction tests.
        self.mode = mode
        # Why candidates were excluded from the last plan(), reason ->
        # count — the /debug/defrag dry-run report's substance (a planner
        # that silently plans nothing is indistinguishable from a healthy
        # defragmented fleet without this). Each plan() tallies into a
        # LOCAL dict and publishes it whole at the end, so a /debug/defrag
        # dry-run racing the periodic loop's pass can never blend the two
        # passes' counts (last complete snapshot wins).
        self.last_skips: Dict[str, int] = {}
        self.log = logging.getLogger("DefragPlanner")

    # ------------------------------------------------------------------
    def plan(self, quarantined: Optional[Set[str]] = None) -> DefragPlan:
        """Dry-run: the migrations that would vacate hosts and lower the
        fragmentation score, or an empty plan when none would."""
        if quarantined is None:
            quarantined = quarantined_nodes(self.store)
        used = self.engine.used_slots_map()
        frag_before = self.engine.fragmentation(quarantined, used)

        nodes: Dict[str, Node] = {
            n.metadata.name: n
            for n in self.store.list(Node)
            if n.status.ready
            and not n.spec.unschedulable
            and n.metadata.name not in quarantined
        }
        skips: Dict[str, int] = {}
        skip_owners: Dict[str, Dict[str, str]] = {}
        movable, anchored = self._occupants(nodes, skips, skip_owners)

        # Vacate candidates: hosts with movable occupants and nothing
        # anchoring them, emptiest first (fewest chips to relocate per
        # host freed). Whether a host's entire occupancy is still movable
        # is re-checked against sim_used inside the loop: an earlier
        # migration may have packed chips ONTO a later candidate, and
        # "vacating" only its original occupants would be pure churn.
        sources = sorted(
            (
                name
                for name, node in nodes.items()
                if movable.get(name) and name not in anchored
            ),
            key=lambda name: (used.get(name, 0), name),
        )

        sim_used = dict(used)
        migrations: List[Migration] = []
        vacated: Set[str] = set()
        for src in sources:
            if sim_used.get(src, 0) != sum(
                m.chips for m in movable.get(src, [])
            ):
                continue  # received migrated chips (or was empty) — skip
            trial: List[Migration] = []
            trial_used = dict(sim_used)
            ok = True
            # Largest groups first: best-fit-decreasing packs tighter.
            for mig in sorted(
                movable.get(src, []), key=lambda m: (-m.chips, m.resource)
            ):
                target = self._best_target(
                    mig.chips, src, nodes, trial_used, vacated
                )
                if target is None:
                    ok = False
                    break
                trial.append(
                    Migration(
                        request=mig.request,
                        resource=mig.resource,
                        from_node=src,
                        to_node=target,
                        chips=mig.chips,
                    )
                )
                trial_used[target] = trial_used.get(target, 0) + mig.chips
                trial_used[src] = trial_used.get(src, 0) - mig.chips
            if ok and trial:
                migrations.extend(trial)
                sim_used = trial_used
                vacated.add(src)

        frag_after = self.engine.fragmentation(quarantined, sim_used)
        self.last_skips = skips  # one atomic publish per completed plan
        self._record_skips(skip_owners)
        if frag_after >= frag_before:
            return DefragPlan([], frag_before, frag_before, skips=skips)
        return DefragPlan(migrations, frag_before, frag_after, skips=skips)

    def _record_skips(
        self, skip_owners: Dict[str, Dict[str, str]]
    ) -> None:
        """One defrag-skip decision per excluded OWNER per pass — the
        ledger collapses identical repeats across periodic passes, so a
        steady-state skip costs one record with a repeats counter."""
        if self.decision_ledger is None:
            return
        from tpu_composer_torch.scheduler import ledger as ledger_mod

        for owner, members in sorted(skip_owners.items()):
            reasons = sorted(set(members.values()))
            self.decision_ledger.record(ledger_mod.DecisionRecord(
                request=owner,
                kind=ledger_mod.KIND_DEFRAG_SKIP,
                outcome=ledger_mod.OUTCOME_SKIPPED,
                binding={"resource": "defrag-migratability",
                         "members": members},
                summary=(
                    "defrag left member(s) in place:"
                    f" {', '.join(reasons)}"
                ),
            ))

    def _best_target(
        self,
        chips: int,
        src: str,
        nodes: Dict[str, Node],
        sim_used: Dict[str, int],
        vacated: Set[str],
    ) -> Optional[str]:
        """Tightest-fit target that is already partially used — migrating
        onto an empty host would only move the fragmentation around."""
        best = None
        for name, node in nodes.items():
            if name == src or name in vacated:
                continue
            u = sim_used.get(name, 0)
            free = node.status.tpu_slots - u
            if u <= 0 or free < chips:
                continue
            key = (free - chips, name)
            if best is None or key < best[0]:
                best = (key, name)
        return best[1] if best else None

    def _occupants(
        self,
        nodes: Dict[str, Node],
        skips: Dict[str, int],
        skip_owners: Optional[Dict[str, Dict[str, str]]] = None,
    ):
        """Split live TPU chip groups into movable (single-host Running
        slice, disruption allowed — and in migrate mode MIGRATABLE:
        ``repairPolicy != None``, since live migration rides the
        replacement machinery that policy opts out of — sub-host group) vs
        anchoring (everything else pins its host in place). Every
        exclusion tallies a reason into ``skips``."""
        requests = {r.name: r for r in self.store.list(ComposabilityRequest)}
        movable: Dict[str, List[Migration]] = {}
        anchored: Set[str] = set()
        for c in self.store.list(ComposableResource):
            if c.being_deleted:
                continue
            node = c.spec.target_node
            if node not in nodes:
                continue
            owner = requests.get(c.metadata.labels.get(LABEL_MANAGED_BY, ""))
            reason = self._immovable_reason(c, owner, nodes[node])
            if reason is None:
                movable.setdefault(node, []).append(
                    Migration(
                        request=owner.name,
                        resource=c.name,
                        from_node=node,
                        to_node="",
                        chips=c.spec.chip_count,
                    )
                )
            else:
                skips[reason] = skips.get(reason, 0) + 1
                anchored.add(node)
                if skip_owners is not None and owner is not None:
                    skip_owners.setdefault(owner.name, {})[c.name] = reason
        return movable, anchored

    def _immovable_reason(self, c, owner, node: Node) -> Optional[str]:
        """Why this chip group anchors its host (None = movable)."""
        if not is_chip_group(c.spec.type, c.spec.model):
            return "non-tpu"
        if owner is None or owner.being_deleted:
            return "no-live-owner"
        if owner.spec.preemption_policy == PREEMPT_NEVER:
            return "preemptionPolicy=Never"
        if owner.spec.resource.target_node:
            return "pinned-target-node"
        if owner.status.state != REQUEST_STATE_RUNNING:
            return "owner-not-running"
        if owner.status.slice.num_hosts != 1:
            return "multi-host-slice"
        if c.spec.chip_count >= node.status.tpu_slots:
            return "whole-host-group"
        if self.mode == "migrate":
            if owner.spec.repair_policy == REPAIR_NONE:
                # Live migration rides the replacement machinery;
                # repairPolicy=None opted this request out of it — the
                # planner must not propose moves nobody will execute.
                return "repairPolicy=None"
            if c.status.state not in (RESOURCE_STATE_ONLINE,):
                # Degraded/Repairing/Migrating members belong to the
                # repair or migration driver already in flight.
                return f"member-{c.status.state or 'pending'}"
            if c.metadata.annotations.get(ANNOTATION_EVACUATE):
                return "already-evacuating"
        return None

    # ------------------------------------------------------------------
    def execute(
        self, plan: DefragPlan, recorder: Optional[EventRecorder] = None
    ) -> int:
        """Start a dry-run plan's migrations. In ``migrate`` mode each
        verified entry becomes a durable evacuation mark (+ target hint)
        on the member — the owner's live-migration driver moves it
        make-before-break, so a Running workload never loses the member
        before its replacement is Online. In ``delete`` mode (legacy /
        escape hatch) the member is deleted and its owner re-solves onto
        the packed target. Either way every entry is re-verified against
        fresh state — a stale one (child gone, target filled up meanwhile)
        is skipped, not forced — under the scheduler's allocation lock
        (when wired) so a concurrent placement cannot fill the verified
        target between the check and the act. Returns the number of
        migrations actually started."""
        started = 0
        quarantined = quarantined_nodes(self.store)
        for m in plan.migrations:
            with self.lock if self.lock is not None else contextlib.nullcontext():
                if self._execute_one(m, quarantined, recorder):
                    started += 1
        return started

    def _execute_one(
        self,
        m: Migration,
        quarantined,
        recorder: Optional[EventRecorder],
    ) -> bool:
        """One migration's verify+delete (caller holds the allocation
        lock when one is wired). False = skipped or failed."""
        child = self.store.try_get(ComposableResource, m.resource)
        if (
            child is None
            or child.being_deleted
            or child.spec.target_node != m.from_node
            or child.metadata.labels.get(LABEL_MANAGED_BY) != m.request
        ):
            return False  # world moved on since the plan was cut
        target = self.store.try_get(Node, m.to_node)
        used = self.engine.used_slots_map()
        if (
            target is None
            or not target.status.ready
            or target.spec.unschedulable
            or m.to_node in quarantined
            or target.status.tpu_slots - used.get(m.to_node, 0) < m.chips
        ):
            # Includes a target quarantined since the plan was cut: the
            # owner's re-solve would exclude it, so deleting the worker
            # could strand a Running slice with nowhere to re-land.
            return False
        if self._owner_would_be_held_back(m, used, quarantined):
            self.log.info(
                "defrag skip %s (%s -> %s): owner %s would be gate-"
                "blocked from re-placing behind a pending higher-"
                "priority demand", m.resource, m.from_node, m.to_node,
                m.request,
            )
            return False
        if self.mode == "migrate":
            if (
                child.metadata.annotations.get(ANNOTATION_EVACUATE)
                or child.status.state != RESOURCE_STATE_ONLINE
            ):
                return False  # already moving (or not movable right now)
            child.metadata.annotations[ANNOTATION_EVACUATE] = (
                MIGRATE_TRIGGER_DEFRAG
            )
            child.metadata.annotations[ANNOTATION_EVACUATE_TARGET] = m.to_node
            try:
                self.store.update(child)
            except (ConflictError, NotFoundError):
                return False  # world moved on — re-planned next pass
            except StoreError as e:
                self.log.warning(
                    "defrag evacuation mark on %s (%s -> %s) failed: %s",
                    m.resource, m.from_node, m.to_node, e,
                )
                return False
        else:
            try:
                self.store.delete(ComposableResource, m.resource)
            except NotFoundError:
                return False
            except StoreError as e:
                self.log.warning(
                    "defrag migration of %s (%s -> %s) failed: %s",
                    m.resource, m.from_node, m.to_node, e,
                )
                return False
        scheduler_defrag_migrations_total.inc()
        if self.decision_ledger is not None:
            from tpu_composer_torch.scheduler import ledger as ledger_mod

            self.decision_ledger.record(ledger_mod.DecisionRecord(
                request=m.request,
                kind=ledger_mod.KIND_DEFRAG_MIGRATE,
                outcome=ledger_mod.OUTCOME_EVACUATING,
                chosen=[m.to_node],
                tiebreak="tightest-fit consolidation target",
                summary=(
                    f"defrag {'evacuating' if self.mode == 'migrate' else 'migrating'}"
                    f" worker {m.resource}: {m.from_node} -> {m.to_node}"
                    f" ({m.chips} chips) to reassemble contiguous capacity"
                ),
            ))
        if recorder is not None:
            req = self.store.try_get(ComposabilityRequest, m.request)
            if req is not None:
                recorder.event(
                    req, "Normal", "DefragMigration",
                    f"migrating worker {m.resource} "
                    f"{m.from_node} -> {m.to_node} to defragment capacity"
                    + (" (live, make-before-break)"
                       if self.mode == "migrate" else ""),
                )
        return True

    def _owner_would_be_held_back(
        self, m: Migration, used, quarantined
    ) -> bool:
        """Simulate the migration landing (from -= chips, to += chips) and
        run the same conservative-backfill probes the owner's re-solve
        will face: if a currently-feasible higher-priority pending demand
        becomes infeasible, the owner would be held back — the migration
        would evict a Running worker with nowhere to go."""
        if self.queue is None:
            return False
        owner = self.store.try_get(ComposabilityRequest, m.request)
        if owner is None or owner.being_deleted:
            return True  # nothing to re-place; skip the no-op delete
        entries = self.queue.entries_above(owner.spec.priority)
        if not entries:
            return False
        after = dict(used)
        after[m.from_node] = after.get(m.from_node, 0) - m.chips
        after[m.to_node] = after.get(m.to_node, 0) + m.chips
        nodes = self.engine.schedulable_nodes(quarantined)
        for entry in entries:
            other = self.store.try_get(ComposabilityRequest, entry.name)
            if other is None or other.being_deleted:
                continue
            if self.engine.demand_feasible(
                other, entry.num_hosts, entry.chips_per_host, quarantined,
                used, anchor=entry.anchor, nodes=nodes,
                exclude_nodes=entry.exclude_nodes,
            ) and not self.engine.demand_feasible(
                other, entry.num_hosts, entry.chips_per_host, quarantined,
                after, anchor=entry.anchor, nodes=nodes,
                exclude_nodes=entry.exclude_nodes,
            ):
                return True
        return False


class DefragLoop:
    """Manager runnable: periodically plan (always) and execute (opt-in).

    Plan-only mode still updates the fragmentation gauge and logs the
    migrations it *would* run — the operator's preview."""

    def __init__(
        self,
        store,
        planner: DefragPlanner,
        period: float = 300.0,
        execute: bool = False,
        recorder: Optional[EventRecorder] = None,
        gate: Optional[Callable[[], bool]] = None,
    ) -> None:
        self.store = store
        self.planner = planner
        self.period = period
        self.execute = execute
        self.recorder = recorder
        # Singleton gate for sharded deployments: defrag plans over the
        # WHOLE cluster, so N replicas running it concurrently would
        # compute mutually unaware, conflicting migration sets. cmd/main
        # gates the pass on owning shard 0 — exactly one replica defrags
        # at a time, and the duty fails over with the shard lease. None
        # (unsharded) runs every tick, today's behavior.
        self.gate = gate
        # Last pass's report for /debug/defrag: what was planned, what was
        # skipped and why, whether a breaker froze the pass.
        self.last_report: Dict[str, object] = {}
        self.log = logging.getLogger("DefragLoop")

    def __call__(self, stop_event: threading.Event) -> None:
        while not stop_event.wait(self.period):
            if self.gate is not None and not self.gate():
                continue  # another replica holds the defrag duty
            try:
                self.run_once()
            except StoreError as e:  # pragma: no cover - wire-store only
                self.log.warning("defrag pass failed: %s", e)

    def _frozen(self) -> bool:
        """Migrate-mode planning is pointless (and planning THROUGH a
        brownout would be worse than pointless) while the repair or
        migration breaker is open — the migration driver would freeze
        every move anyway. Delete mode predates the breakers and keeps
        its legacy behavior."""
        if self.planner.mode != "migrate":
            return False
        return (
            repair_breaker_open.value() > 0
            or migration_breaker_open.value() > 0
        )

    def run_once(self) -> DefragPlan:
        if self._frozen():
            self.last_report = {
                "at": now_iso(),
                "mode": self.planner.mode,
                "execute": self.execute,
                "frozen": True,
                "skips": {"breaker-open": 1},
                "migrations": [],
            }
            self.log.info(
                "defrag pass skipped: repair/migration breaker open"
                " (brownout — no planning, no evacuation)"
            )
            return DefragPlan()
        plan = self.planner.plan()
        # Gauge reflects the CURRENT cluster, not the plan's prediction —
        # execution is asynchronous (owners re-solve on their own clock).
        scheduler_fragmentation_score.set(plan.frag_before)
        report: Dict[str, object] = {
            "at": now_iso(),
            "mode": self.planner.mode,
            # Which capacity accounting the plan read ("native"/"python" =
            # the watch-maintained snapshot, "legacy" = store walks) — a
            # stale-snapshot suspicion starts by checking this.
            "engine": getattr(
                self.planner.engine, "kernel_kind", "legacy"
            ),
            "execute": self.execute,
            "frozen": False,
            "frag_before": plan.frag_before,
            "frag_after": plan.frag_after,
            "skips": dict(plan.skips),
            "migrations": [
                {"request": m.request, "resource": m.resource,
                 "from": m.from_node, "to": m.to_node, "chips": m.chips}
                for m in plan.migrations
            ],
        }
        if plan.empty:
            self.last_report = report
            return plan
        summary = ", ".join(
            f"{m.resource}:{m.from_node}->{m.to_node}" for m in plan.migrations
        )
        if self.execute:
            n = self.planner.execute(plan, recorder=self.recorder)
            report["started"] = n
            self.log.info(
                "defrag executed %d/%d migration(s) via %s (frag %.3f ->"
                " %.3f): %s",
                n, len(plan.migrations), self.planner.mode,
                plan.frag_before, plan.frag_after, summary,
            )
        else:
            self.log.info(
                "defrag dry-run: %d migration(s) would cut fragmentation"
                " %.3f -> %.3f: %s",
                len(plan.migrations), plan.frag_before, plan.frag_after,
                summary,
            )
        self.last_report = report
        return plan

    def report(self) -> Dict[str, object]:
        """The /debug/defrag payload: a FRESH dry-run plan (never
        executed, whatever --defrag-execute says) alongside the last
        periodic pass's record."""
        if self._frozen():
            return {
                "mode": self.planner.mode,
                "execute": self.execute,
                "frozen": True,
                "dry_run": {"migrations": [], "skips": {"breaker-open": 1}},
                "last_pass": self.last_report,
            }
        plan = self.planner.plan()
        return {
            "mode": self.planner.mode,
            "engine": getattr(
                self.planner.engine, "kernel_kind", "legacy"
            ),
            "execute": self.execute,
            "frozen": False,
            "dry_run": {
                "frag_before": plan.frag_before,
                "frag_after": plan.frag_after,
                "migrations": [
                    {"request": m.request, "resource": m.resource,
                     "from": m.from_node, "to": m.to_node, "chips": m.chips}
                    for m in plan.migrations
                ],
                "skips": dict(plan.skips),
            },
            "last_pass": self.last_report,
        }
