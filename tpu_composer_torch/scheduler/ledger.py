"""Decision ledger — every scheduler decision explains itself.
(Port of ``tpu_composer/scheduler/ledger.py``.)

Three observability layers made the control plane's *mechanics* legible —
traces say where the time went, profiles say where the CPU went, SLO burn
says whether the promise holds — but the scheduler's *decisions* stayed
opaque: "where did my slice land", "why is it still queued", "why was that
victim preempted" had no answer beyond unlabeled aggregate counters. The
32-GPU composable-system study (arXiv:2404.06467) evaluates exactly these
quantities as curves, and per-tenant accounting (Funky, arXiv:2510.15755)
presumes a substrate that can attribute every placement — this module is
that substrate.

Every admit / place / hold-back / preempt / defrag decision the
:class:`~tpu_composer_torch.scheduler.core.ClusterScheduler` (and the
DefragPlanner) makes emits a structured :class:`DecisionRecord`:

- an **inputs digest**: free chips per node, fragmentation score, the
  quarantine set and pending-queue depth the decision saw;
- the **candidates considered**, each with a per-node verdict ("ok",
  "quarantined", "no-tpu-ports free=1 need=4", ...);
- the **chosen hosts** with the tiebreak rationale (tightest-fit leftover
  sum, ICI contiguity window span);
- the **victims** with the minimality rationale (exhaustive vs
  greedy+prune search, candidate pool size);
- for hold-backs, the **binding constraint**: which resource is short and
  by how much (tpu-ports 3 hosts short; backfill-gate protecting X).

Records live in a bounded per-CR ring (LRU-capped object map — a churning
fleet cannot grow the heap), the latest record's one-line summary surfaces
as a Queued / Placed / Preempting controller Event (deduped: a reconcile
retry that reaches the identical decision bumps a ``repeats`` counter
instead of appending), ``/debug/scheduler/explain/<name>`` serves the ring
as JSON, and ``python -m tpu_composer explain <cr>`` prints it from a
terminal. Decision ids double as trace ids: the decision span hands one
flow per planned worker to the resource controller's intent mint
(:meth:`DecisionLedger.link_decision`, via the controller's explicit
ledger handle), so one Perfetto flow runs decision → attach → Ready on
the intent-nonce trace machinery.

``TPUC_DECISIONS=0`` (cmd/main ``--no-decisions``) constructs none of
this: the scheduler's ledger handle is None and no record, verdict scan or
event is ever built — the perf-smoke gate holds the enabled path within 5%
of that on the 32-chip wave.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from tpu_composer_torch.api.meta import now_iso
from tpu_composer_torch.runtime import tracing
from tpu_composer_torch.runtime.metrics import scheduler_decisions_total

log = logging.getLogger("decisions")

#: The most recently constructed ledger (crash-hook dump target +
#: the resource controller's decision→attach join point), like the
#: profiler / SLO engine / fleet plane actives.
_active: Optional["DecisionLedger"] = None

#: Decision kinds (the ledger's vocabulary; OPERATIONS.md documents it).
KIND_PLACE = "place"
KIND_PLACE_SCALAR = "place-scalar"
KIND_PLACE_EXTRA = "place-extra"
KIND_DEFRAG_SKIP = "defrag-skip"
KIND_DEFRAG_MIGRATE = "defrag-migrate"

OUTCOME_PLACED = "placed"
OUTCOME_HELD_BACK = "held-back"
OUTCOME_PREEMPTING = "preempting"
OUTCOME_SKIPPED = "skipped"
OUTCOME_EVACUATING = "evacuating"

#: How many candidate verdicts a record keeps. The ledger owns this
#: truncation policy, and the scheduler passes it DOWN into the engine's
#: verdict scan (``candidate_verdicts(..., cap=CANDIDATE_CAP)``) so only
#: this many per-node dicts are ever materialized — truncating after a
#: full O(nodes) materialization was half the decision plane's
#: overhead on a large index.
CANDIDATE_CAP = 64


@dataclass
class DecisionRecord:
    """One scheduler decision, self-describing."""

    request: str
    kind: str
    outcome: str
    #: one-line human summary — what the Event carries and the triage
    #: runbook greps for.
    summary: str
    decision_id: str = ""
    seq: int = 0
    at: str = ""
    priority: int = 0
    #: the demand being decided: {"num_hosts": N, "chips_per_host": C}
    demand: Dict[str, int] = field(default_factory=dict)
    #: inputs digest: what the decision saw (free chips per node,
    #: fragmentation, quarantine set, pending-queue depth).
    inputs: Dict[str, Any] = field(default_factory=dict)
    #: candidates considered: [{"node", "free", "verdict"}, ...]
    candidates: List[Dict[str, Any]] = field(default_factory=list)
    chosen: List[str] = field(default_factory=list)
    #: why THESE hosts among the candidates (tightest-fit sum, ICI span).
    tiebreak: str = ""
    victims: List[str] = field(default_factory=list)
    #: why THIS victim set is minimal (search mode, pool size).
    victim_rationale: str = ""
    #: hold-backs only: the binding constraint — which resource, how short.
    binding: Dict[str, Any] = field(default_factory=dict)
    #: identical consecutive decisions collapse into one record (reconcile
    #: retries reach the same verdict every few seconds while queued).
    repeats: int = 1
    #: monotonic instant of the last FULL record()/collapse (bumps do not
    #: advance it) — the rescan rate-limit's anchor, so repeat hold-backs
    #: re-derive their binding shortfall at most once per window instead
    #: of sliding the window forever on stale data. Never serialized.
    mono: float = field(default=0.0, repr=False)
    #: attach intents that executed this decision (filled by
    #: :func:`link_decision` as the resource controller mints them).
    nonces: List[str] = field(default_factory=list)
    #: pending Perfetto flow handles for the decision → attach arrows
    #: (one per planned worker); consumed by link_decision, never
    #: serialized.
    flows: List[tracing.TraceContext] = field(default_factory=list, repr=False)

    def to_doc(self) -> Dict[str, Any]:
        doc: Dict[str, Any] = {
            "decision_id": self.decision_id,
            "seq": self.seq,
            "at": self.at,
            "request": self.request,
            "kind": self.kind,
            "outcome": self.outcome,
            "priority": self.priority,
            "summary": self.summary,
            "repeats": self.repeats,
        }
        if self.demand:
            doc["demand"] = dict(self.demand)
        if self.inputs:
            doc["inputs"] = dict(self.inputs)
        if self.candidates:
            doc["candidates"] = list(self.candidates)
        if self.chosen:
            doc["chosen"] = list(self.chosen)
        if self.tiebreak:
            doc["tiebreak"] = self.tiebreak
        if self.victims:
            doc["victims"] = list(self.victims)
        if self.victim_rationale:
            doc["victim_rationale"] = self.victim_rationale
        if self.binding:
            doc["binding"] = dict(self.binding)
        if self.nonces:
            doc["nonces"] = list(self.nonces)
        return doc


class _EventRef:
    """Recorder shim so the ledger can event against a CR by name without
    holding the (possibly re-read) object."""

    KIND = "ComposabilityRequest"

    def __init__(self, name: str) -> None:
        from types import SimpleNamespace

        self.metadata = SimpleNamespace(name=name)


class DecisionLedger:
    """Bounded per-CR decision rings + the hold-back reason tally.

    Thread-safety: record() is called under the scheduler's allocation
    lock for placement decisions and from the defrag loop for defrag ones;
    the internal lock makes the ledger safe either way (the explain
    endpoint reads from the health-server thread)."""

    #: Event reasons by outcome — the "latest record surfaces as an Event"
    #: contract. Preempting rides the controller's own per-victim events;
    #: the ledger's copy carries the WHY (candidates, minimality).
    _EVENT_REASONS = {
        OUTCOME_PLACED: ("Normal", "Placed"),
        OUTCOME_HELD_BACK: ("Warning", "Queued"),
        OUTCOME_PREEMPTING: ("Normal", "Preempting"),
    }

    #: A repeat hold-back within this many seconds of the latest matching
    #: record skips the full candidate/inputs rescan (bump_if_recent):
    #: a queued request's backoff retries must not pay O(nodes) scans
    #: under the allocation lock per tick just to collapse into a counter.
    hold_rescan_s = 2.0

    def __init__(
        self,
        per_object: int = 32,
        max_objects: int = 2048,
        recorder=None,  # duck-typed EventRecorder (.event); None = no events
        recent_holds: int = 256,
    ) -> None:
        global _active
        self._lock = threading.Lock()
        self._per_object = per_object
        self._max_objects = max_objects
        self.recorder = recorder
        self._seq = 0
        # name -> deque[DecisionRecord], LRU-ordered like the flight
        # recorder's object map.
        self._objects: "collections.OrderedDict[str, collections.deque]" = (
            collections.OrderedDict()
        )
        # Rolling window of hold-back binding resources — what "dominant
        # hold-back reason" means for the queue-wait SLO breach Event.
        self._recent_holds: collections.deque = collections.deque(
            maxlen=recent_holds
        )
        _active = self

    # ------------------------------------------------------------------
    def record(self, rec: DecisionRecord) -> DecisionRecord:
        """Append (or collapse into) the request's ring; returns the
        stored record. Emits the Queued/Placed/Preempting Event only on a
        FRESH decision — a reconcile retry reaching the identical verdict
        bumps ``repeats`` silently, so a queued request cannot spam an
        event per backoff tick."""
        emit = False
        with self._lock:
            ring = self._objects.get(rec.request)
            if ring is None:
                ring = collections.deque(maxlen=self._per_object)
                self._objects[rec.request] = ring
                while len(self._objects) > self._max_objects:
                    self._objects.popitem(last=False)
            else:
                self._objects.move_to_end(rec.request)
            last = ring[-1] if ring else None
            if (
                last is not None
                and last.kind == rec.kind
                and last.outcome == rec.outcome
                and last.summary == rec.summary
            ):
                last.repeats += 1
                last.at = now_iso()
                # Refresh the binding/inputs digest: the shortfall the
                # operator reads should be the LATEST one observed.
                if rec.binding:
                    last.binding = rec.binding
                if rec.inputs:
                    last.inputs = rec.inputs
                if rec.flows:
                    # A re-solve reaching the identical placement mints
                    # fresh intents — keep their flow handles consumable.
                    last.flows = (last.flows + rec.flows)[-16:]
                stored = last
            else:
                self._seq += 1
                rec.seq = self._seq
                rec.decision_id = rec.decision_id or (
                    f"d-{uuid.uuid4().hex[:10]}"
                )
                rec.at = rec.at or now_iso()
                ring.append(rec)
                stored = rec
                emit = True
            stored.mono = time.monotonic()
            if rec.outcome == OUTCOME_HELD_BACK:
                self._recent_holds.append(
                    (rec.binding or {}).get("resource", "unknown")
                )
        scheduler_decisions_total.inc(kind=rec.kind, outcome=rec.outcome)
        if emit and self.recorder is not None:
            ev = self._EVENT_REASONS.get(rec.outcome)
            if ev is not None:
                try:
                    self.recorder.event(
                        _EventRef(rec.request), ev[0], ev[1], rec.summary
                    )
                except Exception:  # pragma: no cover - defensive
                    log.exception("decision event emission failed")
        return stored

    def bump_if_recent(
        self, request: str, kind: str, outcome: str,
        within_s: Optional[float] = None,
        resource: Optional[str] = None,
        exclude_resources: tuple = (),
    ) -> Optional[DecisionRecord]:
        """Collapse a repeat decision into the latest matching record
        WITHOUT the caller rebuilding its candidates/inputs: if the
        request's newest record matches (kind, outcome — and the binding
        ``resource`` when given, or anything NOT in ``exclude_resources``,
        so a capacity hold never collapses into a gate or fabric-
        reservation record and vice versa) and was recorded within
        ``within_s`` (default :attr:`hold_rescan_s`) on the monotonic
        clock, bump its repeats (feeding the hold-reason tally) and
        return it; None means the caller should build a full record (the
        binding shortfall then refreshes on record()'s own dedup)."""
        within_s = self.hold_rescan_s if within_s is None else within_s
        now = time.monotonic()
        with self._lock:
            ring = self._objects.get(request)
            last = ring[-1] if ring else None
            if (
                last is None
                or last.kind != kind
                or last.outcome != outcome
                or now - last.mono > within_s
            ):
                return None
            last_resource = (last.binding or {}).get("resource", "")
            if resource is not None and last_resource != resource:
                return None
            if last_resource in exclude_resources:
                return None
            last.repeats += 1
            last.at = now_iso()
            # Deliberately NOT advancing last.mono: the next retry past
            # the window pays one full rescan, refreshing the shortfall.
            if outcome == OUTCOME_HELD_BACK:
                self._recent_holds.append(
                    (last.binding or {}).get("resource", "unknown")
                )
        scheduler_decisions_total.inc(kind=kind, outcome=outcome)
        return last

    # ------------------------------------------------------------------
    def names(self) -> List[str]:
        with self._lock:
            return list(self._objects)

    def latest(self, name: str) -> Optional[DecisionRecord]:
        with self._lock:
            ring = self._objects.get(name)
            return ring[-1] if ring else None

    def latest_placed(self, name: str) -> Optional[DecisionRecord]:
        """Most recent successful placement decision for ``name`` (any
        placement kind) — the record an executing attach joins."""
        with self._lock:
            ring = self._objects.get(name)
            if not ring:
                return None
            for rec in reversed(ring):
                if rec.outcome == OUTCOME_PLACED:
                    return rec
        return None

    def explain(self, name: str) -> Optional[Dict[str, Any]]:
        """The /debug/scheduler/explain/<name> payload: the full ring
        oldest-first plus the latest record's summary up front."""
        with self._lock:
            ring = self._objects.get(name)
            if not ring:
                return None
            records = [r.to_doc() for r in ring]
        return {
            "request": name,
            # Which kernel produced the latest decision ("native" /
            # "python" / "legacy") — surfaced at the top so a triage of a
            # surprising placement starts from which engine layer ran it.
            "engine": records[-1].get("inputs", {}).get("engine", ""),
            "latest": records[-1],
            "decisions": records,
        }

    def link_decision(self, owner: str, nonce: str) -> str:
        """Join an attach intent to the placement decision that planned
        it: consumes one of the decision's pending Perfetto flow handles
        (drawing the decision-span → attach-span arrow) and records the
        nonce on the decision record so ``explain`` shows which intents
        executed it. Called by the resource controller at intent mint —
        through its EXPLICIT ledger handle (cmd/main wires the scheduler's
        ledger in), never the process-global: in-proc multi-replica
        harnesses construct one ledger per replica and a global would
        join intents onto whichever replica constructed last. Returns the
        decision id ("" when no placed decision for ``owner``)."""
        if not owner:
            return ""
        rec = self.latest_placed(owner)
        if rec is None:
            return ""
        with self._lock:
            if nonce and nonce not in rec.nonces:
                rec.nonces.append(nonce)
                if len(rec.nonces) > 64:  # defensive bound
                    del rec.nonces[:-64]
            flow = rec.flows.pop(0) if rec.flows else None
        if flow is not None:
            tracing.link(flow)
        return rec.decision_id

    def dominant_hold_back_reason(self) -> str:
        """Most common binding resource among recent hold-backs — what the
        queue-wait SLO breach Event names as its probable cause. Empty
        when nothing held back recently."""
        with self._lock:
            if not self._recent_holds:
                return ""
            counts = collections.Counter(self._recent_holds)
        reason, n = counts.most_common(1)[0]
        return f"{reason} ({n}/{sum(counts.values())} recent hold-backs)"

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Whole-ledger view (the crash dump / debug index payload)."""
        with self._lock:
            objects = {
                name: [r.to_doc() for r in ring]
                for name, ring in self._objects.items()
            }
            holds = list(self._recent_holds)
        return {
            "requests": objects,
            "recent_hold_back_reasons": holds,
            "dominant_hold_back": self.dominant_hold_back_reason(),
        }

    def dump(self, path: str) -> Optional[str]:
        """Write the ledger to ``path``. Never raises — runs on crash
        paths beside the flight/profile/SLO black boxes."""
        try:
            doc = {"written_at": now_iso(), "pid": os.getpid()}
            doc.update(self.snapshot())
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
        except (OSError, ValueError, TypeError):
            log.warning("decision ledger dump to %s failed", path)
            return None
        return path

    def reset(self) -> None:
        with self._lock:
            self._objects.clear()
            self._recent_holds.clear()


# ----------------------------------------------------------------------
def active() -> Optional[DecisionLedger]:
    return _active


def deactivate(ledger: Optional[DecisionLedger] = None) -> None:
    """Drop the module-global active ledger (test isolation; a specific
    ``ledger`` only deactivates if it is still the active one)."""
    global _active
    if ledger is None or _active is ledger:
        _active = None


def dump_file(path: Optional[str] = None) -> Optional[str]:
    """Write the active ledger to ``path`` (default $TPUC_DECISIONS_FILE)
    — the crash/soak failure artifact beside the flight, profile, SLO and
    fleet black boxes. Never raises."""
    path = path or os.environ.get("TPUC_DECISIONS_FILE")
    led = _active
    if not path or led is None:
        return None
    return led.dump(path)
