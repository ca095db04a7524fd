"""Victim-set computation: who must go so a higher-priority slice can fit.
(Port of ``tpu_composer/scheduler/preemption.py``.)

When the placement engine reports no valid host set for a request, the
preemptor searches for a **minimal** set of strictly-lower-priority
requests whose eviction would make the placement feasible. Minimality is
cardinality-first (fewest workloads disturbed), then least total victim
priority, then least capacity evicted — so a single 4-chip victim beats two
2-chip ones, and among equals the cheaper/younger victims go first.

Respected constraints:

- only strictly-lower-priority requests are candidates, and only when the
  preemptor's own ``preemptionPolicy`` is ``PreemptLowerPriority``;
- a victim with ``preemptionPolicy: Never`` is untouchable;
- capacity freed on quarantined / cordoned / gone nodes counts for nothing
  (the placement engine will not use it), so requests living there are
  never chosen — evicting them would disturb a workload without helping
  the preemptor (the quarantine-aware half of the priority-inversion
  guard).

The preemptor only *computes* the set. Execution — deleting the victims'
children so their own state machines re-queue them — stays in the request
controller, through the same delete/re-solve paths every other disruption
uses.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from tpu_composer_torch.api.types import (
    ComposabilityRequest,
    ComposableResource,
    LABEL_MANAGED_BY,
    Node,
    PREEMPT_LOWER_PRIORITY,
    PREEMPT_NEVER,
)
from tpu_composer_torch.topology.slices import SliceShape, is_chip_group

#: Exhaustive minimal-set search bound: above this many candidate victims
#: (or when no set ≤ _EXHAUSTIVE_MAX_SIZE works) fall back to greedy+prune,
#: which yields an irreducible (if not always minimum-cardinality) set.
_EXHAUSTIVE_MAX_CANDIDATES = 12
_EXHAUSTIVE_MAX_SIZE = 6


@dataclass
class _Candidate:
    name: str
    priority: int
    freed: Dict[str, int]  # node -> chips usable capacity eviction frees
    total_chips: int
    creation: str


class Preemptor:
    def __init__(self, store, engine) -> None:
        self.store = store
        self.engine = engine
        # Minimality rationale for the LAST compute_victims call — the
        # decision ledger reads it right after the call returns. Safe as
        # instance state because every caller runs under the scheduler's
        # allocation lock (core.place is the only production call site).
        self.last_search: dict = {}

    # ------------------------------------------------------------------
    def compute_victims(
        self,
        req: ComposabilityRequest,
        shape: SliceShape,
        quarantined: Set[str],
        used: Dict[str, int],
    ) -> List[str]:
        """Minimal victim set making `req`'s shape placeable, or [] when
        preemption is disallowed or cannot help."""
        self.last_search = {}
        if req.spec.preemption_policy != PREEMPT_LOWER_PRIORITY:
            self.last_search = {"mode": "disallowed"}
            return []
        candidates = self._candidates(req, quarantined)
        if not candidates:
            self.last_search = {"mode": "no-candidates", "candidates": 0}
            return []

        # ONE node snapshot for every feasibility probe: the exhaustive
        # search runs up to ~2.5k subset probes, and each demand_feasible
        # would otherwise re-list the whole Node collection — on a wire
        # store that is thousands of scans per failed placement, held
        # under the allocation lock. node_fits is pure given the node and
        # a used map, so the snapshot is exact.
        usable_nodes = self.engine.schedulable_nodes(quarantined)
        target = req.spec.resource.target_node
        target_node = next(
            (n for n in usable_nodes if n.metadata.name == target), None
        )

        def feasible(combo: Tuple[_Candidate, ...]) -> bool:
            sim = dict(used)
            for c in combo:
                for node, chips in c.freed.items():
                    sim[node] = max(0, sim.get(node, 0) - chips)
            if target:
                return (
                    target_node is not None
                    and shape.num_hosts == 1
                    and self.engine.node_fits(
                        req, target_node, shape.chips_per_host, sim
                    )
                )
            fitting = sum(
                1
                for n in usable_nodes
                if self.engine.node_fits(req, n, shape.chips_per_host, sim)
            )
            return fitting >= shape.num_hosts

        # Deterministic candidate order: cheapest victims first.
        candidates.sort(
            key=lambda c: (c.priority, c.total_chips, c.creation, c.name)
        )

        # Native kernel (native/tpusched.cc tpus_victims) when the engine
        # carries a packed snapshot and the library loaded: the same
        # exhaustive-then-greedy search over the packed arrays, probes in
        # O(freed entries) instead of O(nodes). None = fall back to the
        # Python search below (bit-identical by the differential fuzz).
        native = self._native_search(req, shape, quarantined, used, candidates)
        if native is not None:
            victims, self.last_search = native
            return victims

        if not feasible(tuple(candidates)):
            self.last_search = {
                "mode": "infeasible", "candidates": len(candidates),
            }
            return []  # even evicting everyone eligible wouldn't fit

        if len(candidates) <= _EXHAUSTIVE_MAX_CANDIDATES:
            for size in range(1, min(len(candidates), _EXHAUSTIVE_MAX_SIZE) + 1):
                best: Optional[Tuple[tuple, Tuple[_Candidate, ...]]] = None
                for combo in itertools.combinations(candidates, size):
                    if not feasible(combo):
                        continue
                    key = (
                        sum(c.priority for c in combo),
                        sum(c.total_chips for c in combo),
                        tuple(c.name for c in combo),
                    )
                    if best is None or key < best[0]:
                        best = (key, combo)
                if best is not None:
                    self.last_search = {
                        "mode": "exhaustive",
                        "candidates": len(candidates),
                        "set_size": size,
                        "victim_priority_sum": best[0][0],
                        "victim_chips": best[0][1],
                    }
                    return [c.name for c in best[1]]

        victims = self._greedy_prune(candidates, feasible)
        self.last_search = {
            "mode": "greedy+prune",
            "candidates": len(candidates),
            "set_size": len(victims),
        }
        return victims

    # ------------------------------------------------------------------
    def _native_search(
        self,
        req: ComposabilityRequest,
        shape: SliceShape,
        quarantined: Set[str],
        used: Dict[str, int],
        candidates: List[_Candidate],
    ):
        """Pack the sorted candidates + capacity state and run the victim
        search in the native kernel. Returns (victims, last_search) or
        None when the native path is unavailable (no snapshot, no library,
        or a freed node the snapshot does not know — fall back to the
        Python search)."""
        engine = self.engine
        snap_of = getattr(engine, "_snap", None)
        snap = snap_of() if snap_of is not None else None
        lib = getattr(engine, "native", None)
        if snap is None or lib is None:
            return None
        import ctypes

        snap.ensure_dense()
        names = snap.names
        idx = snap._idx
        n = len(names)
        # All-zero state mask == ready, schedulable, not quarantined —
        # exactly the usable set the Python search probes against.
        flags = snap.pack_flags(quarantined, frozenset())
        usable = (ctypes.c_uint8 * max(1, n))(
            *[1 if flags[i] == 0 else 0 for i in range(n)]
        )
        target = req.spec.resource.target_node
        target_mode = target_idx = 0
        if target:
            ti = idx.get(target)
            if ti is not None and usable[ti]:
                target_mode, target_idx = 1, ti
            else:
                # Target set but gone/unusable: no combo is ever feasible
                # (the Python search's target_node-is-None case).
                target_mode = 2
        used_arr = snap.pack_used(used)
        ncand = len(candidates)
        cand_prio = (ctypes.c_int64 * ncand)(*[c.priority for c in candidates])
        cand_chips = (ctypes.c_int64 * ncand)(
            *[c.total_chips for c in candidates]
        )
        # Name ranks: rank order == name lexicographic order, so the
        # kernel's rank-sequence comparison is the tuple-of-names tiebreak.
        by_name = sorted(range(ncand), key=lambda i: candidates[i].name)
        ranks = [0] * ncand
        for r, i in enumerate(by_name):
            ranks[i] = r
        cand_rank = (ctypes.c_int32 * ncand)(*ranks)
        off = [0]
        fidx: List[int] = []
        famt: List[int] = []
        for c in candidates:
            for node, chips in c.freed.items():
                i = idx.get(node)
                if i is None:
                    return None  # freed node unknown to the snapshot
                fidx.append(i)
                famt.append(chips)
            off.append(len(fidx))
        freed_off = (ctypes.c_int32 * (ncand + 1))(*off)
        freed_idx = (ctypes.c_int32 * max(1, len(fidx)))(*fidx)
        freed_amt = (ctypes.c_int32 * max(1, len(famt)))(*famt)
        try:
            sel, info = lib.victims(
                n, snap._slots, used_arr, usable,
                snap._cpu, snap._mem, snap._eph, snap._pods,
                req.spec.resource.other_spec,
                shape.chips_per_host, shape.num_hosts,
                target_mode, target_idx,
                cand_prio, cand_chips, cand_rank,
                freed_off, freed_idx, freed_amt,
                _EXHAUSTIVE_MAX_CANDIDATES, _EXHAUSTIVE_MAX_SIZE,
            )
        except OSError:
            return None
        return [candidates[i].name for i in sel], info

    # ------------------------------------------------------------------
    def _greedy_prune(self, candidates, feasible) -> List[str]:
        """Add cheapest-first until feasible, then drop every member whose
        removal keeps feasibility — an irreducible set in O(n) probes."""
        chosen: List[_Candidate] = []
        for c in candidates:
            chosen.append(c)
            if feasible(tuple(chosen)):
                break
        else:
            return []
        # Prune most-expensive-first so the survivors skew cheap.
        for c in sorted(
            list(chosen),
            key=lambda c: (-c.priority, -c.total_chips, c.name),
        ):
            trial = [x for x in chosen if x is not c]
            if trial and feasible(tuple(trial)):
                chosen = trial
        return [c.name for c in chosen]

    # ------------------------------------------------------------------
    def _candidates(
        self, req: ComposabilityRequest, quarantined: Set[str]
    ) -> List[_Candidate]:
        usable: Set[str] = set()
        for n in self.store.list(Node):
            if (
                n.status.ready
                and not n.spec.unschedulable
                and n.metadata.name not in quarantined
            ):
                usable.add(n.metadata.name)
        children_by_owner: Dict[str, List[ComposableResource]] = {}
        existing_names: Set[str] = set()
        for c in self.store.list(ComposableResource):
            existing_names.add(c.name)
            if c.being_deleted:
                continue
            owner = c.metadata.labels.get(LABEL_MANAGED_BY, "")
            if owner:
                children_by_owner.setdefault(owner, []).append(c)

        out: List[_Candidate] = []
        for other in self.store.list(ComposabilityRequest):
            if other.name == req.name or other.being_deleted:
                continue
            if other.spec.priority >= req.spec.priority:
                continue
            if other.spec.preemption_policy == PREEMPT_NEVER:
                continue
            freed: Dict[str, int] = {}
            for c in children_by_owner.get(other.name, []):
                if c.spec.target_node in usable:
                    chips = c.spec.chip_count if is_chip_group(c.spec.type, c.spec.model) else 1
                    freed[c.spec.target_node] = (
                        freed.get(c.spec.target_node, 0) + chips
                    )
            # Placeholder rows hold capacity exactly like children do in
            # used_slots_map — an Updating victim's claim must be evictable
            # too, or a half-created gang could never be preempted.
            per_member = (
                other.status.slice.chips_per_host
                if is_chip_group(other.spec.resource.type, other.spec.resource.model)
                and other.status.slice.chips_per_host
                else 1
            )
            for name, rs in other.status.resources.items():
                if name not in existing_names and rs.node_name in usable:
                    freed[rs.node_name] = freed.get(rs.node_name, 0) + per_member
            if not freed:
                continue  # nothing this victim frees is usable — skip it
            out.append(
                _Candidate(
                    name=other.name,
                    priority=other.spec.priority,
                    freed=freed,
                    total_chips=sum(freed.values()),
                    creation=other.metadata.creation_timestamp or "",
                )
            )
        return out
