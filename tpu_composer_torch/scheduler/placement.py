"""Placement engine — cluster-wide capacity accounting and host selection
(port of ``tpu_composer/scheduler/placement.py``).

This is the allocator's placement brain, lifted out of
``ComposabilityRequestReconciler`` (which used to keep ``_pick_nodes`` /
``_pick_extra_nodes`` / ``_used_slots_map`` inline) so that placement policy
is arbitrated cluster-wide instead of per-request: the scheduler facade
(``scheduler/core.py``) runs priority, gang-admission and preemption
decisions on top of the primitives here, and the controller only executes
what the engine decides — the composable split arXiv:2506.23628 argues for
(placement engine separate from the reconciler that executes it).

Two placement properties matter for TPU slices and drive the scoring:

- **Fragmentation-aware bin-packing** (tightest-fit): sub-host chip groups
  pack onto already-fragmented hosts, keeping whole hosts intact for the
  topology shapes that need all their ports. The 256-node mixed-size storm
  exposed the opposite (least-loaded-first) policy deadlocking whole-host
  slices behind scattered singles — fragmentation the reference operator
  never sees because its devices are independent, while TPU workers are
  all-or-nothing port groups. Selecting the ``count`` hosts with the least
  free-after-placement is sum-optimal for this objective.
- **ICI contiguity**: multi-host slices want physically adjacent hosts on
  the optical fabric (wrap-around links span neighboring trays; compare
  arXiv:2404.06467's fabric-topology-aware assignment). Host adjacency is
  inferred from the trailing integer in the node name (worker-3, tpu-host-12);
  among equally-packed host sets the engine prefers the window with the
  smallest index span.

The NVIDIA H100 (``nvidia-h100-sxm``) is placed as a chip group
(``topology.is_chip_group``, the reference's ``type == "tpu"`` plus the
H100): a member holds ``chip_count`` of its
host's GPU slots (``Node.status.tpu_slots``), never one. Its hosts meet
over InfiniBand with no torus, so the contiguity window has no meaning for
an H100; it is kept unchanged (it costs nothing there) so that TPU rows
decide exactly as the JAX package's engine does.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from tpu_composer_torch.api.types import (
    ComposabilityRequest,
    ComposableResource,
    LABEL_MANAGED_BY,
    Node,
)
from tpu_composer_torch.fabric.provider import FabricError
from tpu_composer_torch.scheduler import snapshot as snap_mod
from tpu_composer_torch.topology.slices import SliceShape, is_chip_group


class AllocationError(FabricError):
    """No valid placement exists right now — surfaced in status.error."""


_TRAILING_INT = re.compile(r"(\d+)$")


def host_index(name: str) -> Optional[int]:
    """Fabric position inferred from the node name's trailing integer
    (worker-3 -> 3); None when the name carries no index."""
    m = _TRAILING_INT.search(name)
    return int(m.group(1)) if m else None


class PlacementEngine:
    """Capacity accounting + fragmentation/contiguity-scored host picking.

    Stateless aside from the store handle: every decision re-reads the
    cluster, so the caller (the request controller under its allocation
    lock, or the defrag planner) always sees placeholders written by the
    allocation that just finished.

    The handle is normally the CachedClient (cmd/main ``--cached-reads``),
    which is what makes "re-read everything per decision" affordable at
    fleet scale: capacity_maps' two full scans and every feasibility
    probe's node list are informer-cache snapshots (zero RTT), and the
    write-response folding in the client preserves the
    placeholders-visible-under-the-lock invariant the docstring above
    relies on.

    With a :class:`~tpu_composer_torch.scheduler.snapshot.ChipIndexSnapshot`
    attached (ClusterScheduler wires one unless TPUC_NATIVE_SCHED=0), the
    capacity views come from incrementally-maintained accounting instead
    of store walks, and the fit search / candidate-verdict scan run over
    the snapshot's packed arrays — through the native kernel
    (the port's native/tpusched.cc) when loaded, else the bit-identical pure-Python
    port. One scan serves both the host selection and the decision
    ledger's candidate doc (the retained-scan reuse in
    candidate_verdicts), which is what brought the decision-plane
    overhead back under the perf-smoke gate.
    """

    def __init__(self, store, snapshot=None, native=None) -> None:
        self.store = store
        #: ChipIndexSnapshot or None (legacy store-walk engine).
        self.snapshot = snapshot
        #: scheduler.native._NativeLib or None (pure-Python kernel).
        self.native = native
        # The last packed scan (fit search or verdict scan) and its
        # identity key — candidate_verdicts reuses it when the decision
        # inputs are unchanged instead of re-scanning the cluster.
        self._last_scan: Optional[tuple] = None
        #: "native" | "python" | "legacy" — which kernel produced the last
        #: selection (observability: cmd/main logs it, bench records it).
        self.last_scan_kind = "legacy"

    def _snap(self):
        s = self.snapshot
        return s if s is not None and s.active else None

    @property
    def kernel_kind(self) -> str:
        """Which engine layer decisions run on: "native" (packed snapshot
        + C kernel), "python" (packed snapshot, pure-Python kernel), or
        "legacy" (per-decision store walks)."""
        if self._snap() is None:
            return "legacy"
        return "native" if self.native is not None else "python"

    # ------------------------------------------------------------------
    # capacity accounting
    # ------------------------------------------------------------------
    def capacity_maps(
        self, exclude_request: str = ""
    ) -> Tuple[Dict[str, int], Dict[str, int]]:
        """ONE store pass building the two views a placement decision
        needs, node -> chips claimed there:

        - ``occupied``: every live claim — all instantiated children plus
          OTHER requests' placeholder rows (rows whose child doesn't exist
          yet; without the placeholder term, concurrent allocations all
          pick the same least-loaded node before any child materializes —
          the occupancy check vs other requests,
          composabilityrequest_controller.go:386-443). The excluded
          request's own placeholders are omitted because its re-solve
          replaces them, but its own CHILDREN count: the backfill gate
          must see capacity a grow-path request already holds, or growing
          onto a contended host reads as free and the gate lets a
          low-priority grow starve a pending high-priority demand.
        - ``without``: additionally omits the excluded request's own
          children — the view its OWN host picking must use (its survivors
          don't compete with their replacement).

        Allocation holds the controller's lock, so per-candidate rescans
        would serialize the whole fleet behind O(N*R) work — hence both
        maps from one pass."""
        snap = self._snap()
        if snap is not None:
            snap.sync()
            return snap.capacity_views(exclude_request)
        occupied: Dict[str, int] = {}
        without: Dict[str, int] = {}
        existing = {c.name: c for c in self.store.list(ComposableResource)}
        for c in existing.values():
            if c.being_deleted:
                continue
            n = c.spec.chip_count if is_chip_group(c.spec.type, c.spec.model) else 1
            node = c.spec.target_node
            occupied[node] = occupied.get(node, 0) + n
            if c.metadata.labels.get(LABEL_MANAGED_BY) != exclude_request:
                without[node] = without.get(node, 0) + n
        for other in self.store.list(ComposabilityRequest):
            if other.name == exclude_request or other.being_deleted:
                continue
            per_member = (
                other.status.slice.chips_per_host
                if is_chip_group(other.spec.resource.type, other.spec.resource.model)
                and other.status.slice.chips_per_host
                else 1
            )
            for name, rs in other.status.resources.items():
                if name not in existing and rs.node_name:
                    occupied[rs.node_name] = (
                        occupied.get(rs.node_name, 0) + per_member
                    )
                    without[rs.node_name] = (
                        without.get(rs.node_name, 0) + per_member
                    )
        return occupied, without

    def used_slots_map(self, exclude_request: str = "") -> Dict[str, int]:
        """The placement view only (see capacity_maps)."""
        return self.capacity_maps(exclude_request)[1]

    def node_fits(
        self,
        req: ComposabilityRequest,
        node: Node,
        chips: int,
        used: Dict[str, int],
    ) -> bool:
        if node.status.tpu_slots - used.get(node.metadata.name, 0) < chips:
            return False
        other = req.spec.resource.other_spec
        if other is not None:
            # CheckNodeCapacitySufficient analog (utils/nodes.go:78-117).
            if (
                node.status.milli_cpu < other.milli_cpu
                or node.status.memory < other.memory
                or node.status.ephemeral_storage < other.ephemeral_storage
                or node.status.allowed_pod_number < other.allowed_pod_number
            ):
                return False
        return True

    def fragmentation(
        self,
        quarantined: Set[str] = frozenset(),
        used: Optional[Dict[str, int]] = None,
    ) -> float:
        """Share of free TPU capacity stranded on partially-used hosts:
        ``1 - (free slots on fully-free hosts / total free slots)`` over
        schedulable hosts. 0.0 means every free port sits on an empty host
        (any multi-host shape that fits the totals can compose); 1.0 means
        all free capacity hides in gaps no whole-host worker can use.
        0.0 when nothing is free (an exactly-full cluster isn't fragmented,
        it's full)."""
        used = self.used_slots_map() if used is None else used
        total_free = 0
        whole_free = 0
        for n in self.store.list(Node):
            if (
                not n.status.ready
                or n.spec.unschedulable
                or n.metadata.name in quarantined
            ):
                continue
            u = used.get(n.metadata.name, 0)
            free = max(0, n.status.tpu_slots - u)
            total_free += free
            if u == 0:
                whole_free += free
        if total_free == 0:
            return 0.0
        return 1.0 - whole_free / total_free

    # ------------------------------------------------------------------
    # host selection
    # ------------------------------------------------------------------
    def pick_hosts(
        self,
        req: ComposabilityRequest,
        shape: SliceShape,
        quarantined: Set[str],
        used: Optional[Dict[str, int]] = None,
    ) -> List[str]:
        """Choose shape.num_hosts nodes with free TPU ports + capacity.
        `quarantined` is the allocation pass's one DeviceTaintRule scan,
        threaded through so no picker re-lists.

        Policies (:361-467 analog): explicit target_node (single-host only),
        samenode (single-host auto-pick), differentnode/topology (spread).
        """
        res = req.spec.resource
        if used is None:
            used = self.used_slots_map(req.name)
        if res.target_node:
            if shape.num_hosts > 1:
                raise AllocationError(
                    f"topology {shape.topology} spans {shape.num_hosts} hosts;"
                    " target_node only supports single-host slices"
                )
            node = self.store.try_get(Node, res.target_node)
            if node is None:
                raise AllocationError(
                    f"target node {res.target_node} does not exist"
                )
            if res.target_node in quarantined:
                raise AllocationError(
                    f"target node {res.target_node} is quarantined"
                    " (fabric attach budget exhausted)"
                )
            if not self.node_fits(req, node, shape.chips_per_host, used):
                raise AllocationError(
                    f"target node {res.target_node} lacks capacity for"
                    f" {shape.chips_per_host} chips"
                )
            return [res.target_node]

        # For tpu, allocation_policy does not constrain host count — the
        # topology dictates it (a 2x2x2 slice needs exactly 2 hosts). The
        # policy is honored as a placement preference: tightest-fit packing
        # (see pick_slice_hosts); differentnode is identical for slices
        # since workers always land on distinct hosts.
        return self.pick_slice_hosts(
            req, shape, exclude=set(), count=shape.num_hosts,
            quarantined=quarantined, used=used,
        )

    def pick_slice_hosts(
        self,
        req: ComposabilityRequest,
        shape: SliceShape,
        exclude: Set[str],
        count: int,
        quarantined: Set[str],
        used: Optional[Dict[str, int]] = None,
    ) -> List[str]:
        """Slice placement: `count` hosts with capacity for one worker's
        chip group each. Fresh allocations pass exclude=∅ and the full host
        count; the grow path excludes surviving members' hosts and asks for
        only the delta — one filter/sort, so placement policy can't diverge
        between the two."""
        if used is None:
            used = self.used_slots_map(req.name)
        if count < 1:
            return []
        snap = self._snap()
        if snap is not None:
            num_ok, _free, _verd, _order, sel = self._kernel_scan(
                req, shape.chips_per_host, quarantined, exclude, used,
                count, snap,
            )
            if sel is None:
                raise AllocationError(
                    f"need {count} {'more ' if exclude else ''}hosts with"
                    f" {shape.chips_per_host} free TPU ports for"
                    f" {shape.topology}, only {num_ok} available"
                )
            names = snap.names
            return [names[i] for i in sel]
        candidates = [
            n for n in self.store.list(Node)
            if n.metadata.name not in exclude
            and n.metadata.name not in quarantined
            and n.status.ready and not n.spec.unschedulable
            and self.node_fits(req, n, shape.chips_per_host, used)
        ]
        if len(candidates) < count:
            raise AllocationError(
                f"need {count} {'more ' if exclude else ''}hosts with"
                f" {shape.chips_per_host} free TPU ports for"
                f" {shape.topology}, only {len(candidates)} available"
            )

        def free_after(n: Node) -> int:
            return n.status.tpu_slots - used.get(n.metadata.name, 0)

        # Tightest-fit first (fewest ports left free after placement) —
        # picking the `count` smallest leftovers is sum-optimal for the
        # fragmentation objective, so every refinement below must tie it.
        candidates.sort(key=lambda n: (free_after(n), n.metadata.name))
        greedy = candidates[:count]
        if count <= 1:
            return [n.metadata.name for n in greedy]
        best_sum = sum(free_after(n) for n in greedy)

        # ICI-contiguity refinement: among host sets that tie the packing
        # optimum, prefer the window of consecutive fabric indices with the
        # smallest span (0 = perfectly contiguous trays). Hosts without a
        # parseable index can't participate in a window.
        indexed = [
            (host_index(n.metadata.name), n)
            for n in candidates
            if host_index(n.metadata.name) is not None
        ]
        indexed.sort(key=lambda t: (t[0], t[1].metadata.name))
        best_window = None  # (span, start_index, [nodes])
        for i in range(len(indexed) - count + 1):
            window = indexed[i : i + count]
            if any(
                window[j][0] == window[j + 1][0] for j in range(count - 1)
            ):
                # Duplicate trailing integers (rack-a-host2 / rack-b-host2)
                # are NOT adjacency — a duplicate both skews the span
                # negative and can mask a real gap ([2,2,4] spans 0).
                continue
            if sum(free_after(n) for _, n in window) != best_sum:
                continue
            span = window[-1][0] - window[0][0] - (count - 1)
            key = (span, window[0][0])
            if best_window is None or key < best_window[:2]:
                best_window = (span, window[0][0], [n for _, n in window])
        if best_window is not None:
            return [n.metadata.name for n in best_window[2]]
        return [n.metadata.name for n in greedy]

    def pick_scalar_nodes(
        self,
        req: ComposabilityRequest,
        count: int,
        existing: Sequence[str],
        quarantined: Set[str],
        used: Optional[Dict[str, int]] = None,
    ) -> List[str]:
        """gpu/cxlmemory placement — the reference's independent-device
        policies (samenode / differentnode, :361-467) on top of the same
        capacity map the slice picker uses."""
        res = req.spec.resource
        if used is None:
            used = self.used_slots_map(req.name)
        if res.target_node:
            node = self.store.try_get(Node, res.target_node)
            if node is None:
                raise AllocationError(
                    f"target node {res.target_node} does not exist"
                )
            if res.target_node in quarantined:
                raise AllocationError(
                    f"target node {res.target_node} is quarantined"
                    " (fabric attach budget exhausted)"
                )
            # Capacity must cover everything this request puts there.
            already = sum(1 for e in existing if e == res.target_node)
            if not self.node_fits(req, node, already + count, used):
                raise AllocationError(
                    f"target node {res.target_node} lacks"
                    f" {already + count} free device ports"
                )
            return [res.target_node] * count
        nodes = [
            n for n in self.store.list(Node)
            if n.status.ready and not n.spec.unschedulable
            and n.metadata.name not in quarantined
            and self.node_fits(req, n, 1, used)
        ]
        if not nodes:
            raise AllocationError("no schedulable node with free device ports")
        if res.allocation_policy == "samenode":
            if existing:
                anchor_name = existing[0]
            else:
                anchor_name = min(
                    nodes, key=lambda n: (used.get(n.name, 0), n.name)
                ).metadata.name
            anchor = self.store.try_get(Node, anchor_name)
            already = sum(1 for e in existing if e == anchor_name)
            if anchor is None or not self.node_fits(
                req, anchor, already + count, used
            ):
                raise AllocationError(
                    f"samenode anchor {anchor_name} lacks"
                    f" {already + count} free device ports"
                )
            return [anchor_name] * count
        # differentnode: spread over distinct nodes not already used (:444-467)
        taken = set(existing)
        fresh = [n.metadata.name for n in nodes if n.metadata.name not in taken]
        if len(fresh) < count:
            raise AllocationError(
                f"differentnode policy needs {count} unused nodes,"
                f" found {len(fresh)}"
            )
        fresh.sort(key=lambda nm: (used.get(nm, 0), nm))
        return fresh[:count]

    # ------------------------------------------------------------------
    # packed-array kernel dispatch (snapshot attached): native scan when
    # the library is loaded, bit-identical pure-Python port otherwise
    # ------------------------------------------------------------------
    def _scan_inputs_key(self, chips, quarantined, exclude, used, other, snap):
        """Identity of one scan's inputs. ``used`` rides by object id:
        within one snapshot version the capacity views for a given exclude
        set are deterministic, and exclude/quarantine are in the key, so
        an id collision across decisions can only alias an identical
        scan."""
        okey = None if other is None else (
            other.milli_cpu, other.memory,
            other.ephemeral_storage, other.allowed_pod_number,
        )
        return (
            chips, tuple(sorted(quarantined)), tuple(sorted(exclude)),
            id(used), snap.version, okey,
        )

    def _kernel_scan(self, req, chips, quarantined, exclude, used, count, snap):
        """One pass over the packed snapshot: per-node free + verdict
        codes, the candidate ordering, and (count >= 1) the selected host
        indices. The scan is retained so candidate_verdicts for the same
        decision reuses it instead of walking the cluster again."""
        snap.ensure_dense()
        n = len(snap.names)
        used_arr = snap.pack_used(used)
        flags = snap.pack_flags(quarantined, exclude)
        other = req.spec.resource.other_spec
        res = None
        if self.native is not None:
            try:
                res = self.native.scan(
                    n, snap._slots, used_arr, snap._hidx, flags,
                    snap._cpu, snap._mem, snap._eph, snap._pods,
                    other, chips, count,
                )
                self.last_scan_kind = "native"
            except OSError:
                res = None
        if res is None:
            res = snap_mod.py_scan(
                n, snap._slots, used_arr, snap._hidx, flags,
                snap._cpu, snap._mem, snap._eph, snap._pods,
                other, chips, count,
            )
            self.last_scan_kind = "python"
        key = self._scan_inputs_key(chips, quarantined, exclude, used,
                                    other, snap)
        self._last_scan = (key, list(snap.names), res)
        return res

    def _scan_candidates(self, names, res, chips, cap=None):
        """Materialize the candidates-considered doc from a retained scan
        — only the first ``cap`` dicts when the ledger will truncate
        anyway (the O(nodes)-dicts materialization was half the decision
        plane's cost on a large index)."""
        _num_ok, free, verd, order, _sel = res
        total = len(order) if cap is None else min(cap, len(order))
        out: List[Dict[str, object]] = []
        for k in range(total):
            i = order[k]
            v = verd[i]
            if v == snap_mod.V_NO_PORTS:
                vs = f"no-tpu-ports free={free[i]} need={chips}"
            else:
                vs = snap_mod.VERDICT_STR[v]
            out.append({
                "node": names[i], "free": int(free[i]), "verdict": vs,
            })
        return out

    # ------------------------------------------------------------------
    # decision-ledger explain helpers (never on the hot path: built only
    # when the scheduler's DecisionLedger is enabled)
    # ------------------------------------------------------------------
    def node_verdict(
        self,
        req: ComposabilityRequest,
        node: Node,
        chips: int,
        used: Dict[str, int],
        quarantined: Set[str],
        exclude: Set[str] = frozenset(),
    ) -> Optional[str]:
        """Why this node cannot host ``chips`` for ``req`` (None = it
        can). The explain twin of :meth:`node_fits`, split so each
        rejection names its constraint instead of collapsing to bool."""
        name = node.metadata.name
        if name in exclude:
            return "excluded"
        if name in quarantined:
            return "quarantined"
        if not node.status.ready:
            return "not-ready"
        if node.spec.unschedulable:
            return "cordoned"
        free = node.status.tpu_slots - used.get(name, 0)
        if free < chips:
            return f"no-tpu-ports free={max(0, free)} need={chips}"
        other = req.spec.resource.other_spec
        if other is not None and (
            node.status.milli_cpu < other.milli_cpu
            or node.status.memory < other.memory
            or node.status.ephemeral_storage < other.ephemeral_storage
            or node.status.allowed_pod_number < other.allowed_pod_number
        ):
            return "node-resources"
        return None

    def candidate_verdicts(
        self,
        req: ComposabilityRequest,
        chips: int,
        quarantined: Set[str],
        used: Dict[str, int],
        exclude: Set[str] = frozenset(),
        cap: Optional[int] = None,
    ) -> List[Dict[str, object]]:
        """Every node's verdict for one worker's chip group — the
        candidates-considered section of a DecisionRecord. Sorted fitting
        nodes first (tightest-fit order, mirroring the picker), then
        rejected ones by name. ``cap`` truncates AFTER the sort (what the
        ledger's candidate cap would keep anyway). With a snapshot
        attached, the verdicts come from the same packed scan the
        placement already ran when the inputs match — the second full
        walk of the cluster is gone from the decision plane."""
        snap = self._snap()
        if snap is not None:
            other = req.spec.resource.other_spec
            key = self._scan_inputs_key(chips, quarantined, exclude, used,
                                        other, snap)
            if self._last_scan is not None and self._last_scan[0] == key:
                _key, names, res = self._last_scan
            else:
                res = self._kernel_scan(
                    req, chips, quarantined, exclude, used, 0, snap
                )
                names = self._last_scan[1]
            return self._scan_candidates(names, res, chips, cap=cap)
        out: List[Dict[str, object]] = []
        for n in self.store.list(Node):
            verdict = self.node_verdict(req, n, chips, used, quarantined,
                                        exclude=exclude)
            out.append({
                "node": n.metadata.name,
                "free": max(0, n.status.tpu_slots
                            - used.get(n.metadata.name, 0)),
                "verdict": verdict or "ok",
            })
        out.sort(key=lambda c: (
            c["verdict"] != "ok", c["free"] if c["verdict"] == "ok" else 0,
            c["node"],
        ))
        return out if cap is None else out[:cap]

    def tiebreak_rationale(
        self, chosen: Sequence[str], used: Dict[str, int]
    ) -> str:
        """Reconstruct why THESE hosts won from the same inputs the picker
        scored: the tightest-fit leftover sum, and the ICI window span when
        every chosen host carries a parseable fabric index. Read-only over
        the decision's own ``used`` map — the hot picker stays untouched."""
        if not chosen:
            return ""
        frees = []
        for name in chosen:
            node = self.store.try_get(Node, name)
            if node is None:
                return "tightest-fit"
            frees.append(node.status.tpu_slots - used.get(name, 0))
        parts = [f"tightest-fit leftover={sum(frees)}"]
        if len(chosen) > 1:
            idx = [host_index(n) for n in chosen]
            if all(i is not None for i in idx):
                span = max(idx) - min(idx) - (len(chosen) - 1)  # type: ignore[arg-type]
                parts.append(
                    "ICI-contiguous window" if span == 0
                    else f"ICI window span={span}"
                )
        return ", ".join(parts)

    # ------------------------------------------------------------------
    # feasibility probes (gate + preemption simulation)
    # ------------------------------------------------------------------
    def schedulable_nodes(self, quarantined: Set[str]) -> List[Node]:
        """One snapshot of the hosts placement may use — callers that run
        many feasibility probes (the gate, the victim-set search, defrag's
        hold-back check) take this ONCE per pass and thread it through,
        instead of re-listing the Node collection per probe under the
        allocation lock."""
        return [
            n for n in self.store.list(Node)
            if n.status.ready
            and not n.spec.unschedulable
            and n.metadata.name not in quarantined
        ]

    def demand_feasible(
        self,
        req: ComposabilityRequest,
        num_hosts: int,
        chips_per_host: int,
        quarantined: Set[str],
        used: Dict[str, int],
        anchor: str = "",
        nodes: Optional[List[Node]] = None,
        exclude_nodes: tuple = (),
    ) -> bool:
        """Could a (num_hosts × chips_per_host) demand place under `used`?
        Pure counting — no selection — so gate and victim-set search can
        simulate many capacity states cheaply. ``anchor`` pins the demand
        to one specific host beyond what the spec says — a samenode
        request with devices already placed can only ever grow on its
        anchor node, and a gate probe that ignored that would call an
        actually-starved request 'still feasible' elsewhere. ``nodes`` is
        an optional schedulable_nodes() snapshot to probe against."""
        res = req.spec.resource
        pinned = anchor or res.target_node
        if pinned:
            node = None
            if nodes is not None:
                node = next(
                    (n for n in nodes if n.metadata.name == pinned), None
                )
            if node is None:
                # target_node placement bypasses cordon in the picker, so
                # the probe falls back to a direct lookup rather than
                # calling a pinned demand infeasible on a cordoned host.
                node = self.store.try_get(Node, pinned)
            return (
                node is not None
                and pinned not in quarantined
                and num_hosts == 1
                and self.node_fits(req, node, chips_per_host, used)
            )
        if nodes is None:
            nodes = self.schedulable_nodes(quarantined)
        fitting = sum(
            1 for n in nodes
            if n.metadata.name not in exclude_nodes
            and self.node_fits(req, n, chips_per_host, used)
        )
        return fitting >= num_hosts
