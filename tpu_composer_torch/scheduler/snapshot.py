"""Chip-index snapshot — packed arrays maintained from watch events (port of
``tpu_composer/scheduler/snapshot.py``).

Every placement decision used to start with ``capacity_maps``'s two full
store scans (list every ComposableResource, list every
ComposabilityRequest), then the fit search and the ledger's candidate
scan each re-listed the Node collection. On a 5k-node index that is four
O(cluster) walks of deepcopied objects per decision, all under the
allocation lock — the per-replica ceiling on a large index.

:class:`ChipIndexSnapshot` replaces the walks with incremental
maintenance: it subscribes to the store's watch stream once and folds
each event into

- a node table packed into flat ctypes arrays (free-chip counts,
  ICI/fabric coordinate from the trailing host index, a state bitmask,
  and the other-resource columns ``node_fits`` checks), name-sorted so
  array index order IS node-name lexicographic order — every
  ``(value, name)`` tiebreak in the pure-Python engine becomes a
  ``(value, index)`` tiebreak over the arrays, which is what makes the
  native kernel (the port's ``native/tpusched.cc``) bit-identical to the Python path;
- occupancy accounting equivalent to ``capacity_maps``: child claims,
  placeholder rows (status.resources entries whose child does not exist
  yet), and the per-request sparse maps needed to produce the
  ``occupied`` / ``without`` views for any excluded request in O(claims
  of that request) instead of O(cluster).

Consistency discipline
----------------------

The legacy engine re-reads the store per decision, which (through the
CachedClient's write-response folding, or the in-proc store's
synchronous reads) preserves the *placeholders visible under the
allocation lock* invariant. The snapshot preserves it two ways:

- it subscribes on the **base** store, where ``_notify`` runs
  synchronously inside each CRUD call — an in-proc write is in the watch
  queue before the write returns, so ``sync()`` at decision time is
  read-your-writes. CachedClient and BreakingStore wrappers are
  unwrapped (their watch fan-out is either async or merely proxied);
  a wrapper that can *drop* events (ChaosStore) disables the snapshot
  entirely and the engine stays on the legacy walks;
- on a wire store (KubeStore) the watch is asynchronous, so the
  scheduler additionally **assumes** its own successful placements
  (kube-scheduler's assume/bind split): ``assume()`` folds the granted
  hosts into occupancy immediately, and the assumption is superseded
  when the watch delivers the request's real placeholder rows (or
  dropped on deletion / TTL expiry as a backstop).

``TPUC_NATIVE_SCHED=0`` disables the snapshot (and the native kernel)
entirely; the engine then behaves exactly as before this layer existed.
"""

from __future__ import annotations

import ctypes
import queue as _queue
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from tpu_composer_torch.api.types import (
    ComposabilityRequest,
    ComposableResource,
    LABEL_MANAGED_BY,
    Node,
)
from tpu_composer_torch.topology.slices import is_chip_group

# Verdict codes shared by the native kernel (the port's ``native/tpusched.cc``), the
# pure-Python port below, and the engine's string rendering. Order is the
# node_verdict precedence.
V_OK = 0
V_EXCLUDED = 1
V_QUARANTINED = 2
V_NOT_READY = 3
V_CORDONED = 4
V_NO_PORTS = 5
V_NODE_RESOURCES = 6

VERDICT_STR = {
    V_OK: "ok",
    V_EXCLUDED: "excluded",
    V_QUARANTINED: "quarantined",
    V_NOT_READY: "not-ready",
    V_CORDONED: "cordoned",
    V_NODE_RESOURCES: "node-resources",
}

# State-mask bits (uint8 per node). The base mask carries the node's own
# condition; the per-decision copy ORs in quarantine/exclusion.
F_EXCLUDED = 1
F_QUARANTINED = 2
F_NOT_READY = 4
F_CORDONED = 8

#: Assumed-placement backstop: a granted placement whose placeholder rows
#: never materialize (controller crashed between grant and status write)
#: stops holding phantom capacity after this many seconds.
ASSUME_TTL_S = 30.0


def _watch_source(store):
    """The lossless event source behind ``store``, or None when there is
    none (snapshot must then stay disabled). CachedClient fans events out
    asynchronously after its cache apply and BreakingStore merely proxies,
    so both unwrap to their base; a ChaosStore can drop events on the
    simulated wire, which would silently diverge the accounting."""
    s = store
    for _ in range(4):
        name = type(s).__name__
        if name == "CachedClient":
            s = s.store
            continue
        if name == "BreakingStore":
            s = s._inner
            continue
        break
    if type(s).__name__ in ("Store", "KubeStore"):
        return s
    return None


def _bump(maps: Dict[str, Dict[str, int]], key: str, node: str, delta: int) -> None:
    inner = maps.get(key)
    if inner is None:
        if delta == 0:
            return
        maps[key] = {node: delta}
        return
    v = inner.get(node, 0) + delta
    if v:
        inner[node] = v
    else:
        inner.pop(node, None)
        if not inner:
            maps.pop(key, None)


def _dec(d: Dict[str, int], node: str, chips: int) -> None:
    v = d.get(node, 0) - chips
    if v:
        d[node] = v
    else:
        d.pop(node, None)


class ChipIndexSnapshot:
    """Watch-maintained chip index with packed-array views.

    Thread-safety: all mutation happens in :meth:`sync`, :meth:`assume`
    and :meth:`drop_assumed`, which callers run under the scheduler's
    allocation lock (the same discipline every legacy store walk relied
    on). The internal lock only guards attach/detach races.
    """

    def __init__(self, store, assume_ttl_s: float = ASSUME_TTL_S) -> None:
        self.store = store
        self.assume_ttl_s = assume_ttl_s
        self.active = False
        #: Bumped on every applied change; scan-reuse keys include it so a
        #: retained scan is only ever reused against identical state.
        self.version = 0

        # node name -> (slots, hidx, ready, unsched, cpu, mem, eph, pods)
        self._nodes: Dict[str, tuple] = {}
        # ALL ComposableResource names (incl. being-deleted) — the
        # placeholder test capacity_maps uses is "row name not in existing".
        self._cr_names: Set[str] = set()
        # live child name -> (target_node, chips, owner label)
        self._child: Dict[str, Tuple[str, int, str]] = {}
        # live request name -> {row name -> (node, per_member)}
        self._req_rows: Dict[str, Dict[str, Tuple[str, int]]] = {}
        # row name -> request names carrying a row of that name
        self._row_owners: Dict[str, Set[str]] = {}

        # Derived occupancy (all positive entries, zero-pruned):
        self._occ: Dict[str, int] = {}  # node -> children + placeholders + assumed
        self._req_ph: Dict[str, Dict[str, int]] = {}  # request -> its placeholder claims
        self._req_child: Dict[str, Dict[str, int]] = {}  # request -> its child claims
        self._assumed: Dict[str, Dict[str, int]] = {}
        self._assumed_at: Dict[str, float] = {}

        # Dense (name-sorted) arrays, rebuilt lazily on node-set changes.
        self._names: List[str] = []
        self._idx: Dict[str, int] = {}
        self._dense_dirty = True
        self._slots = self._hidx = self._flags = None
        self._cpu = self._mem = self._eph = self._pods = None
        self._occ_arr = None

        self._lock = threading.Lock()
        self._queues: list = []
        base = _watch_source(store)
        if base is None:
            return
        try:
            # Subscribe BEFORE the initial list: events racing the list
            # re-apply idempotently (every apply diffs against held state).
            for kind in (Node.KIND, ComposableResource.KIND,
                         ComposabilityRequest.KIND):
                self._queues.append((kind, base.watch(kind)))
            self._base = base
            self._rebuild_full()
            self.active = True
        except Exception:
            self._detach()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def _detach(self) -> None:
        self.active = False
        base = getattr(self, "_base", None)
        for _, q in self._queues:
            try:
                if base is not None:
                    base.stop_watch(q)
            except Exception:
                pass
        self._queues = []

    def _rebuild_full(self) -> None:
        self._nodes.clear()
        self._cr_names.clear()
        self._child.clear()
        self._req_rows.clear()
        self._row_owners.clear()
        self._occ.clear()
        self._req_ph.clear()
        self._req_child.clear()
        # Assumptions survive a rebuild: re-fold them on top.
        for claims in self._assumed.values():
            for node, chips in claims.items():
                self._claim(node, chips)
        self._dense_dirty = True
        for n in self.store.list(Node):
            self._apply_node("ADDED", n)
        for c in self.store.list(ComposableResource):
            self._apply_child("ADDED", c)
        for r in self.store.list(ComposabilityRequest):
            self._apply_req("ADDED", r)
        self.version += 1

    # ------------------------------------------------------------------
    # event application (all idempotent: each apply diffs old vs new)
    # ------------------------------------------------------------------
    def _claim(self, node: str, chips: int) -> None:
        if not chips:
            return
        v = self._occ.get(node, 0) + chips
        if v:
            self._occ[node] = v
        else:
            self._occ.pop(node, None)
        if not self._dense_dirty:
            i = self._idx.get(node)
            if i is not None:
                self._occ_arr[i] += chips

    def _apply_node(self, etype: str, obj) -> None:
        name = obj.metadata.name
        if etype == "DELETED":
            if self._nodes.pop(name, None) is not None:
                self._dense_dirty = True
                self.version += 1
            return
        from tpu_composer_torch.scheduler.placement import host_index

        hidx = host_index(name)
        row = (
            int(obj.status.tpu_slots),
            -1 if hidx is None else hidx,
            bool(obj.status.ready),
            bool(obj.spec.unschedulable),
            int(obj.status.milli_cpu),
            int(obj.status.memory),
            int(obj.status.ephemeral_storage),
            int(obj.status.allowed_pod_number),
        )
        if self._nodes.get(name) != row:
            self._nodes[name] = row
            self._dense_dirty = True
            self.version += 1

    def _retire_child(self, name: str) -> None:
        old = self._child.pop(name, None)
        if old is None:
            return
        node, chips, owner = old
        self._claim(node, -chips)
        if owner:
            _bump(self._req_child, owner, node, -chips)

    def _reflow_rows_named(self, row_name: str) -> None:
        """A child named ``row_name`` appeared or vanished: every request
        row of that name flips between placeholder and satisfied."""
        owners = self._row_owners.get(row_name)
        if not owners:
            return
        is_ph = row_name not in self._cr_names
        for req in owners:
            node, per = self._req_rows[req][row_name]
            delta = per if is_ph else -per
            self._claim(node, delta)
            _bump(self._req_ph, req, node, delta)

    def _apply_child(self, etype: str, obj) -> None:
        name = obj.metadata.name
        if etype == "DELETED":
            if name in self._cr_names:
                self._cr_names.discard(name)
                self._retire_child(name)
                self._reflow_rows_named(name)
                self.version += 1
            return
        if name not in self._cr_names:
            self._cr_names.add(name)
            self._reflow_rows_named(name)
        if obj.being_deleted:
            self._retire_child(name)
        else:
            node = obj.spec.target_node
            chips = obj.spec.chip_count if is_chip_group(obj.spec.type, obj.spec.model) else 1
            owner = obj.metadata.labels.get(LABEL_MANAGED_BY, "")
            new = (node, chips, owner)
            if self._child.get(name) != new:
                self._retire_child(name)
                self._child[name] = new
                self._claim(node, chips)
                if owner:
                    _bump(self._req_child, owner, node, chips)
        self.version += 1

    def _retire_req(self, name: str) -> None:
        for row, (node, per) in self._req_rows.pop(name, {}).items():
            owners = self._row_owners.get(row)
            if owners is not None:
                owners.discard(name)
                if not owners:
                    self._row_owners.pop(row, None)
            if row not in self._cr_names:
                self._claim(node, -per)
        self._req_ph.pop(name, None)

    def _apply_req(self, etype: str, obj) -> None:
        name = obj.metadata.name
        if etype == "DELETED" or obj.being_deleted:
            self._retire_req(name)
            self.drop_assumed(name)
            self.version += 1
            return
        res = obj.spec.resource
        per = (
            obj.status.slice.chips_per_host
            if is_chip_group(res.type, res.model) and obj.status.slice.chips_per_host
            else 1
        )
        new_rows = {
            rn: (rs.node_name, per)
            for rn, rs in obj.status.resources.items()
            if rs.node_name
        }
        old_rows = self._req_rows.get(name, {})
        if new_rows != old_rows:
            for row, (node, p) in old_rows.items():
                if row not in new_rows:
                    owners = self._row_owners.get(row)
                    if owners is not None:
                        owners.discard(name)
                        if not owners:
                            self._row_owners.pop(row, None)
                if row not in self._cr_names:
                    self._claim(node, -p)
                    _bump(self._req_ph, name, node, -p)
            for row, (node, p) in new_rows.items():
                self._row_owners.setdefault(row, set()).add(name)
                if row not in self._cr_names:
                    self._claim(node, p)
                    _bump(self._req_ph, name, node, p)
            if new_rows:
                self._req_rows[name] = new_rows
            else:
                self._req_rows.pop(name, None)
        if new_rows:
            # Real claims arrived — the assumption they supersede goes.
            self.drop_assumed(name)
        self.version += 1

    _APPLY = {
        Node.KIND: "_apply_node",
        ComposableResource.KIND: "_apply_child",
        ComposabilityRequest.KIND: "_apply_req",
    }

    # ------------------------------------------------------------------
    # decision-time API
    # ------------------------------------------------------------------
    def sync(self) -> None:
        """Drain the watch queues and fold every pending event in. Called
        at the top of each decision (capacity_maps); in-proc this is
        read-your-writes because _notify is synchronous inside CRUD."""
        if not self.active:
            return
        try:
            for kind, q in self._queues:
                apply = getattr(self, self._APPLY[kind])
                while True:
                    try:
                        ev = q.get(block=False)
                    except _queue.Empty:
                        break
                    if ev is None or getattr(ev, "obj", None) is None:
                        continue
                    apply(ev.type, ev.obj)
        except Exception:
            # A torn event stream means the accounting can no longer be
            # trusted; rebuild from a full list, or disable on failure.
            try:
                self._rebuild_full()
            except Exception:
                self._detach()
                return
        if self._assumed_at:
            now = time.monotonic()
            for name in [
                n for n, at in self._assumed_at.items()
                if now - at > self.assume_ttl_s
            ]:
                self.drop_assumed(name)

    def assume(self, request: str, claims: Dict[str, int]) -> None:
        """Fold a just-granted placement into occupancy before its status
        write lands (kube-scheduler's assume): node -> chips claimed."""
        if not self.active or not claims:
            return
        self.drop_assumed(request)
        self._assumed[request] = dict(claims)
        self._assumed_at[request] = time.monotonic()
        for node, chips in claims.items():
            self._claim(node, chips)
        self.version += 1

    def drop_assumed(self, request: str) -> None:
        claims = self._assumed.pop(request, None)
        self._assumed_at.pop(request, None)
        if claims:
            for node, chips in claims.items():
                self._claim(node, -chips)
            self.version += 1

    def capacity_views(
        self, exclude_request: str = ""
    ) -> Tuple[Dict[str, int], Dict[str, int]]:
        """The two dicts capacity_maps returns, from the accounting: the
        excluded request's placeholders (and assumed claims — its re-solve
        replaces those exactly like placeholders) come out of both views,
        its children out of ``without`` only."""
        occupied = dict(self._occ)
        if exclude_request:
            for node, chips in self._req_ph.get(exclude_request, {}).items():
                _dec(occupied, node, chips)
            for node, chips in self._assumed.get(exclude_request, {}).items():
                _dec(occupied, node, chips)
        without = dict(occupied)
        if exclude_request:
            for node, chips in self._req_child.get(exclude_request, {}).items():
                _dec(without, node, chips)
        return occupied, without

    # ------------------------------------------------------------------
    # packed views
    # ------------------------------------------------------------------
    @property
    def names(self) -> List[str]:
        self.ensure_dense()
        return self._names

    def ensure_dense(self) -> None:
        if not self._dense_dirty:
            return
        names = sorted(self._nodes)
        n = len(names)
        self._names = names
        self._idx = {nm: i for i, nm in enumerate(names)}
        rows = [self._nodes[nm] for nm in names]
        self._slots = (ctypes.c_int32 * n)(*[r[0] for r in rows])
        self._hidx = (ctypes.c_int32 * n)(*[r[1] for r in rows])
        self._flags = (ctypes.c_uint8 * n)(*[
            (0 if r[2] else F_NOT_READY) | (F_CORDONED if r[3] else 0)
            for r in rows
        ])
        self._cpu = (ctypes.c_int64 * n)(*[r[4] for r in rows])
        self._mem = (ctypes.c_int64 * n)(*[r[5] for r in rows])
        self._eph = (ctypes.c_int64 * n)(*[r[6] for r in rows])
        self._pods = (ctypes.c_int64 * n)(*[r[7] for r in rows])
        self._occ_arr = (ctypes.c_int32 * n)(*[
            self._occ.get(nm, 0) for nm in names
        ])
        self._dense_dirty = False

    def pack_used(self, used: Dict[str, int]):
        """A used-chips column aligned to the name-sorted node order, from
        any capacity view dict. O(claims), not O(nodes) — ctypes arrays
        zero-initialize. Claims on absent nodes are dropped, exactly as
        the legacy walk never consults them."""
        self.ensure_dense()
        arr = (ctypes.c_int32 * len(self._names))()
        idx = self._idx
        for name, v in used.items():
            i = idx.get(name)
            if i is not None:
                arr[i] = v
        return arr

    def pack_flags(self, quarantined: Set[str], exclude: Set[str]):
        """Per-decision state mask: the base node-condition bits plus this
        decision's quarantine/exclusion sets."""
        self.ensure_dense()
        n = len(self._names)
        arr = (ctypes.c_uint8 * n)()
        ctypes.memmove(arr, self._flags, n)
        idx = self._idx
        for name in quarantined:
            i = idx.get(name)
            if i is not None:
                arr[i] |= F_QUARANTINED
        for name in exclude:
            i = idx.get(name)
            if i is not None:
                arr[i] |= F_EXCLUDED
        return arr


# ----------------------------------------------------------------------
# pure-Python kernel — the bit-identical fallback for the native scan
# ----------------------------------------------------------------------
def py_scan(
    n: int,
    slots,
    used,
    hidx,
    flags,
    cpu,
    mem,
    eph,
    pods,
    other,  # OtherResourcesSpec or None
    chips: int,
    count: int,
):
    """One pass over the packed arrays producing exactly what the native
    ``tpus_scan`` produces: per-node clamped free chips, verdict codes,
    the candidate-verdicts ordering (fitting nodes in tightest-fit order,
    then rejected nodes), and — when ``count >= 1`` and enough nodes fit —
    the selected host indices (tightest-fit greedy refined by the
    ICI-contiguity window). Returns (num_ok, free, verdict, order, sel);
    ``sel`` is None when no selection was requested or possible."""
    free = [0] * n
    raw = [0] * n
    verdict = [0] * n
    ok: List[int] = []
    rejected: List[int] = []
    if other is not None:
        need_cpu = other.milli_cpu
        need_mem = other.memory
        need_eph = other.ephemeral_storage
        need_pods = other.allowed_pod_number
    for i in range(n):
        f = slots[i] - used[i]
        raw[i] = f
        free[i] = f if f > 0 else 0
        fl = flags[i]
        if fl & F_EXCLUDED:
            v = V_EXCLUDED
        elif fl & F_QUARANTINED:
            v = V_QUARANTINED
        elif fl & F_NOT_READY:
            v = V_NOT_READY
        elif fl & F_CORDONED:
            v = V_CORDONED
        elif f < chips:
            v = V_NO_PORTS
        elif other is not None and (
            cpu[i] < need_cpu or mem[i] < need_mem
            or eph[i] < need_eph or pods[i] < need_pods
        ):
            v = V_NODE_RESOURCES
        else:
            v = V_OK
            ok.append(i)
        verdict[i] = v
        if v != V_OK:
            rejected.append(i)
    # Tightest-fit order: least free-after-placement first; index order is
    # name order, so (free, i) == the legacy (free, name) tiebreak.
    ok.sort(key=lambda i: (raw[i], i))
    order = ok + rejected
    num_ok = len(ok)
    if count < 1 or num_ok < count:
        return num_ok, free, verdict, order, None
    greedy = ok[:count]
    if count == 1:
        return num_ok, free, verdict, order, greedy
    best_sum = sum(raw[i] for i in greedy)
    indexed = sorted(
        (i for i in ok if hidx[i] >= 0), key=lambda i: (hidx[i], i)
    )
    best = None  # (span, start_index, window)
    for s in range(len(indexed) - count + 1):
        window = indexed[s:s + count]
        if any(
            hidx[window[j]] == hidx[window[j + 1]] for j in range(count - 1)
        ):
            continue
        if sum(raw[i] for i in window) != best_sum:
            continue
        span = hidx[window[-1]] - hidx[window[0]] - (count - 1)
        key = (span, hidx[window[0]])
        if best is None or key < best[:2]:
            best = (span, hidx[window[0]], window)
    if best is not None:
        return num_ok, free, verdict, order, best[2]
    return num_ok, free, verdict, order, greedy
