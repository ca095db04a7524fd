"""Macro-scale churn generator: deterministic open-loop request workloads
(port of ``tpu_composer/sim/churn.py``; the same seed gives the same plan
and trace digest in both packages).

The 32-GPU composable-system study (PAPERS.md 2404.06467) publishes scaling
*curves*; producing one needs a workload that is (a) open-loop — arrivals
don't wait for the system, so a slow control plane builds real queues —
(b) macroscopic — thousands of concurrent ComposabilityRequests churning
(arrive/cancel/resize/migrate) over a 5-10k-node inventory — and
(c) deterministic — the same seed must yield byte-identical event traces so
curve points and CI reruns are comparable.

Three layers, smallest to largest:

- ``generate_plan(seed, ...)`` → ``ChurnPlan``: the seeded event trace.
  Pure function of its arguments; ``plan.trace_digest()`` is the replay-
  determinism witness (same seed → same digest, asserted in CI).
- ``simulate(plan)``: a fast in-memory placement state machine that runs the
  plan at full macro scale (50k+ CRs over 5-10k nodes in seconds) and
  reports placements, queue-wait percentiles (in sim time), and goodput —
  the capacity model that sizes live runs and proves the generator itself
  sustains macro scale.
- ``ChurnDriver``: replays a (smaller) plan in real time against a live
  wire-level store (the sim apiserver) with real HTTP verbs — POST arrive,
  finalizer-honoring DELETE cancel, read-modify-write PUT resize with 409
  retry, NodeMaintenance post/delete for migrate. An H100 model
  (``nvidia-h100-sxm``) arrives as a ``gpu`` request, a TPU model as a
  ``tpu`` one.

Everything here is seeded ``random.Random``; wall clock never influences
the trace (only ChurnDriver's pacing).
"""

from __future__ import annotations

import hashlib
import heapq
import json
import os as _os
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import random as _random

from tpu_composer_torch.runtime import wiremux
from tpu_composer_torch.topology import is_gpu_model

ARRIVE = "arrive"
CANCEL = "cancel"
RESIZE = "resize"
MIGRATE = "migrate"


@dataclass(frozen=True)
class ChurnEvent:
    """One open-loop event. ``name`` is the CR name (arrive/cancel/resize)
    or the node name (migrate). ``size`` is the initial chip count on
    arrive, the new chip count on resize, 0 otherwise."""

    at_s: float
    kind: str
    name: str
    model: str = ""
    size: int = 0

    def line(self) -> str:
        return f"{self.at_s:.6f} {self.kind} {self.name} {self.model} {self.size}"


@dataclass
class ChurnPlan:
    """A seeded, fully materialized event trace plus the inventory it is
    meant to run against. The digest is the determinism contract."""

    seed: int
    nodes: int
    chips_per_node: int
    duration_s: float
    requests: int
    events: List[ChurnEvent] = field(default_factory=list)

    def trace_digest(self) -> str:
        h = hashlib.sha256()
        h.update(
            f"{self.seed}/{self.nodes}/{self.chips_per_node}/"
            f"{self.duration_s}/{self.requests}\n".encode()
        )
        for ev in self.events:
            h.update(ev.line().encode())
            h.update(b"\n")
        return h.hexdigest()

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self.events:
            out[ev.kind] = out.get(ev.kind, 0) + 1
        return out


def generate_plan(
    seed: int,
    requests: int = 200,
    duration_s: float = 10.0,
    nodes: int = 16,
    chips_per_node: int = 4,
    models: Tuple[str, ...] = ("tpu-v4",),
    min_size: int = 1,
    max_size: int = 8,
    cancel_frac: float = 0.15,
    resize_frac: float = 0.15,
    migrate_frac: float = 0.05,
) -> ChurnPlan:
    """Deterministic open-loop plan: ``requests`` arrivals uniform over
    ``duration_s``; ``cancel_frac`` of them get a later cancel,
    ``resize_frac`` a later size change, and ``migrate_frac`` (of the
    request count) node-drain events land on random nodes. Pure function
    of its arguments — no wall clock, no global RNG."""
    rng = _random.Random(seed)
    events: List[ChurnEvent] = []
    for i in range(requests):
        at = rng.uniform(0.0, duration_s)
        name = f"churn-{seed}-{i:06d}"
        model = models[rng.randrange(len(models))]
        size = rng.randint(min_size, max_size)
        events.append(ChurnEvent(at, ARRIVE, name, model, size))
        follow = rng.random()
        if follow < cancel_frac:
            # Cancel some time later — sometimes before the system could
            # plausibly have placed it (the racy cancel is the point).
            events.append(
                ChurnEvent(
                    min(at + rng.uniform(0.05, duration_s / 2), duration_s),
                    CANCEL, name,
                )
            )
        elif follow < cancel_frac + resize_frac:
            new_size = rng.randint(min_size, max_size)
            if new_size != size:
                events.append(
                    ChurnEvent(
                        min(at + rng.uniform(0.1, duration_s / 2), duration_s),
                        RESIZE, name, model, new_size,
                    )
                )
    for j in range(int(requests * migrate_frac)):
        node = f"node-{rng.randrange(nodes):04d}"
        events.append(
            ChurnEvent(rng.uniform(0.2, duration_s), MIGRATE, f"{node}", "", 0)
        )
    # Total order with a deterministic tie-break; a cancel/resize riding the
    # same instant as its arrive sorts after it (ARRIVE < others
    # alphabetically happens to hold, but be explicit).
    kind_rank = {ARRIVE: 0, RESIZE: 1, MIGRATE: 2, CANCEL: 3}
    events.sort(key=lambda e: (e.at_s, kind_rank[e.kind], e.name))
    return ChurnPlan(
        seed=seed,
        nodes=nodes,
        chips_per_node=chips_per_node,
        duration_s=duration_s,
        requests=requests,
        events=events,
    )


# ----------------------------------------------------------------------
# layer 2: the macro-scale placement state machine
# ----------------------------------------------------------------------
class _Inventory:
    """First-fit-decreasing-ish placement over free-chip counts, O(log n)
    per op via a lazy max-heap — 50k placements over 10k nodes must run in
    seconds, so no linear scans."""

    def __init__(self, nodes: int, chips_per_node: int) -> None:
        self.free = {f"node-{i:04d}": chips_per_node for i in range(nodes)}
        self._heap: List[Tuple[int, str]] = [
            (-c, n) for n, c in sorted(self.free.items())
        ]
        heapq.heapify(self._heap)

    def _push(self, node: str) -> None:
        heapq.heappush(self._heap, (-self.free[node], node))

    def take(self, size: int) -> Optional[str]:
        """Grab ``size`` chips from the fullest-free node (best-fit-enough
        and deterministic). Returns the node or None if nothing fits."""
        while self._heap:
            negc, node = self._heap[0]
            if -negc != self.free[node]:
                heapq.heappop(self._heap)  # stale lazy entry
                continue
            if -negc >= size:
                heapq.heappop(self._heap)
                self.free[node] -= size
                self._push(node)
                return node
            return None  # fullest-free can't fit ⇒ nothing can
        return None

    def give(self, node: str, size: int) -> None:
        self.free[node] += size
        self._push(node)


def simulate(plan: ChurnPlan) -> Dict[str, Any]:
    """Run the plan through an in-memory placement machine at full macro
    scale. Sim time == event time; a queued arrival's wait ends when a
    capacity-freeing event lets it place. Deterministic."""
    import collections

    inv = _Inventory(plan.nodes, plan.chips_per_node)
    placed: Dict[str, Tuple[str, int, float]] = {}  # name -> (node, size, t)
    # FIFO with tombstones: a cancel marks the name dead in O(1) and the
    # drain skips corpses — 20k-deep queues under 50k-CR churn make a
    # list-rebuild-per-cancel quadratic.
    queued: "collections.deque[Tuple[float, str, str, int]]" = collections.deque()
    queued_names: Dict[str, int] = {}  # name -> requested size (live entries)
    cancelled_before_place = 0
    waits: List[float] = []
    served_chip_s = 0.0
    requested_chip_s = 0.0
    migrated = 0
    resize_ok = 0
    resize_blocked = 0
    end_t = plan.duration_s

    def drain_queue(now: float) -> None:
        # FIFO head-of-line semantics: stop at the first non-fit so big
        # requests can't be starved by later small ones (matches the
        # scheduler's queue discipline closely enough for a capacity model).
        while queued:
            t0, name, model, size = queued[0]
            if name not in queued_names:  # cancelled while waiting
                queued.popleft()
                continue
            node = inv.take(size)
            if node is None:
                return
            queued.popleft()
            queued_names.pop(name, None)
            placed[name] = (node, size, now)
            waits.append(now - t0)

    for ev in plan.events:
        now = ev.at_s
        if ev.kind == ARRIVE:
            requested_chip_s += ev.size * max(0.0, end_t - now)
            node = inv.take(ev.size)
            if node is None:
                queued.append((now, ev.name, ev.model, ev.size))
                queued_names[ev.name] = ev.size
            else:
                placed[ev.name] = (node, ev.size, now)
                waits.append(0.0)
        elif ev.kind == CANCEL:
            if ev.name in placed:
                node, size, t_place = placed.pop(ev.name)
                served_chip_s += size * max(0.0, now - t_place)
                requested_chip_s -= size * max(0.0, end_t - now)
                inv.give(node, size)
                drain_queue(now)
            elif ev.name in queued_names:
                qsize = queued_names.pop(ev.name)
                cancelled_before_place += 1
                requested_chip_s -= qsize * max(0.0, end_t - now)
        elif ev.kind == RESIZE:
            if ev.name in placed:
                node, size, t_place = placed[ev.name]
                delta = ev.size - size
                if delta <= 0:
                    inv.give(node, -delta)
                    served_chip_s += size * max(0.0, now - t_place)
                    placed[ev.name] = (node, ev.size, now)
                    resize_ok += 1
                    drain_queue(now)
                elif inv.free[node] >= delta:
                    inv.free[node] -= delta
                    inv._push(node)
                    served_chip_s += size * max(0.0, now - t_place)
                    placed[ev.name] = (node, ev.size, now)
                    resize_ok += 1
                else:
                    resize_blocked += 1
        elif ev.kind == MIGRATE:
            # Drain the node: every placement on it moves elsewhere (or
            # queues if the fleet is full).
            victims = [
                (name, rec) for name, rec in placed.items() if rec[0] == ev.name
            ]
            victims.sort()
            for name, (node, size, t_place) in victims:
                served_chip_s += size * max(0.0, now - t_place)
                inv.give(node, size)
                dest = inv.take(size)
                if dest is None:
                    del placed[name]
                    queued.append((now, name, "", size))
                    queued_names[name] = size
                else:
                    placed[name] = (dest, size, now)
                    migrated += 1
            drain_queue(now)
    # Close the books at end of plan.
    for name, (node, size, t_place) in placed.items():
        served_chip_s += size * max(0.0, end_t - t_place)
    waits.sort()

    def pct(p: float) -> float:
        if not waits:
            return 0.0
        return waits[min(len(waits) - 1, int(p * (len(waits) - 1)))]

    return {
        "digest": plan.trace_digest(),
        "arrivals": sum(1 for e in plan.events if e.kind == ARRIVE),
        "placed_total": len(waits),
        "still_running": len(placed),
        "still_queued": len(queued),
        "cancelled_before_place": cancelled_before_place,
        "migrated_members": migrated,
        "resize_ok": resize_ok,
        "resize_blocked": resize_blocked,
        "queue_wait_p50_s": round(pct(0.50), 6),
        "queue_wait_p99_s": round(pct(0.99), 6),
        "goodput_ratio": (
            round(served_chip_s / requested_chip_s, 6)
            if requested_chip_s > 0 else None
        ),
    }


# ----------------------------------------------------------------------
# layer 3: the live wire replay (ChurnDriver)
# ----------------------------------------------------------------------
class ChurnDriver:
    """Replays a plan against a live apiserver with real HTTP verbs, paced
    by wall clock (``time_scale`` stretches the plan's timeline). Arrival
    wall times land in ``arrive_wall`` so the harness can compute real
    queue waits from observed Running transitions."""

    def __init__(
        self,
        base_url: str,
        plan: ChurnPlan,
        group: str,
        version: str,
        time_scale: float = 1.0,
        migrate_dwell_s: float = 1.0,
        wire_mux: Optional[bool] = None,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.plan = plan
        self.cr_prefix = f"/apis/{group}/{version}/composabilityrequests"
        self.nm_prefix = f"/apis/{group}/{version}/nodemaintenances"
        self.group_version = f"{group}/{version}"
        self.time_scale = time_scale
        self.migrate_dwell_s = migrate_dwell_s
        self.arrive_wall: Dict[str, float] = {}
        self.errors: List[str] = []
        self.sent: Dict[str, int] = {}
        self._stop = threading.Event()
        self._mx_seq = 0
        # Framed transport for ChurnDriver's own verbs (same kill switch as
        # KubeStore). The per-request urllib cost — connect + header parse
        # per verb, in the replaying process — is replay overhead distorting
        # the scaling curve; one framed socket
        # removes it. Timer-thread migrate deletes share it safely
        # (MuxClient pipelines across threads).
        if wire_mux is None:
            wire_mux = _os.environ.get("TPUC_WIRE_MUX", "1") != "0"
        self._mux: Optional[wiremux.MuxClient] = None
        self._mux_failed = not wire_mux

    # -- tiny wire client (stdlib only; the replay must not depend on
    #    KubeStore so its cost never shadows what we're measuring) -----
    def _req(self, method: str, path: str,
             body: Optional[Dict[str, Any]] = None) -> Tuple[int, Dict[str, Any]]:
        if not self._mux_failed:
            try:
                if self._mux is None:
                    self._mux = wiremux.MuxClient(self.base_url)
                return self._mux.request(method, path, body=body, timeout=10.0)
            except wiremux.MuxHTTPError as e:
                return e.code, e.body
            except wiremux.MuxUnsupported:
                self._mux_failed = True  # plain-HTTP server: fall through
            except wiremux.MuxError as e:
                return 599, {"message": str(e)}
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                return resp.status, json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read() or b"{}")
            except ValueError:
                payload = {}
            return e.code, payload

    def _arrive(self, ev: ChurnEvent) -> None:
        code, _ = self._req("POST", self.cr_prefix, {
            "apiVersion": self.group_version,
            "kind": "ComposabilityRequest",
            "metadata": {"name": ev.name},
            "spec": {"resource": {
                "type": "gpu" if is_gpu_model(ev.model) else "tpu",
                "model": ev.model, "size": ev.size}},
        })
        if code == 201:
            self.arrive_wall[ev.name] = time.monotonic()
        else:
            self.errors.append(f"arrive {ev.name}: HTTP {code}")

    def _cancel(self, ev: ChurnEvent) -> None:
        code, _ = self._req("DELETE", f"{self.cr_prefix}/{ev.name}")
        if code not in (200, 404):
            self.errors.append(f"cancel {ev.name}: HTTP {code}")

    def _resize(self, ev: ChurnEvent) -> None:
        # Read-modify-write with CAS retry: exactly what kubectl edit does.
        for _ in range(8):
            code, obj = self._req("GET", f"{self.cr_prefix}/{ev.name}")
            if code != 200:
                return  # already cancelled/purged: benign churn
            obj.setdefault("spec", {}).setdefault("resource", {})["size"] = ev.size
            code, _ = self._req(
                "PUT", f"{self.cr_prefix}/{ev.name}", obj)
            if code == 200:
                return
            if code != 409:
                self.errors.append(f"resize {ev.name}: HTTP {code}")
                return
        self.errors.append(f"resize {ev.name}: conflict-retry budget spent")

    def _migrate(self, ev: ChurnEvent) -> None:
        self._mx_seq += 1
        name = f"churn-mx-{self.plan.seed}-{self._mx_seq:04d}"
        code, _ = self._req("POST", self.nm_prefix, {
            "apiVersion": self.group_version,
            "kind": "NodeMaintenance",
            "metadata": {"name": name},
            "spec": {"node_name": ev.name, "reason": "churn drain"},
        })
        if code != 201:
            self.errors.append(f"migrate {ev.name}: HTTP {code}")
            return

        def _lift() -> None:
            self._req("DELETE", f"{self.nm_prefix}/{name}")

        t = threading.Timer(self.migrate_dwell_s, _lift)
        t.daemon = True
        t.start()

    def run(self) -> Dict[str, int]:
        """Replay to completion (or ``stop()``). Open loop: pacing follows
        the plan clock only — a backed-up control plane builds real queues."""
        t0 = time.monotonic()
        handlers: Dict[str, Callable[[ChurnEvent], None]] = {
            ARRIVE: self._arrive, CANCEL: self._cancel,
            RESIZE: self._resize, MIGRATE: self._migrate,
        }
        for ev in self.plan.events:
            due = t0 + ev.at_s * self.time_scale
            while not self._stop.is_set():
                delay = due - time.monotonic()
                if delay <= 0:
                    break
                self._stop.wait(min(delay, 0.1))
            if self._stop.is_set():
                break
            handlers[ev.kind](ev)
            self.sent[ev.kind] = self.sent.get(ev.kind, 0) + 1
        # Leave the mux socket open until the dwell timers (migrate lifts)
        # have had their say; close() below is the explicit teardown.
        return dict(self.sent)

    def stop(self) -> None:
        self._stop.set()

    def close(self) -> None:
        mux, self._mux = self._mux, None
        self._mux_failed = True
        if mux is not None:
            mux.close()
