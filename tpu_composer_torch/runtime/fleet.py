"""Fleet observatory: cross-replica telemetry aggregation and fleet SLOs
(port of ``tpu_composer/runtime/fleet.py``).

A sharded control plane has N replicas, each with its own observatory:
N disconnected /metrics endpoints and N SLO engines each seeing 1/N of
the traffic. This module answers "is the FLEET meeting its attach p99":

- **Publisher.** Every replica periodically serializes a
  :class:`ReplicaTelemetry` snapshot — identity, owned shards, the FULL
  bucket state of the SLO-relevant histograms (``Histogram.state``), local
  SLO burn rates, per-subsystem GIL ratios, profiler top-N — into one
  ``FleetTelemetry`` object in the shared Store: the same store the shard
  leases already ride, so the fleet view works identically for in-proc
  bench replicas and real OS processes (and against a kube-apiserver,
  ``runtime/kubestore.py``). A store without the kind (pre-CRD cluster) makes
  the publisher dormant for the process lifetime, like UnsupportedEvents.
- **Aggregator.** Every replica also merges everyone's snapshots:
  identical-bucket histograms sum (``Histogram.merge`` — mismatched bucket
  schemas exclude the offender loudly, never mis-sum), and the
  burn-rate engine (``runtime/slo.py``) re-evaluates the attach/queue objectives over the
  MERGED series, so ``/debug/fleet`` and the ``tpuc_fleet_*`` gauges read
  the same from whichever replica you ask.
- **Process-token dedup.** In-proc replicas share one metrics registry;
  each snapshot carries a per-process token and the merge counts each
  process's histograms ONCE (freshest seq wins), while per-replica fields
  (identity, owned shards) stay distinct — so the bench harness and real
  scale-out use one code path without double-counting.
- **Staleness by observation clock.** A snapshot whose ``seq`` has sat
  unchanged for a full staleness window on OUR monotonic clock marks its
  replica dead — the leases' RenewObservation discipline, reused verbatim:
  wall jumps on either side can neither hasten nor mask the ageing. Dead
  replicas leave every aggregate and their per-replica label sets are
  level-set away each tick (``Counter.remove``), so a kill -9'd replica
  cannot pin the fleet p99 forever; long-dead snapshots are GC'd from the
  store like dead member heartbeats.

A caller that wants no fleet plane constructs none of this (the JAX
command line's ``TPUC_FLEET=0``). The trace half of the fleet story —
replica-tagged pids — lives in runtime/tracing.py.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from tpu_composer_torch.api.fleet import FleetTelemetry, FleetTelemetrySpec
from tpu_composer_torch.api.meta import ObjectMeta, now_iso
from tpu_composer_torch.runtime.leases import (
    RenewObservation,
    sanitize_identity as _sanitize,
)
from tpu_composer_torch.runtime.metrics import (
    Histogram,
    fleet_attach_p99_seconds,
    fleet_goodput_ratio,
    fleet_publishes_total,
    fleet_queue_wait_p99_seconds,
    fleet_replica_shards,
    fleet_replicas,
    fleet_stale_replicas,
    gil_wait_ratio,
)
from tpu_composer_torch.runtime.slo import Objective, SloEngine
from tpu_composer_torch.runtime.store import (
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
    StoreError,
)

log = logging.getLogger("fleet")

#: The most recently started plane (crash-hook dump target), like the
#: profiler and SLO engine.
_active: Optional["FleetPlane"] = None

#: One token per OS process + boot: the aggregator's dedup key for
#: co-located replicas sharing a metrics registry. uuid component so a
#: recycled OS pid on another host can never alias.
PROCESS_TOKEN = f"{os.getpid()}-{uuid.uuid4().hex[:8]}"


def _default_histograms() -> Dict[str, Histogram]:
    """The SLO-relevant series a replica publishes — the set the local
    objectives read, merged fleet-wide."""
    from tpu_composer_torch.runtime import metrics

    return {
        "tpuc_attach_to_ready_seconds": metrics.attach_to_ready_seconds,
        "tpuc_fabric_completion_latency_seconds":
            metrics.fabric_completion_latency,
        "tpuc_queue_wait_seconds": metrics.queue_wait_seconds,
        "tpuc_repair_time_to_replace_seconds":
            metrics.repair_time_to_replace_seconds,
    }


@dataclass
class ReplicaTelemetry:
    """One replica's published snapshot (the FleetTelemetry payload)."""

    identity: str
    seq: int = 0
    process_token: str = ""
    owned_shards: List[int] = field(default_factory=list)
    #: metric name -> Histogram.state() (full cumulative bucket state)
    histograms: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    #: local SLO engine state: objective -> {fast_burn, slow_burn, breached}
    slo: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    #: subsystem -> GIL-wait ratio (the scale-out ceiling signal, fleet-wide)
    gil: Dict[str, float] = field(default_factory=dict)
    #: profiler top-N frames (self/cumulative sample counts)
    profiler_top: List[Dict[str, Any]] = field(default_factory=list)
    #: goodput counters {"total_s", "lost_s"} (cumulative, process-scoped
    #: like the histograms — deduped per process token in the merge)
    goodput: Dict[str, float] = field(default_factory=dict)
    published_at: str = ""

    def to_payload(self) -> Dict[str, Any]:
        return {
            "ownedShards": list(self.owned_shards),
            "histograms": self.histograms,
            "slo": self.slo,
            "gil": self.gil,
            "profilerTop": self.profiler_top,
            "goodput": self.goodput,
            "publishedAt": self.published_at,
        }

    @classmethod
    def from_object(cls, obj: FleetTelemetry) -> "ReplicaTelemetry":
        p = obj.spec.payload or {}
        return cls(
            identity=obj.spec.identity,
            seq=obj.spec.seq,
            process_token=obj.spec.process_token,
            owned_shards=[int(s) for s in p.get("ownedShards", [])],
            histograms=dict(p.get("histograms") or {}),
            slo=dict(p.get("slo") or {}),
            gil={k: float(v) for k, v in (p.get("gil") or {}).items()},
            profiler_top=list(p.get("profilerTop") or []),
            goodput={
                k: float(v) for k, v in (p.get("goodput") or {}).items()
            },
            published_at=p.get("publishedAt", "") or "",
        )


class MergedSeries:
    """A fleet-merged histogram behind the Objective duck-type: the
    aggregator swaps in a freshly merged Histogram each tick, and the SLO
    engine keeps diffing cumulative counts off it exactly as it does off a
    live local histogram (merged counts stay monotonic while the
    contributor set is stable; a dead replica ageing out can step them
    down once, which the engine clamps to zero burn, never negative)."""

    def __init__(self, name: str, buckets) -> None:
        self.name = name
        self._hist = Histogram(name, buckets=buckets)

    def replace(self, hist: Histogram) -> None:
        self._hist = hist

    @property
    def buckets(self):
        return self._hist.buckets

    def total_count(self) -> int:
        return self._hist.total_count()

    def total_count_le(self, value: float) -> float:
        return self._hist.total_count_le(value)

    def percentile(self, q: float) -> Optional[float]:
        # Across ALL label sets: the fleet p99 spans every replica's
        # type/verb/queue label, not one arbitrary series.
        return self._hist.percentile_all(q)


class FleetPlane:
    """Publisher + aggregator, one instance per replica (a Manager
    runnable). Tests drive :meth:`tick`/:meth:`aggregate` with injected
    monotonic ``now`` for determinism instead of starting the thread."""

    def __init__(
        self,
        store,
        identity: str,
        num_shards: int = 1,
        ownership=None,
        publish_period: float = 2.0,
        stale_after_s: float = 0.0,
        attach_p99_s: float = 5.0,
        queue_p99_s: float = 1.0,
        fast_window: float = 60.0,
        slow_window: float = 600.0,
        burn_threshold: float = 2.0,
        histograms: Optional[Dict[str, Histogram]] = None,
        slo_engine=None,
        profiler=None,
        recorder=None,
        process_token: str = "",
        goodput=None,  # runtime.goodput.GoodputTracker (None = not published)
    ) -> None:
        self.store = store
        self.identity = identity
        self.num_shards = max(1, num_shards)
        self.ownership = ownership
        self.publish_period = max(0.05, publish_period)
        # Default staleness: several publish periods — long enough that a
        # GC pause is not a death sentence, short enough that a dead
        # replica leaves the fleet p99 within seconds. NB the observation
        # clock floors expiry at 1s (RenewObservation.expired).
        self.stale_after_s = (
            stale_after_s if stale_after_s > 0 else 5 * self.publish_period
        )
        self.process_token = process_token or PROCESS_TOKEN
        self.histograms = (
            histograms if histograms is not None else _default_histograms()
        )
        self._local_slo = slo_engine  # None -> slo.active() at publish time
        self._profiler = profiler  # None -> profiler.active() at publish time
        self._goodput = goodput
        self._seq = 0
        self._dormant = False  # store has no FleetTelemetry kind
        self._lock = threading.Lock()
        # identity -> RenewObservation over (identity, str(seq)) — THE
        # staleness discipline, shared with the lease electors.
        self._obs: Dict[str, RenewObservation] = {}
        self._last_local: Optional[ReplicaTelemetry] = None
        self._last_view: Dict[str, Any] = {}
        self._exported_replicas: set = set()
        # Fleet objectives over the merged series: same thresholds/windows
        # as the local engine, evaluated over everyone's traffic. A
        # threshold <= 0 drops the objective, as in default_objectives.
        self._series: Dict[str, MergedSeries] = {}
        objectives: List[Objective] = []
        if attach_p99_s > 0:
            s = self._merged_series("tpuc_attach_to_ready_seconds")
            objectives.append(Objective(
                "fleet_attach_p99", s, attach_p99_s, 0.99,
                "fleet-merged attach-to-ready latency",
            ))
        if queue_p99_s > 0:
            s = self._merged_series("tpuc_queue_wait_seconds")
            objectives.append(Objective(
                "fleet_queue_wait_p99", s, queue_p99_s, 0.99,
                "fleet-merged work-queue wait",
            ))
        self.slo = SloEngine(
            objectives=objectives,
            recorder=recorder,
            fast_window=fast_window,
            slow_window=slow_window,
            burn_threshold=burn_threshold,
            eval_period=self.publish_period,
        )

    def _merged_series(self, name: str) -> MergedSeries:
        if name not in self._series:
            src = self.histograms.get(name)
            buckets = src.buckets if src is not None else Histogram(name).buckets
            self._series[name] = MergedSeries(f"{name}:fleet", buckets)
        return self._series[name]

    # ------------------------------------------------------------------
    # publish side
    # ------------------------------------------------------------------
    def _object_name(self) -> str:
        return f"telemetry.{_sanitize(self.identity)}"

    def build_local(self) -> ReplicaTelemetry:
        """Serialize this replica's telemetry (cheap: state() snapshots
        under each metric's lock, no store traffic)."""
        from tpu_composer_torch.runtime import profiler as profiler_mod
        from tpu_composer_torch.runtime import slo as slo_mod

        self._seq += 1
        snap = ReplicaTelemetry(
            identity=self.identity,
            seq=self._seq,
            process_token=self.process_token,
            owned_shards=sorted(self.ownership.owned())
            if self.ownership is not None else [],
            histograms={
                name: hist.state() for name, hist in self.histograms.items()
            },
            published_at=now_iso(),
        )
        engine = self._local_slo or slo_mod.active()
        if engine is not None:
            try:
                objs = engine.snapshot().get("objectives", {})
                snap.slo = {
                    name: {
                        "fast_burn": st.get("fast_burn", 0.0),
                        "slow_burn": st.get("slow_burn", 0.0),
                        "breached": st.get("breached", False),
                    }
                    for name, st in objs.items()
                }
            except Exception:  # pragma: no cover - defensive
                pass
        snap.gil = {
            dict(labels).get("subsystem", ""): value
            for labels, value in gil_wait_ratio.state()
        }
        prof = self._profiler or profiler_mod.active()
        if prof is not None:
            try:
                snap.profiler_top = prof.top(5)
            except Exception:  # pragma: no cover - defensive
                pass
        if self._goodput is not None:
            try:
                total, lost = self._goodput.counts()
                snap.goodput = {
                    "total_s": round(total, 6), "lost_s": round(lost, 6),
                }
            except Exception:  # pragma: no cover - defensive
                pass
        self._last_local = snap
        return snap

    def publish(self) -> bool:
        """Write this replica's snapshot into the shared store. Returns
        False when dormant or the write failed (retried next tick). The
        LOCAL snapshot refreshes even when dormant — /debug/fleet's
        self-only degraded view must track live telemetry, not freeze at
        whatever the first tick saw."""
        snap = self.build_local()
        if self._dormant:
            return False
        name = self._object_name()
        try:
            obj = self.store.try_get(FleetTelemetry, name)
            if obj is None:
                self.store.create(FleetTelemetry(
                    metadata=ObjectMeta(name=name),
                    spec=FleetTelemetrySpec(
                        identity=self.identity,
                        seq=snap.seq,
                        process_token=self.process_token,
                        payload=snap.to_payload(),
                    ),
                ))
            else:
                obj.spec.identity = self.identity
                obj.spec.seq = snap.seq
                obj.spec.process_token = self.process_token
                obj.spec.payload = snap.to_payload()
                self.store.update(obj)
            fleet_publishes_total.inc(outcome="ok")
            return True
        except (AlreadyExistsError, ConflictError):
            # Racing our own previous incarnation after a restart with the
            # same identity — next tick reads fresh and wins.
            fleet_publishes_total.inc(outcome="error")
            return False
        except StoreError as e:
            fleet_publishes_total.inc(outcome="error")
            log.warning("fleet publish failed: %s", e)
            return False
        except KeyError as e:
            # Kind not routable on this store (a cluster without the
            # FleetTelemetry CRD): dormant for the process lifetime, the
            # UnsupportedEvents pattern — one warning, zero per-tick noise.
            self._dormant = True
            log.warning(
                "fleet publishing dormant: store cannot carry"
                " FleetTelemetry (%s) — install deploy/crds", e,
            )
            return False

    # ------------------------------------------------------------------
    # aggregate side
    # ------------------------------------------------------------------
    def aggregate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Merge every replica's latest snapshot, re-evaluate the fleet
        objectives over the merged series, level-set the fleet gauges.
        ``now`` is injectable (monotonic seconds) for deterministic tests."""
        now = time.monotonic() if now is None else now
        if self._dormant:
            # Store cannot carry the kind (publish() warned once): no
            # listing, no per-tick noise — the view degrades to self-only.
            objs = []
        else:
            try:
                objs = self.store.list(FleetTelemetry)
            except KeyError as e:
                self._dormant = True
                log.warning(
                    "fleet aggregation dormant: store cannot carry"
                    " FleetTelemetry (%s) — install deploy/crds", e,
                )
                objs = []
            except StoreError as e:
                # Transient store failure: keep the LAST view and — more
                # importantly — keep every staleness observation. Pruning
                # on a blip would reset the observation clocks and
                # resurrect dead replicas as live for a full window.
                log.warning("fleet listing failed: %s", e)
                with self._lock:
                    if self._last_view:
                        return dict(self._last_view)
                objs = []
        snaps: Dict[str, ReplicaTelemetry] = {}
        for obj in objs:
            try:
                t = ReplicaTelemetry.from_object(obj)
            except (TypeError, ValueError) as e:
                log.warning(
                    "malformed fleet snapshot %s: %s", obj.metadata.name, e
                )
                continue
            if t.identity:
                snaps[t.identity] = t
        # A replica whose publishes are failing (store outage) must still
        # see ITSELF in its own fleet view — /debug/fleet degrading to
        # "no replicas" during a blip would read as a dead fleet.
        if self.identity not in snaps and self._last_local is not None:
            snaps[self.identity] = self._last_local

        with self._lock:
            for ident, t in snaps.items():
                self._obs[ident] = RenewObservation.advance(
                    self._obs.get(ident), ident, str(t.seq), now
                )
            for gone in [i for i in self._obs if i not in snaps]:
                del self._obs[gone]
            live: Dict[str, ReplicaTelemetry] = {}
            stale: Dict[str, ReplicaTelemetry] = {}
            # Snapshot the per-replica ageing while the lock is held: a
            # concurrent aggregate (an HTTP snapshot() racing the first
            # runnable tick) may delete _obs entries under the lock, and
            # the view construction below runs outside it.
            seq_unchanged: Dict[str, float] = {}
            for ident, t in snaps.items():
                obs = self._obs[ident]
                seq_unchanged[ident] = round(now - obs.first_mono, 3)
                if ident != self.identity and obs.expired(
                    self.stale_after_s, now
                ):
                    stale[ident] = t
                else:
                    live[ident] = t

        self._gc_dead(stale, now)

        # Merge histograms once per PROCESS among live replicas: in-proc
        # replicas share a registry, so per-replica snapshots of the same
        # process are views of the same counters — summing them would
        # multiply the fleet's traffic by the co-location factor.
        by_process: Dict[str, ReplicaTelemetry] = {}
        for t in live.values():
            key = t.process_token or t.identity
            cur = by_process.get(key)
            if cur is None or t.seq > cur.seq:
                by_process[key] = t
        merged_stats: Dict[str, Dict[str, Any]] = {}
        for name in list(self._series):
            series = self._series[name]
            merged = Histogram(f"{name}:fleet", buckets=series.buckets)
            for t in by_process.values():
                state = t.histograms.get(name)
                if state is None:
                    continue
                try:
                    merged.merge(state)
                except ValueError as e:
                    # The schema guard: a contributor running different
                    # bucket bounds (skewed version during a rolling
                    # deploy) is EXCLUDED loudly — never mis-summed.
                    log.warning(
                        "fleet merge: excluding %s's %s: %s",
                        t.identity, name, e,
                    )
            series.replace(merged)
            merged_stats[name] = {
                "count": merged.total_count(),
                "p50_s": merged.percentile_all(0.50),
                "p99_s": merged.percentile_all(0.99),
            }
        # Goodput merges like the histograms: once per process (the
        # tracker's counters are process-scoped), summed across the fleet.
        gp_total = sum(
            t.goodput.get("total_s", 0.0) for t in by_process.values()
            if t.goodput
        )
        gp_lost = sum(
            t.goodput.get("lost_s", 0.0) for t in by_process.values()
            if t.goodput
        )
        if gp_total > 0:
            fleet_goodput_ratio.set(
                round((gp_total - gp_lost) / gp_total, 6)
            )
            merged_stats["goodput"] = {
                "total_s": round(gp_total, 3),
                "lost_s": round(gp_lost, 3),
                "ratio": round((gp_total - gp_lost) / gp_total, 6),
            }
        else:
            # Level-set like the other fleet gauges: no replica publishes
            # goodput -> the series leaves /metrics rather than freezing
            # at its last value.
            fleet_goodput_ratio.remove()
        self.slo.evaluate(now)

        # Level-set the fleet gauges; dead replicas' label sets removed
        # (Counter.remove) so a kill -9'd identity does not linger in
        # /metrics as a frozen last value.
        fleet_replicas.set(float(len(live)))
        fleet_stale_replicas.set(float(len(stale)))
        for ident, t in live.items():
            fleet_replica_shards.set(
                float(len(t.owned_shards)), replica=ident
            )
        with self._lock:
            for ident in self._exported_replicas - set(live):
                fleet_replica_shards.remove(replica=ident)
            self._exported_replicas = set(live)
        attach = merged_stats.get("tpuc_attach_to_ready_seconds", {})
        fleet_attach_p99_seconds.set(float(attach.get("p99_s") or 0.0))
        queue = merged_stats.get("tpuc_queue_wait_seconds", {})
        fleet_queue_wait_p99_seconds.set(float(queue.get("p99_s") or 0.0))

        view = {
            "identity": self.identity,
            "publish_period_s": self.publish_period,
            "stale_after_s": self.stale_after_s,
            "replicas": {
                ident: {
                    "seq": t.seq,
                    "process_token": t.process_token,
                    "owned_shards": t.owned_shards,
                    "stale": ident in stale,
                    "seq_unchanged_s": seq_unchanged.get(ident),
                    "published_at": t.published_at,
                    "slo": t.slo,
                    "gil": t.gil,
                    "profiler_top": t.profiler_top,
                    "goodput": t.goodput,
                }
                for ident, t in sorted({**live, **stale}.items())
            },
            "merged": merged_stats,
            "slo": self.slo.snapshot(),
        }
        with self._lock:
            self._last_view = view
        return view

    def _gc_dead(self, stale: Dict[str, ReplicaTelemetry], now: float) -> None:
        """Retire snapshots of long-dead replicas (10x the staleness
        window past their last observed change): without this, replica
        churn grows the listing that gates every aggregation tick forever
        — the member-lease GC, replayed for telemetry. Deleting a merely-
        partitioned replica's snapshot is safe: it republishes on its
        first healed tick."""
        for ident, t in stale.items():
            obs = self._obs.get(ident)
            if obs is None or now - obs.first_mono <= 10 * self.stale_after_s:
                continue
            try:
                self.store.delete(
                    FleetTelemetry, f"telemetry.{_sanitize(ident)}"
                )
                log.info("retired dead replica telemetry %s", ident)
            except (NotFoundError, ConflictError):
                pass
            except (StoreError, KeyError):
                pass  # next tick retries

    # ------------------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> None:
        self.publish()
        self.aggregate(now)

    def run(self, stop_event: threading.Event) -> None:
        """Manager runnable: publish + aggregate on a fixed cadence (first
        tick immediately, so a young replica is visible fleet-wide within
        one period of starting)."""
        global _active
        _active = self
        while True:
            try:
                self.tick()
            except Exception:  # pragma: no cover - must never die
                log.exception("fleet tick failed")
            if stop_event.wait(self.publish_period):
                return

    def snapshot(self) -> Dict[str, Any]:
        """The last aggregated fleet view (what /debug/fleet serves);
        computes one on demand if no tick has run yet."""
        with self._lock:
            view = dict(self._last_view)
        if view:
            return view
        return self.aggregate()


def active() -> Optional["FleetPlane"]:
    return _active


def dump_file(path: Optional[str] = None) -> Optional[str]:
    """Write the active plane's fleet view to ``path`` (default
    $TPUC_FLEET_FILE) — the crash/soak failure artifact alongside the
    profiler ring and SLO snapshot. Never raises."""
    path = path or os.environ.get("TPUC_FLEET_FILE")
    plane = _active
    if not path or plane is None:
        return None
    try:
        with open(path, "w") as f:
            json.dump(plane.snapshot(), f, indent=1)
    except (OSError, ValueError, TypeError):
        return None
    return path
